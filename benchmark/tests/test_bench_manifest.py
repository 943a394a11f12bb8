"""The benchmark's manifest against its contract: names, units, files found
by name, a cell added as files alone, the module check, the card check and
the time budget."""
from __future__ import annotations

import ast
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, _dump

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_names_units_and_keys_are_allowed():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in b["paths"])
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_every_cell_resolves_to_its_files():
    b = _bench()
    files = {c["name"]: c["file"] for c in b["configs"]}
    for entry in b["workloads"]:
        cell = manifest.resolve_cell(entry["name"], REPO)
        assert os.path.exists(os.path.join(REPO, files[entry["config"]]))
        assert cell.config == json.load(open(os.path.join(REPO, files[entry["config"]])))
        assert cell.config["reduced"] == []
        assert manifest.load_driver(cell).run
        assert {"setup_s", "peak_mem_gib", "train_images_per_s"} == \
            {m["name"] for m in cell.end_to_end}
        cycle = cell.config["training"]["accumulate_grad_batches"]
        assert cell.workload["check_steps"] % cycle == 0
        assert cell.workload["trace_steps"] % cycle == 0
        assert cell.traffic["pool_batches"] >= cell.workload["check_steps"]
        assert cell.per_layer
        for m in cell.per_layer:
            reader = cell.readers[m["name"]]
            assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"],
                                                                 m["moves"])
        assert set(cell.workload["limits"]) >= {"loss", "grad", "change"}


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"))
    b = _bench()
    with open(os.path.join(REPO, "benchmark", "workloads", "vit-l-14.cached.json")) as f:
        cell = json.load(f)
    cell.update(config="vit-b-16", why="a throwaway cell")
    _dump(cell, os.path.join(root, "benchmark", "workloads", "vit-b-16.throwaway.json"))
    with open(os.path.join(REPO, "benchmark", "traffic", "cached.json")) as f:
        mix = json.load(f)
    _dump(mix, os.path.join(root, "benchmark", "traffic", "cached.json"))
    b["workloads"].append({"name": "vit-b-16.throwaway", "config": "vit-b-16",
                           "traffic": "cached", "chips": 1, "why": "a throwaway cell"})
    _dump(b, os.path.join(root, "BENCHMARK.json"))
    with pytest.raises(KeyError):
        manifest.resolve_cell("vit-b-16.throwaway", REPO)
    found = manifest.resolve_cell("vit-b-16.throwaway", root)
    assert found.workload["why"] == "a throwaway cell"
    assert found.bench_dir == os.path.join(root, "benchmark")
    # Metrics without a `workloads` key reach every cell, the new one too.
    assert {"setup_s", "peak_mem_gib"} <= {m["name"] for m in found.end_to_end}


def test_the_module_check_compares_whole_top_level_names():
    loaded = ["dclip_tpu_torch", "dclip_tpu_torch.kernels", "jax.numpy", "dclip_tpu",
              "dclip_tpu.core", "jaxlib", "flax.linen", "jaxtyping", "numpy"]
    assert manifest.forbidden_loaded(loaded) == ["dclip_tpu", "dclip_tpu.core", "flax.linen",
                                                 "jax.numpy", "jaxlib"]
    assert manifest.forbidden_loaded(["dclip_tpu_torch.train"]) == []


def test_a_run_without_a_card_fails_and_prints_no_result(capsys):
    import torch

    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "vit-l-14.cached", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and not out.out.strip()
    assert "needs 1 card" in out.err


def test_a_run_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vit-l-14.cached",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_the_full_check_fits_the_time_budget():
    b = _bench()
    cells = 24
    total = (2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert 1 <= b["run_seconds"] <= 51 and total <= 43200


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_yardstick_imports_nothing_of_the_program_or_of_jax():
    bench = os.path.join(REPO, "benchmark")
    for path in glob.glob(os.path.join(bench, "**", "*.py"), recursive=True):
        if os.path.relpath(path, bench).startswith("tests"):
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "dclip_tpu"}, path
        text = open(path).read()
        for name in ("bench.py", "BENCH_r", "MULTICHIP_r", "chip_smoke"):
            assert name not in text, (path, name)
        rel = os.path.relpath(path, bench)
        if rel.startswith(("reference", "frozen", "metrics")) or rel in ("counts.py",
                                                                         "weights.py"):
            assert "dclip_tpu_torch" not in tops, path
