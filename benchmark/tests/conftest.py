"""Shared fixtures of the benchmark's own tests: a throwaway checkout that
holds the benchmark, the program (linked) and two tiny cells, `tiny.uncached`
and `tiny.cached`, with the traffic, steps and limits of `vit-b-16.uncached`
and `vit-l-14.cached` at a size the CPU runs in seconds.

Run from the repository's root: `python -m pytest benchmark/tests -q`.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_TEXT = dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=16, eos_token_id=999)
TINY_VISION = dict(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_checkout(root: str) -> str:
    """A checkout at `root` with the tiny cells added as files and entries."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "dclip_tpu_torch"), os.path.join(root, "dclip_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(REPO, "benchmark", "configs", "vit-b-16.json")) as f:
        config = json.load(f)
    config["text_config"].update(TINY_TEXT)
    config["vision_config"].update(TINY_VISION)
    config["projection_dim"] = 16
    config["teacher"].update(embed_dim=16, max_text_tokens=16)
    bench = os.path.join(root, "benchmark")
    _dump(config, os.path.join(bench, "configs", "tiny.json"))
    for traffic, template in (("uncached", "vit-b-16.uncached"), ("cached", "vit-l-14.cached")):
        with open(os.path.join(bench, "traffic", f"{traffic}.json")) as f:
            mix = json.load(f)
        mix["batch"] = 8
        _dump(mix, os.path.join(bench, "traffic", f"tiny-{traffic}.json"))
        with open(os.path.join(bench, "workloads", f"{template}.json")) as f:
            cell = json.load(f)
        cell.update(config="tiny", traffic=f"tiny-{traffic}", trace_steps=4)
        _dump(cell, os.path.join(bench, "workloads", f"tiny.{traffic}.json"))
        manifest["workloads"].append({"name": f"tiny.{traffic}", "config": "tiny",
                                      "traffic": f"tiny-{traffic}", "chips": 1,
                                      "why": "the CPU tests' size"})
        for metric in manifest["per_layer"] + manifest["end_to_end"]:
            if "workloads" in metric and template in metric["workloads"]:
                metric["workloads"].append(f"tiny.{traffic}")
    _dump(manifest, os.path.join(root, "BENCHMARK.json"))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


def run_cell(root: str, cell: str, seed: int = 5, trace: int = 0, capsys=None) -> dict:
    """One run of a cell on the CPU; its result line."""
    from benchmark import run

    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace",
                     str(trace)], root=root, require_card=False) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
