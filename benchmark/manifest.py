"""Finds a cell's files by name: the harness is driven by data.

`BENCHMARK.json` at the checkout's root lists the cells, configurations
and metrics. Each of them is files of its own under this folder, found by
its name:

    workloads/<cell>.json     the cell: config, traffic, chips, why, driver,
                              the steps the traced run records and the
                              limits of its comparison
    configs/<config>.json     the configuration as it is run
    traffic/<traffic>.json    the traffic mix's parameters
    drivers/<driver>.py       the code that runs a kind of cell: run(cell,
                              seed, seconds, trace, device, started)
    metrics/<metric>.py       a per-layer metric's reader: read(summary)
                              -> value or None, with UNIT, LAYER, MOVES

A new cell, configuration, traffic mix or per-layer metric is new files
and an entry in `BENCHMARK.json`; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dclip_tpu")


def forbidden_loaded(modules) -> List[str]:
    """The names among `modules` whose top-level name (before the first
    dot) is, whole, one the harness may not load."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str
    readers: Dict[str, ModuleType] = field(default_factory=dict)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"_bench_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve_cell(name: str, root: str = ROOT, bench_dir: Optional[str] = None) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files; raises when
    the cell or one of its files is missing."""
    bench_dir = bench_dir or os.path.join(root, "benchmark")
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in manifest["workloads"]}
    if check_name(name) not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    workload = _json(os.path.join(bench_dir, "workloads", name + ".json"))
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {workload[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    config = _json(os.path.join(bench_dir, "configs", check_name(entry["config"]) + ".json"))
    traffic = _json(os.path.join(bench_dir, "traffic", check_name(entry["traffic"]) + ".json"))
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    layer = [m for m in manifest["per_layer"] if _applies(m, name)]
    readers = {m["name"]: load_module(
        os.path.join(bench_dir, "metrics", check_name(m["name"]) + ".py"), m["name"])
        for m in layer}
    return Cell(name, workload, config, traffic, e2e, layer, bench_dir, readers)


def load_driver(cell: Cell) -> ModuleType:
    driver = check_name(cell.workload["driver"])
    return load_module(os.path.join(cell.bench_dir, "drivers", driver + ".py"), driver)


def shapes(config: dict) -> SimpleNamespace:
    """A configuration file's sizes under the port's attribute names, as the
    frozen FLOP counts, the generator and the reference read them."""
    t, v, tc = config["text_config"], config["vision_config"], config["teacher"]
    text = SimpleNamespace(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                           num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                           mlp_dim=t["intermediate_size"], max_length=t["max_position_embeddings"],
                           layer_norm_eps=t["layer_norm_eps"], eos_token_id=t["eos_token_id"])
    vision = SimpleNamespace(image_size=v["image_size"], patch_size=v["patch_size"],
                             hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
                             num_heads=v["num_attention_heads"], mlp_dim=v["intermediate_size"],
                             layer_norm_eps=v["layer_norm_eps"])
    teacher = SimpleNamespace(**tc)
    return SimpleNamespace(text=text, vision=vision, projection_dim=config["projection_dim"],
                           logit_init=config["logit_scale_init_value"], teacher=teacher)
