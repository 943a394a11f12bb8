#!/usr/bin/env python3
"""Runs one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`: each number compared with its limit); the
last lines of standard error are the same numbers. `--trace 0` reports the
cell's end-to-end metrics, `--trace 1` its per-layer metrics.

It exits non-zero and prints no result when torch sees no card, or fewer
than the cell asks for, and when a module whose top-level name is `jax`,
`jaxlib`, `flax` or `dclip_tpu` has been loaded by the time the result
would be printed. Caches it sets go under `.bench_cache/` in the checkout.
"""
from __future__ import annotations

import time


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux's
    /proc/self/stat), else now."""
    try:
        import os

        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# This folder is a package of the checkout, not a place to import from.
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != BENCH_DIR]


def _set_cache_dirs(root: str) -> None:
    """Fixed cache directories inside the checkout, whatever the program
    or a library it loads would take by default."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, out: dict, trace: bool, device_info: dict) -> dict:
    """The result object, `checks` last."""
    limits = cell.workload["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in out["checks"].items()}
    correct = all(v <= limits[k] for k, v in out["checks"].items())
    metrics = {}
    if trace:
        summary = out["summary"]
        for entry in cell.per_layer:
            value = None if summary is None else cell.readers[entry["name"]].read(summary)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": out["e2e"][entry["name"]], "unit": entry["unit"]}
    res = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "device": device_info}
    if trace and out["summary"] is not None:
        res["breakdown"] = {"device_ops": out["summary"]["device_ops"],
                            "idle_gaps": out["summary"]["idle_gaps"]}
    res["checks"] = checks
    return res


def main(argv=None, root: str = ROOT, require_card: bool = True) -> int:
    """Run the cell; `require_card=False` runs it on the CPU (the
    benchmark's own tests)."""
    args = parse(argv)
    _set_cache_dirs(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import manifest

    cell = manifest.resolve_cell(args.workload, root)
    import torch

    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"cell {cell.name} needs {cell.chips} card(s); torch sees {have}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    driver = manifest.load_driver(cell)
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device, STARTED)
    loaded = manifest.forbidden_loaded(list(sys.modules))
    if loaded:
        print(f"modules the benchmark may not load are loaded: {loaded}", file=sys.stderr)
        return 3
    on_card = device.type == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace and out["summary"] is not None:
        info["busy_s"] = out["summary"]["busy_s"]
        info["window_s"] = out["summary"]["window_s"]
    res = result_line(cell, out, bool(args.trace), info)
    sys.stdout.flush()
    print(f"reference_s {out['reference_s']!r}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
