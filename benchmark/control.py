#!/usr/bin/env python3
"""The readings that set a cell's limits: for each seed, in one process,
the program's numbers against the float32 reference (the lower readings),
and those of the control and of the planted faults (the upper readings).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

- program: the cell's set-up (its first `check_steps` steps through
  `train_step_on_batch`), compared as a run compares it;
- float8: the reference in the program's place with every matrix product's
  operands rounded to float8 e4m3, the precision below the configuration's
  bfloat16;
- half_batch: the reference in the program's place with the loss taken
  over the first half of each batch;
- altered: the float32 reference's own outputs with one row's targets
  swapped for another's (a teacher target altered where it is produced,
  or a cached target altered where it is served);
- a step that leaves the state unchanged reads 1 in `grad` and `change`
  by their definition, and needs no run.

One JSON line per seed, then one with the largest program reading and the
smallest reading of each of the others, number by number. Runs on the
card; the benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != BENCH_DIR]


def _swap_first_rows(pairs):
    out = []
    for a, b in pairs:
        a, b = a.clone(), b.clone()
        a[[0, 1]] = a[[1, 0]]
        b[[0, 1]] = b[[1, 0]]
        out.append((a, b))
    return out


def readings(cell, driver, seed: int, device) -> dict:
    import torch

    from benchmark import manifest
    from benchmark.reference.clip import Precision

    shapes = manifest.shapes(cell.config)
    steps = int(cell.workload["check_steps"])
    cached = bool(cell.traffic["teacher_cache"])
    t0 = time.perf_counter()
    trainer, pool, targets, prog, _ = driver.prepare(cell, seed, device)
    del trainer
    driver.free(device)
    seconds = {"program": time.perf_counter() - t0}

    def ref(prec, given=targets, rows=None):
        t = time.perf_counter()
        out = driver.reference(cell, shapes, pool, steps, seed, device, Precision(prec),
                               given, rows)
        driver.free(device)
        return out, time.perf_counter() - t

    f32, seconds["float32"] = ref("float32")
    f8, seconds["float8"] = ref("float8")
    half, seconds["half_batch"] = ref("float32", targets if cached else f32["targets"],
                                      cell.traffic["batch"] // 2)
    altered = dict(f32, targets=_swap_first_rows(f32["targets"]))
    if cached:
        # The reference's step read the served targets; the planted fault
        # alters what is served, and only the exact target check sees it.
        served = [targets[k % len(targets)] for k in range(steps)]
        altered["targets"] = _swap_first_rows(
            [(torch.from_numpy(t[:, 0]), torch.from_numpy(t[:, 1])) for t in served])

    def cmp(side):
        return driver.compare(side, f32, cached, targets, f32["targets"])

    return {"seed": seed, "program": cmp(prog), "float8": cmp(f8), "half_batch": cmp(half),
            "altered": cmp(altered), "seconds": seconds}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Lower and upper readings of a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import manifest

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = manifest.resolve_cell(args.workload, ROOT)
    driver = manifest.load_driver(cell)
    device = torch.device("cuda", 0)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        line = readings(cell, driver, seed, device)
        lines.append(line)
        print(json.dumps(line), flush=True)
    keys = lines[0]["program"].keys()
    summary = {"cell": cell.name, "seeds": [ln["seed"] for ln in lines],
               "program_max": {k: max(ln["program"][k] for ln in lines) for k in keys}}
    for side in ("float8", "half_batch", "altered"):
        summary[side + "_min"] = {k: min(ln[side][k] for ln in lines) for k in keys}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
