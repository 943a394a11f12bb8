"""The distillation step over data-parallel ranks, one process a card:
`DistillTrainer.train_step_on_batch` under a process group, as the
reference's Lightning trainer runs with `devices=4` on one node.

`run` (from `run.py`) runs `cell.chips` ranks over NCCL: this process is
rank 0 on card 0, and ranks 1.. are this file run as workers, each on its
own card (`--worker`). Every rank joins through the port's
`cli.common.init_multihost` (the DCLIP_COORDINATOR / DCLIP_NUM_PROCESSES /
DCLIP_PROCESS_ID triple on a free local port); the trainer makes its mesh
over the default group (`parallel.mesh.make_mesh`) and broadcasts its
weights from rank 0. Start-up and every collective carry `TIMEOUT_S`, and
rank 0 ends the run as soon as a worker exits with an error, so a fault
fails the run instead of hanging it.

Each rank draws its own pool of `traffic["batch"]` rows a batch from the
seed (rank r's batch k from stream 10,000 r + k; rank 0's are the
one-card cell's), computes its teacher targets (no cache), and the step
takes K11 over the rows gathered from every rank and one f32 all-reduce
of the gradients. Set-up and the first `check_steps` steps are
`distill_step`'s; then one more cycle is timed on every rank and the
window's step count, whole cycles covering `seconds` at the slowest
rank's pace, is agreed by one all-reduce, so every rank runs the same
steps. Rank 0 times its window, synchronize to synchronize;
`train_images_per_s` is its images over its wall time: images a second a
card, as in the one-card cells. With `trace` rank 0 profiles
`trace_steps` steps; its summary carries each kernel family's device
time by name, as the SigLIP driver's does.

The reference follows the first cycle at the global batch (every rank's
rows, in rank order), after the workers have exited: the teacher targets
of each rank's rows, then the student steps on the gathered batch. The
numbers compared are rank 0's: the global loss parts, the first update's
gradient and the change of every leaf (the same on every rank after the
all-reduce), and the targets of rank 0's rows.

`run_ranks` is the same run with the backend and the cards chosen: the
driver's tests run it as gloo ranks on the CPU, and gloo ranks sharing one
card (`one_card`) check its numbers where NCCL, which refuses two ranks
on one card, cannot run.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time

TIMEOUT_S = 600.0  # start-up and every collective

if __name__ == "__main__":  # a worker: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import manifest, weights  # noqa: E402
from benchmark.drivers.distill_step import (  # noqa: E402
    GIB,
    _program_readings,
    _rng,
    _sync,
    compare,
    free,
)
from benchmark.drivers.siglip_distill_step import traced_window  # noqa: E402
from benchmark.frozen.synthetic import synthetic_distill_batch  # noqa: E402
from benchmark.reference.clip import Precision  # noqa: E402
from benchmark.reference.step import reference_run  # noqa: E402
from benchmark.reference.teacher import teacher_targets  # noqa: E402


def rank_pool(shapes, traffic: dict, seed: int, rank: int):
    """Rank `rank`'s host batches."""
    b = traffic["batch"]
    return [synthetic_distill_batch(shapes, shapes.teacher, b, _rng(seed, 10_000 * rank + k))
            for k in range(traffic["pool_batches"])]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _trainer(cell, shapes, groups, device):
    from dclip_tpu_torch.core.config import (CLIPConfig, CLIPTextConfig, CLIPVisionConfig,
                                             DistillConfig, TeacherConfig)
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    t, v = shapes.text, shapes.vision
    clip = CLIPConfig(
        text=CLIPTextConfig(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                            num_layers=t.num_layers, num_heads=t.num_heads, mlp_dim=t.mlp_dim,
                            max_length=t.max_length, layer_norm_eps=t.layer_norm_eps,
                            eos_token_id=t.eos_token_id),
        vision=CLIPVisionConfig(image_size=v.image_size, patch_size=v.patch_size,
                                hidden_size=v.hidden_size, num_layers=v.num_layers,
                                num_heads=v.num_heads, mlp_dim=v.mlp_dim,
                                layer_norm_eps=v.layer_norm_eps),
        projection_dim=shapes.projection_dim, logit_scale_init=shapes.logit_init)
    train = cell.config["training"]
    on_card = torch.device(device).type == "cuda"
    cfg = DistillConfig(
        train_batch_size=cell.traffic["batch"], learning_rate=train["learning_rate"],
        warmup_steps=train["warmup_steps"], gradient_clip_val=train["gradient_clip_val"],
        accumulate_grad_batches=train["accumulate_grad_batches"],
        contrastive_weight=train["contrastive_weight"], temperature=train["temperature"],
        teacher=TeacherConfig(**vars(shapes.teacher)), remat=train["remat"],
        compute_dtype=train["compute_dtype"] if on_card else "auto")
    # mesh=None: the trainer's make_mesh over the default process group.
    return DistillTrainer(cfg, groups["student"], groups["teacher_clip"],
                          groups["teacher_xattn"], clip, clip, device=device)


def _join(rank: int, world: int, port: int, device, backend: str, one_card: bool):
    """This rank into the group through the port's `init_multihost`."""
    from dclip_tpu_torch.cli.common import init_multihost

    os.environ.update(DCLIP_COORDINATOR=f"127.0.0.1:{port}", DCLIP_NUM_PROCESSES=str(world),
                      DCLIP_PROCESS_ID=str(rank))
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    if torch.device(device).type == "cuda":
        os.environ["LOCAL_RANK"] = "0" if one_card else str(rank)
    return init_multihost(torch.device(device).type, timeout=TIMEOUT_S,
                          backend=backend if torch.device(device).type == "cuda" else None)


def rank_main(cell, seed: int, seconds: float, trace: bool, rank: int, world: int, port: int,
              device, backend: str, one_card: bool, started: float):
    """One rank's run; rank 0 returns its readings, the others None."""
    import torch.distributed as dist

    device = _join(rank, world, port, device, backend, one_card)
    on_card = device.type == "cuda"
    shapes = manifest.shapes(cell.config)
    traffic, work = cell.traffic, cell.workload
    accumulate = int(cell.config["training"]["accumulate_grad_batches"])
    steps = int(work["check_steps"])
    pool = rank_pool(shapes, traffic, seed, rank)
    groups = weights.all_groups(shapes, seed, device, host=True)
    trainer = _trainer(cell, shapes, groups, device)
    del groups
    prog = _program_readings(trainer, pool, steps, shapes, seed, device,
                             cell.config["training"]["adam_b1"], accumulate)
    # One more cycle, timed on every rank: the window's steps at the
    # slowest rank's pace, agreed by all.
    _sync(device)
    t0 = time.perf_counter()
    for k in range(accumulate):
        trainer.train_step_on_batch(pool[(steps + k) % len(pool)])
    _sync(device)
    per_step = (time.perf_counter() - t0) / accumulate
    start = steps + accumulate
    if trace:
        n = int(work["trace_steps"])
    else:
        want = torch.tensor([int(np.ceil(seconds / per_step / accumulate)) * accumulate],
                            device=device)
        dist.all_reduce(want, op=dist.ReduceOp.MAX)
        n = int(want.item())
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    summary = None
    if trace and rank == 0:
        n, wall, summary = traced_window(trainer, pool, start, n, device)
    else:
        _sync(device)
        t0 = time.perf_counter()
        for k in range(n):
            trainer.train_step_on_batch(pool[(start + k) % len(pool)])
        _sync(device)
        wall = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del trainer
    free(device)
    dist.barrier()
    dist.destroy_process_group()
    if rank:
        return None
    batch = traffic["batch"]
    if summary is not None:
        lengths = [int(x) for b in pool for x in b["attention_mask"].sum(1)]
        summary.update(shapes=shapes, cached=False, batch=batch, images=n * batch,
                       caption_tokens=lengths, pool_batches=len(pool),
                       device_name=torch.cuda.get_device_name(device) if on_card else "cpu")
    return {"prog": prog, "n": n, "wall": wall, "summary": summary, "setup_s": setup_s,
            "memory_peak_bytes": max(setup_peak, window_peak), "window_peak": window_peak}


def global_reference(cell, seed: int, world: int, device, prec: Precision) -> dict:
    """The reference's first `check_steps` steps at the global batch: each
    rank's rows' teacher targets, then the student on every rank's rows."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    shapes = manifest.shapes(cell.config)
    steps = int(cell.workload["check_steps"])
    pools = [rank_pool(shapes, cell.traffic, seed, r) for r in range(world)]
    groups = weights.all_groups(shapes, seed, device)
    batches, targets = [], []
    for k in range(steps):
        parts = [pool[k % len(pool)] for pool in pools]
        batches.append({key: np.concatenate([p[key] for p in parts]) for key in parts[0]})
        rows = [teacher_targets(groups["teacher_clip"], groups["teacher_xattn"], shapes, p,
                                device, prec) for p in parts]
        targets.append((torch.cat([a for a, _ in rows]), torch.cat([b for _, b in rows])))
    del groups["teacher_clip"], groups["teacher_xattn"]
    out = reference_run(groups["student"], shapes, cell.config["training"], batches, targets,
                        device, prec)
    out["targets"] = [(a.float().cpu(), b.float().cpu()) for a, b in targets]
    return out


def _watch(workers) -> None:
    """End this process as soon as a worker has failed: rank 0 would
    otherwise wait in a collective until its timeout."""
    while True:
        for w in workers:
            code = w.poll()
            if code not in (None, 0):
                print(f"a worker rank exited with {code}; ending the run", file=sys.stderr,
                      flush=True)
                os._exit(1)
        if all(w.poll() == 0 for w in workers):
            return
        time.sleep(0.5)


def run_ranks(cell, seed: int, seconds: float, trace: bool, device, backend: str,
              started: float, one_card: bool = False) -> dict:
    """`cell.chips` ranks, this process rank 0 on `device`; the result of
    `distill_step.run`'s form."""
    device = torch.device(device)
    world = cell.chips
    if device.type == "cuda":
        from dclip_tpu_torch.kernels import _build

        _build.build()  # once, before the workers load it
    port = _free_port()
    root = os.path.dirname(cell.bench_dir)
    args = ["--root", root, "--workload", cell.name, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(int(trace)), "--world", str(world), "--port",
            str(port), "--device", device.type, "--backend", backend]
    if one_card:
        args.append("--one_card")
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                 "--rank", str(r), *args], stdout=subprocess.DEVNULL,
                                cwd=root) for r in range(1, world)]
    threading.Thread(target=_watch, args=(workers,), daemon=True).start()
    try:
        out = rank_main(cell, seed, seconds, trace, 0, world, port, device, backend, one_card,
                        started)
        for w in workers:
            if w.wait(timeout=TIMEOUT_S) != 0:
                raise RuntimeError(f"a worker rank exited with {w.returncode}")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
    batch = cell.traffic["batch"]
    e2e = {"train_images_per_s": out["n"] * batch / out["wall"],
           "peak_mem_gib": out["window_peak"] / GIB, "setup_s": out["setup_s"]}
    free(device)
    t0 = time.perf_counter()
    ref = global_reference(cell, seed, world, device, Precision("float32"))
    own = [(a[:batch], b[:batch]) for a, b in ref["targets"]]
    checks = compare(out["prog"], ref, False, None, own)
    return {"e2e": e2e, "summary": out["summary"], "checks": checks, "attempted": out["n"],
            "failed": 0, "memory_peak_bytes": out["memory_peak_bytes"],
            "reference_s": time.perf_counter() - t0}


def run(cell, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """`run.py`'s entry: NCCL, rank r on card r."""
    return run_ranks(cell, seed, seconds, trace, device, "nccl", started)


def _worker_main(argv) -> int:
    p = argparse.ArgumentParser(description="One worker rank of a data-parallel cell")
    p.add_argument("--worker", action="store_true")
    for name in ("--root", "--workload", "--device", "--backend"):
        p.add_argument(name, required=True)
    for name in ("--seed", "--trace", "--world", "--port", "--rank"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--one_card", action="store_true")
    a = p.parse_args(argv)
    if a.root not in sys.path:
        sys.path.insert(0, a.root)
    cell = manifest.resolve_cell(a.workload, a.root)
    device = "cuda" if a.device == "cuda" else "cpu"
    rank_main(cell, a.seed, a.seconds, bool(a.trace), a.rank, a.world, a.port, device,
              a.backend, a.one_card, time.time())
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
