"""Spawning the port's ranks for the multi-process CPU tests: N processes
of `tests/torch_dp_worker.py` in one gloo group on a free localhost port,
each bounded by a timeout so a hung collective fails its test and not the
suite."""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(port: int, n: int, rank: int) -> dict:
    """The environment of one rank: the env triple, the repository on the
    path, one compute thread (ranks share the host's cores)."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", DCLIP_COORDINATOR=f"127.0.0.1:{port}",
               DCLIP_NUM_PROCESSES=str(n), DCLIP_PROCESS_ID=str(rank))
    return env


def wait_all(procs, timeout: float = 300) -> list:
    """Each process's stdout; asserts every exit code is 0."""
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {rank} rc={p.returncode}:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_ranks(tmp_path, name: str, spec: dict, n: int, timeout: float = 300) -> list:
    """Run `spec` on n ranks; returns each rank's output dict. A port that
    another process took between `free_port` and rank 0's bind
    (EADDRINUSE, with other tests spawning ranks beside this one) is
    retried on a new port, up to three times."""
    spec = dict(spec, out=str(tmp_path / name))
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(spec))
    for attempt in range(3):
        port = free_port()
        procs = [subprocess.Popen([sys.executable, WORKER, str(path)], env=rank_env(port, n, r),
                                  cwd=str(tmp_path), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(n)]
        try:
            wait_all(procs, timeout)
            break
        except AssertionError as e:
            if "EADDRINUSE" not in str(e) or attempt == 2:
                raise
    return [torch.load(f"{spec['out']}.rank{r}.pt", weights_only=False) for r in range(n)]


def save_batches(path, batches) -> str:
    """A list of dict batches as one npz (`torch_dp_worker.load_batches`)."""
    arrays = {"n_batches": np.int64(len(batches))}
    for i, b in enumerate(batches):
        arrays.update({f"{i}/{k}": v for k, v in b.items()})
    np.savez(path, **arrays)
    return str(path)


def distill_batch(cfg, b: int, p: int, seed: int, sparse: bool = False) -> dict:
    """A host-numpy batch of both trainers' fields for a CLIP config: caption
    spans of 2 to T - 1 tokens, boxes in the first half of the frame, every
    box slot valid or (`sparse`) one or two a row, indices 100 x seed + i."""
    rng = np.random.RandomState(seed)
    t, s, eos = cfg.text.max_length, cfg.vision.image_size, cfg.text.eos_token_id
    ids = rng.randint(1, eos - 2, size=(b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for r, n in enumerate(rng.randint(2, t, size=b)):
        ids[r, n - 1] = eos
        ids[r, n:] = 0
        mask[r, :n] = 1
    boxes = rng.rand(b, p, 4).astype(np.float32) * (s / 2)
    boxes[..., 2:] += boxes[..., :2] + 2
    box_mask = np.ones((b, p), np.float32)
    if sparse:
        box_mask[:] = 0.0
        box_mask[:, 0] = 1.0
        box_mask[::3, 1] = 1.0
    return {"pixel_values": rng.standard_normal((b, s, s, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "teacher_pixels": rng.rand(b, s, s, 3).astype(np.float32), "boxes": boxes,
            "box_mask": box_mask, "index": np.arange(b, dtype=np.int64) + 100 * seed}
