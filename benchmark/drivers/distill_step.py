"""The distillation training step: `DistillTrainer.train_step_on_batch`.

Set-up (counted in `setup_s`): the traffic's pool of host batches from the
seed (the frozen generator), the three weight groups on the device from
the seed (copied to the host once, as a run loads its weights), one
trainer, and in cached cells both levels of the trainer's teacher-target
cache (the host level and the device level in front of it) filled through
their own `put` calls with targets drawn from the seed, so that every step
takes the device level's hit path. The trainer then runs its first
`check_steps` steps (whole cycles of `accumulate_grad_batches`) on
distinct pool batches, through the window's own call; they warm every
shape the window uses and give the program's readings: each step's loss
parts and teacher targets, the first gradient AdamW applied (from its
first moment after the first update) and each trainable leaf's change
after the last of them.

The window: steps back to back on the pool's batches in turn, each paying
its own upload, no synchronize between them, from a synchronize to the
synchronize after the last step; it ends on a whole accumulation cycle
once `seconds` have passed. With `trace` the profiler records
`trace_steps` steps (whole cycles) instead, and the per-layer metrics
read that window.

After the window (and after memory is read and the trainer is freed) the
reference makes the weights again and follows the first `check_steps`
steps in float32 with TF32 off; each number compared is printed beside its
limit.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import manifest, weights
from benchmark.frozen import trace_math
from benchmark.frozen.synthetic import synthetic_distill_batch
from benchmark.reference.clip import Precision
from benchmark.reference.step import reference_run
from benchmark.reference.teacher import teacher_targets

PARTS = ("loss", "image_distill_loss", "text_distill_loss", "contrastive_loss")
GIB = float(1 << 30)


def _rng(seed: int, stream: int) -> np.random.RandomState:
    seed = int(seed)
    return np.random.RandomState([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, stream])


def make_pool(shapes, traffic: dict, seed: int) -> List[dict]:
    """The traffic's host batches, each with its corpus indices."""
    b = traffic["batch"]
    pool = []
    for k in range(traffic["pool_batches"]):
        batch = synthetic_distill_batch(shapes, shapes.teacher, b, _rng(seed, k))
        batch["index"] = np.arange(k * b, (k + 1) * b, dtype=np.int64)
        pool.append(batch)
    return pool


def make_targets(shapes, traffic: dict, seed: int) -> List[np.ndarray]:
    """Cached cells: each pool batch's [B, 2, D] (image, text) targets."""
    d = shapes.teacher.embed_dim
    return [_rng(seed, 1000 + k).randn(traffic["batch"], 2, d).astype(np.float32)
            for k in range(traffic["pool_batches"])]


def _trainer(cell: manifest.Cell, shapes, groups, device, cache):
    from dclip_tpu_torch.core.config import (CLIPConfig, CLIPTextConfig, CLIPVisionConfig,
                                             DistillConfig, TeacherConfig)
    from dclip_tpu_torch.parallel.mesh import local_mesh
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    t, v, tc = shapes.text, shapes.vision, shapes.teacher
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
    teacher = TeacherConfig(embed_dim=tc.embed_dim, num_heads=tc.num_heads,
                            max_patches=tc.max_patches, max_text_tokens=tc.max_text_tokens,
                            aggregation_temperature=tc.aggregation_temperature,
                            fusion_alpha=tc.fusion_alpha, mask_padding=tc.mask_padding)
    train = cell.config["training"]
    on_card = torch.device(device).type == "cuda"
    cfg = DistillConfig(
        train_batch_size=cell.traffic["batch"], learning_rate=train["learning_rate"],
        warmup_steps=train["warmup_steps"], gradient_clip_val=train["gradient_clip_val"],
        accumulate_grad_batches=train["accumulate_grad_batches"],
        contrastive_weight=train["contrastive_weight"], temperature=train["temperature"],
        teacher=teacher, remat=train["remat"],
        compute_dtype=train["compute_dtype"] if on_card else "auto")
    return DistillTrainer(cfg, groups["student"], groups["teacher_clip"],
                          groups["teacher_xattn"], clip, clip, device=device,
                          teacher_cache=cache, mesh=local_mesh())


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _program_readings(trainer, pool, steps: int, shapes, seed: int, device, b1: float,
                      accumulate: int):
    """The first `steps` steps through the window's own call: loss parts
    and targets per step, the norm per trainable leaf of the first
    gradient AdamW applied (the mean over the first `accumulate` steps,
    clipped) and each trainable leaf's change after the last step."""
    seen = []
    own_step = trainer._train_step

    def recording(t_img, t_txt, batch):
        metrics = own_step(t_img, t_txt, batch)
        seen.append((t_img.detach().float().cpu(), t_txt.detach().float().cpu(), metrics))
        return metrics

    names = [n for n, p in trainer.student.named_parameters() if p.requires_grad]
    trainer._train_step = recording
    try:
        grad_norms = None
        for k in range(steps):
            trainer.train_step_on_batch(pool[k % len(pool)])
            if k == accumulate - 1:
                grad_norms = torch.stack([m.float().norm() for m in trainer.optimizer.mu])
    finally:
        trainer._train_step = own_step
    p0 = weights.make(weights.clip_specs(shapes), seed, "student", device, shapes.logit_init)
    params = dict(trainer.student.named_parameters())
    with torch.no_grad():
        change = torch.stack([(params[n].detach().float() - p0[n]).norm() for n in names])
    del p0
    return {"losses": [{k: float(m[k]) for k in PARTS} for _, _, m in seen],
            "targets": [(a, b) for a, b, _ in seen],
            "grad_norms": dict(zip(names, (grad_norms / (1.0 - b1)).tolist())),
            "change_norms": dict(zip(names, change.tolist()))}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """Worst leaf: |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def _row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst row: |program - reference| / |reference| (L2 over the row)."""
    ref = ref.double().cpu()
    return float(((prog.double() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)).max())


def compare(prog: dict, ref: dict, cached: bool, targets=None, ref_targets=None) -> dict:
    """The numbers `correct` holds against the cell's limits."""
    loss = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-6)
               for p, r in zip(prog["losses"], ref["losses"]) for k in PARTS)
    names = list(ref["grad_norms"])
    grad = _leaf_gap(prog["grad_norms"], ref["grad_norms"], names)
    # Leaves whose reference gradient is nought to rounding (a key's bias
    # under softmax, a leaf the loss does not reach) move under Adam by
    # round-off alone: their change is not compared.
    g_med = statistics.median(ref["grad_norms"].values())
    moving = [n for n in names if ref["grad_norms"][n] >= 1e-3 * g_med]
    change = _leaf_gap(prog["change_norms"], ref["change_norms"], moving)
    out = {"loss": loss, "grad": grad, "change": change}
    if cached:
        given = [targets[k % len(targets)] for k in range(len(prog["targets"]))]
        out["target"] = max(float((a - torch.from_numpy(t[:, 0])).abs().max()
                                  + (b - torch.from_numpy(t[:, 1])).abs().max())
                            for (a, b), t in zip(prog["targets"], given))
    else:
        out["teacher_img"] = max(_row_gap(a, r[0]) for (a, _), r in
                                 zip(prog["targets"], ref_targets))
        out["teacher_txt"] = max(_row_gap(b, r[1]) for (_, b), r in
                                 zip(prog["targets"], ref_targets))
    return out


def reference(cell, shapes, pool, steps: int, seed: int, device, prec: Precision,
              targets=None, rows=None):
    """The reference's readings of the first `steps` steps, computed after
    the program is gone: its own teacher targets in uncached cells (else
    `targets`: the cached cells' [B, 2, D] arrays, or (image, text)
    tensors to reuse), and the student steps on them; `rows` < B is the
    fault of a half batch."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    groups = weights.all_groups(shapes, seed, device)
    batches = [pool[k % len(pool)] for k in range(steps)]
    if targets is None:
        ref_targets = [teacher_targets(groups["teacher_clip"], groups["teacher_xattn"], shapes,
                                       b, device, prec) for b in batches]
    elif isinstance(targets[0], np.ndarray):
        ref_targets = [(torch.from_numpy(t[:, 0]).to(device), torch.from_numpy(t[:, 1]).to(device))
                       for t in (targets[k % len(targets)] for k in range(steps))]
    else:
        ref_targets = [(a.to(device), b.to(device)) for a, b in targets]
    del groups["teacher_clip"], groups["teacher_xattn"]
    out = reference_run(groups["student"], shapes, cell.config["training"], batches,
                        ref_targets, device, prec, rows)
    out["targets"] = [(a.float().cpu(), b.float().cpu()) for a, b in ref_targets]
    return out


def prepare(cell: manifest.Cell, seed: int, device):
    """Set-up: the pool (and cached targets), the trainer, its first
    `check_steps` steps and their readings. Returns (trainer, pool,
    targets, readings, the index of the next pool batch)."""
    from dclip_tpu_torch.train.distill_trainer import TeacherTargetCache

    shapes = manifest.shapes(cell.config)
    traffic = cell.traffic
    steps = int(cell.workload["check_steps"])
    accumulate = int(cell.config["training"]["accumulate_grad_batches"])
    if steps % accumulate:
        raise ValueError(f"check_steps {steps} is not whole cycles of {accumulate}")
    marks = [("start", time.perf_counter())]
    pool = make_pool(shapes, traffic, seed)
    cached = bool(traffic["teacher_cache"])
    targets = make_targets(shapes, traffic, seed) if cached else None
    marks.append(("pool", time.perf_counter()))
    groups = weights.all_groups(shapes, seed, device, host=True)
    marks.append(("weights", time.perf_counter()))
    cache = TeacherTargetCache(salt=f"bench-{seed}") if cached else None
    trainer = _trainer(cell, shapes, groups, device, cache)
    del groups
    if cached:
        device_level = trainer._dev_full
        if device_level is None:
            raise RuntimeError("the trainer built no device level in front of its target cache")
        for batch, t in zip(pool, targets):
            keys = cache.keys_for(batch)
            cache.put_batch(keys, t)
            device_level.put(keys, torch.from_numpy(t).to(device))
    _sync(device)
    marks.append(("trainer", time.perf_counter()))
    prog = _program_readings(trainer, pool, steps, shapes, seed, device,
                             cell.config["training"]["adam_b1"], accumulate)
    _sync(device)
    marks.append(("first_steps", time.perf_counter()))
    print("setup " + " ".join(f"{b[0]}_s {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)
    return trainer, pool, targets, prog, steps


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _window(trainer, pool, start: int, seconds: float, accumulate: int, device):
    """Steps back to back for `seconds` on the host clock, then to the end
    of the accumulation cycle: (steps, wall s)."""
    _sync(device)
    t0 = time.perf_counter()
    marks = [t0]
    while marks[-1] - t0 < seconds or (start + len(marks) - 1) % accumulate:
        trainer.train_step_on_batch(pool[(start + len(marks) - 1) % len(pool)])
        marks.append(time.perf_counter())
    _sync(device)
    wall = time.perf_counter() - t0
    gaps = sorted(1e3 * (b - a) for a, b in zip(marks, marks[1:]))
    q = statistics.quantiles(gaps, n=10) if len(gaps) > 1 else gaps * 9
    print(f"window steps {len(gaps)} wall_s {wall:.4f} host ms a step p10 {q[0]:.2f} "
          f"p50 {statistics.median(gaps):.2f} p90 {q[-1]:.2f} max {gaps[-1]:.2f}",
          file=sys.stderr)
    return len(gaps), wall


def _traced_window(trainer, pool, start: int, steps: int, device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    t0 = time.perf_counter()
    with torch.profiler.record_function(trace_math.WINDOW_RANGE):
        for n in range(steps):
            trainer.train_step_on_batch(pool[(start + n) % len(pool)])
        _sync(device)
    wall = time.perf_counter() - t0
    prof.stop()
    return steps, wall, trace_math.summarize(trace_math.events_from_profiler(prof), steps)


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device, started: float,
        ) -> dict:
    """One run of a cell: {"e2e", "summary", "checks", "attempted", "failed",
    "memory_peak_bytes", "reference_s"}."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    shapes = manifest.shapes(cell.config)
    traffic, work = cell.traffic, cell.workload
    cached = bool(traffic["teacher_cache"])
    accumulate = int(cell.config["training"]["accumulate_grad_batches"])
    trainer, pool, targets, prog, start = prepare(cell, seed, device)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started

    summary = None
    if trace:
        steps = int(work["trace_steps"])
        if steps % accumulate:
            raise ValueError(f"trace_steps {steps} is not whole cycles of {accumulate}")
        n, wall, summary = _traced_window(trainer, pool, start, steps, device)
    else:
        n, wall = _window(trainer, pool, start, seconds, accumulate, device)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    batch = traffic["batch"]
    e2e = {"train_images_per_s": n * batch / wall, "peak_mem_gib": window_peak / GIB,
           "setup_s": setup_s}
    if summary is not None:
        lengths = [int(x) for b in pool for x in b["attention_mask"].sum(1)]
        summary.update(shapes=shapes, cached=cached, batch=batch, images=n * batch,
                       caption_tokens=lengths, pool_batches=len(pool),
                       device_name=torch.cuda.get_device_name(device) if on_card else "cpu")

    del trainer
    free(device)
    t0 = time.perf_counter()
    ref = reference(cell, shapes, pool, int(work["check_steps"]), seed, device,
                    Precision("float32"), targets)
    checks = compare(prog, ref, cached, targets, ref["targets"])
    return {"e2e": e2e, "summary": summary, "checks": checks, "attempted": n, "failed": 0,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "reference_s": time.perf_counter() - t0}
