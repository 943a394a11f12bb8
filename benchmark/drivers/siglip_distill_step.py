"""The distillation step with a SigLIP so400m/14-384 student:
`DistillTrainer.train_step_on_batch` as `DistillConfig` resolves it on
CUDA (bf16, the hand-written kernels, remat on), every step's targets a
hit of the trainer's device-level cache.

As `distill_step` (whose window, comparison and helpers it takes), with
SigLIP's inputs, weights and reference:

- the pool: per batch, pixels N(0, 0.1^2) at the configuration's size,
  drawn on the device from the seed and copied to the host once; captions
  as SigLIP's processor gives them: 8-24 SentencePiece ids (from the seed,
  above the pad / EOS id) ending in the EOS id, padded with the pad id to
  the tower's 64 positions, no mask read; each batch's 1152-wide (image,
  text) targets from the seed, put in both cache levels in set-up;
- the weights: HF `SiglipModel`'s state dict (`reference.siglip.siglip_specs`)
  for the student and for the teacher's CLIP, N(0, 0.02) from the seed;
- the reference: `reference.siglip`, in blocks, float32 with TF32 off;
- the traced summary also carries each kernel family's device time, summed
  over the window's operations by kernel name (`KERNEL_FAMILIES`), which
  the SigLIP rooflines read.
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import manifest, weights
from benchmark.drivers.distill_step import (
    GIB,
    PARTS,
    _rng,
    _sync,
    _window,
    compare,
    free,
    make_targets,
)
from benchmark.frozen import trace_math
from benchmark.reference import siglip as ref
from benchmark.reference.clip import Precision

# Kernel family -> a substring of its kernels' names in the profiler.
KERNEL_FAMILIES = {
    "attention_fwd": "attention_kernel<",
    "attention_dq": "attention_bwd_dq_kernel",
    "attention_dkdv": "attention_bwd_dkdv_kernel",
    "gemm": "gemm_persistent_kernel",
    "layernorm": "layernorm_kernel<",
    "layernorm_bwd": "layernorm_bwd_kernel<",
}


def captions(text, batch: int, rng: np.random.RandomState):
    """(ids, valid mask) [B, S] int32: 8-24 ids ending in EOS, then pad (a
    fixed 6 below 26 positions, as the frozen generator)."""
    s = text.max_length
    ids = rng.randint(2, text.vocab_size, size=(batch, s)).astype(np.int32)
    lengths = rng.randint(8, 25, size=batch) if s >= 26 else np.full(batch, 6)
    for r, n in enumerate(lengths):
        ids[r, n - 1] = text.eos_token_id
        ids[r, n:] = text.pad_token_id
    return ids, (np.arange(s)[None] < lengths[:, None]).astype(np.int32)


def make_pool(sh, traffic: dict, seed: int, device) -> List[dict]:
    b, size = traffic["batch"], sh.vision.image_size
    pool = []
    for k in range(traffic["pool_batches"]):
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 1_000_003 + 101 + k) % (1 << 63))
        pixels = torch.empty((b, size, size, 3), device=device).normal_(0.0, 0.1, generator=gen)
        ids, mask = captions(sh.text, b, _rng(seed, k))
        pool.append({"pixel_values": pixels.cpu().numpy(), "input_ids": ids,
                     "attention_mask": mask,
                     "index": np.arange(k * b, (k + 1) * b, dtype=np.int64)})
    return pool


def all_groups(sh, seed: int, device, host: bool = False):
    specs = ref.siglip_specs(sh)
    return {"student": weights.make(specs, seed, "student", device, sh.logit_init, host),
            "teacher_clip": weights.make(specs, seed, "teacher_clip", device, sh.logit_init,
                                         host),
            "teacher_xattn": weights.make(weights.xattn_specs(sh), seed, "teacher_xattn", device,
                                          host=host)}


def clip_config(config: dict):
    """The port's configuration of the file's SigLIP."""
    from dclip_tpu_torch.core.config import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

    t, v = config["text_config"], config["vision_config"]

    def tower(c):
        return dict(hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
                    num_heads=c["num_attention_heads"], mlp_dim=c["intermediate_size"],
                    layer_norm_eps=c["layer_norm_eps"])

    return CLIPConfig(
        text=CLIPTextConfig(vocab_size=t["vocab_size"], max_length=t["max_position_embeddings"],
                            eos_token_id=t["eos_token_id"], **tower(t)),
        vision=CLIPVisionConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                                **tower(v)),
        projection_dim=config["projection_dim"],
        logit_scale_init=config["logit_scale_init_value"], family="siglip")


def _trainer(cell, sh, groups, device, cache):
    from dclip_tpu_torch.core.config import DistillConfig, TeacherConfig
    from dclip_tpu_torch.parallel.mesh import local_mesh
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    clip = clip_config(cell.config)
    teacher = TeacherConfig(**vars(sh.teacher))
    train = cell.config["training"]
    on_card = torch.device(device).type == "cuda"
    cfg = DistillConfig(
        train_batch_size=cell.traffic["batch"], learning_rate=train["learning_rate"],
        warmup_steps=train["warmup_steps"], gradient_clip_val=train["gradient_clip_val"],
        accumulate_grad_batches=train["accumulate_grad_batches"],
        contrastive_weight=train["contrastive_weight"], temperature=train["temperature"],
        teacher=teacher, remat=train["remat"], packed_text=False,
        compute_dtype=train["compute_dtype"] if on_card else "auto",
        use_pallas=None if on_card else True)
    return DistillTrainer(cfg, groups["student"], groups["teacher_clip"],
                          groups["teacher_xattn"], clip, clip, device=device,
                          teacher_cache=cache, mesh=local_mesh())


def program_readings(trainer, pool, steps: int, sh, seed: int, device, b1: float,
                     accumulate: int) -> dict:
    """`distill_step`'s readings of the first `steps` steps: loss parts and
    targets a step, the first update's clipped mean gradient a leaf (AdamW's
    first moment), each trainable leaf's change after the last step."""
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
    p0 = weights.make(ref.siglip_specs(sh), seed, "student", device, sh.logit_init)
    params = dict(trainer.student.named_parameters())
    with torch.no_grad():
        change = torch.stack([(params[n].detach().float() - p0[n]).norm() for n in names])
    del p0
    return {"losses": [{k: float(m[k]) for k in PARTS} for _, _, m in seen],
            "targets": [(a, b) for a, b, _ in seen],
            "grad_norms": dict(zip(names, (grad_norms / (1.0 - b1)).tolist())),
            "change_norms": dict(zip(names, change.tolist()))}


def prepare(cell, seed: int, device):
    """Set-up: the pool and targets, the trainer with both cache levels
    filled, its first `check_steps` steps and their readings."""
    from dclip_tpu_torch.train.distill_trainer import TeacherTargetCache

    sh = ref.shapes(cell.config)
    traffic = cell.traffic
    steps = int(cell.workload["check_steps"])
    accumulate = int(cell.config["training"]["accumulate_grad_batches"])
    if steps % accumulate:
        raise ValueError(f"check_steps {steps} is not whole cycles of {accumulate}")
    if not traffic["teacher_cache"]:
        raise ValueError("the SigLIP student runs the cached step only")
    marks = [("start", time.perf_counter())]
    pool = make_pool(sh, traffic, seed, device)
    targets = make_targets(sh, traffic, seed)
    marks.append(("pool", time.perf_counter()))
    groups = all_groups(sh, seed, device, host=True)
    marks.append(("weights", time.perf_counter()))
    cache = TeacherTargetCache(salt=f"bench-{seed}")
    trainer = _trainer(cell, sh, groups, device, cache)
    del groups
    if trainer._dev_full is None:
        raise RuntimeError("the trainer built no device level in front of its target cache")
    for batch, t in zip(pool, targets):
        keys = cache.keys_for(batch)
        cache.put_batch(keys, t)
        trainer._dev_full.put(keys, torch.from_numpy(t).to(device))
    _sync(device)
    marks.append(("trainer", time.perf_counter()))
    prog = program_readings(trainer, pool, steps, sh, seed, device,
                            cell.config["training"]["adam_b1"], accumulate)
    _sync(device)
    marks.append(("first_steps", time.perf_counter()))
    print("setup " + " ".join(f"{b[0]}_s {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)
    return trainer, pool, targets, prog, steps


def kernel_families(events) -> Dict[str, float]:
    """Seconds of device time a kernel family, over the traced window."""
    window = [e for e in events if e.kind == "host_range" and e.name == trace_math.WINDOW_RANGE]
    w0, w1 = (window[0].start_ns, window[0].end_ns) if window else (-1, 1 << 62)
    out = dict.fromkeys(KERNEL_FAMILIES, 0.0)
    for e in events:
        if e.kind == "device_op" and w0 <= e.start_ns and e.end_ns <= w1:
            for family, pattern in KERNEL_FAMILIES.items():
                if pattern in e.name:
                    out[family] += (e.end_ns - e.start_ns) / 1e9
    return out


def traced_window(trainer, pool, start: int, steps: int, device):
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
    events = trace_math.events_from_profiler(prof)
    summary = trace_math.summarize(events, steps)
    if summary is not None:
        summary["kernels_s"] = kernel_families(events)
    return steps, wall, summary


def reference(cell, sh, pool, steps: int, seed: int, device, prec: Precision, targets,
              rows=None):
    """The reference's readings of the first `steps` steps on the cached
    targets, computed after the program is gone."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = weights.make(ref.siglip_specs(sh), seed, "student", device, sh.logit_init)
    ref_targets = [(torch.from_numpy(t[:, 0]).to(device), torch.from_numpy(t[:, 1]).to(device))
                   for t in (targets[k % len(targets)] for k in range(steps))]
    batches = [pool[k % len(pool)] for k in range(steps)]
    out = ref.reference_run(params, sh, cell.config["training"], batches, ref_targets, device,
                            prec, rows)
    out["targets"] = [(a.float().cpu(), b.float().cpu()) for a, b in ref_targets]
    return out


def report_leaves(prog: dict, ref_out: dict, top: int = 5) -> None:
    """The leaves farthest from the reference in `grad` and `change` as
    `compare` weighs them (over the larger of the leaf's and the median
    leaf's reference norm), to standard error."""
    for key in ("grad_norms", "change_norms"):
        median = statistics.median(ref_out[key].values())
        gaps = sorted(((abs(prog[key][n] - r) / max(r, median), n, prog[key][n], r)
                       for n, r in ref_out[key].items()), reverse=True)[:top]
        print(f"{key} worst: " + "; ".join(f"{n} {g:.3g} ({p:.4g} vs {r:.4g})"
                                           for g, n, p, r in gaps), file=sys.stderr)


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device, started: float,
        ) -> dict:
    """One run of the cell: `distill_step.run`'s result."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    sh = ref.shapes(cell.config)
    traffic, work = cell.traffic, cell.workload
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
        n, wall, summary = traced_window(trainer, pool, start, steps, device)
    else:
        n, wall = _window(trainer, pool, start, seconds, accumulate, device)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    batch = traffic["batch"]
    e2e = {"train_images_per_s": n * batch / wall, "peak_mem_gib": window_peak / GIB,
           "setup_s": setup_s}
    if summary is not None:
        summary.update(shapes=sh, batch=batch, images=n * batch,
                       remat=bool(cell.config["training"]["remat"]),
                       device_name=torch.cuda.get_device_name(device) if on_card else "cpu")

    del trainer
    free(device)
    t0 = time.perf_counter()
    out = reference(cell, sh, pool, int(work["check_steps"]), seed, device,
                    Precision("float32"), targets)
    checks = compare(prog, out, True, targets, out["targets"])
    report_leaves(prog, out)
    return {"e2e": e2e, "summary": summary, "checks": checks, "attempted": n, "failed": 0,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "reference_s": time.perf_counter() - t0}


def limit_readings(cell, seed: int, device) -> dict:
    """The readings the cell's limits come from, without a window: the
    program's numbers against the float32 reference (the lower reading),
    and the float8 control and a half batch against it (the upper)."""
    device = torch.device(device)
    sh = ref.shapes(cell.config)
    trainer, pool, targets, prog, _ = prepare(cell, seed, device)
    del trainer
    free(device)
    steps = int(cell.workload["check_steps"])
    f32 = reference(cell, sh, pool, steps, seed, device, Precision("float32"), targets)
    out = {"program": compare(prog, f32, True, targets, f32["targets"])}
    report_leaves(prog, f32)
    print(f"program {out['program']}", file=sys.stderr, flush=True)
    for name, prec, rows in (("float8", Precision("float8"), None),
                             ("half_batch", Precision("float32"), cell.traffic["batch"] // 2)):
        other = reference(cell, sh, pool, steps, seed, device, prec, targets, rows)
        other["targets"] = prog["targets"]
        out[name] = compare(other, f32, True, targets, f32["targets"])
    return out
