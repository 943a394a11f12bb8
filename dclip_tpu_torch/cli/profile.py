"""On-card distillation step profiler: per-phase decomposition + MFU.

Counterpart of `dclip_tpu/cli/profile.py`. One command reports where a
distillation step's time goes, on synthetic data with seeded random weights
(step time depends on shapes and dtypes, not on weight values):

  full uncached step     teacher region encode + tail + student step (the
                         first epoch's cost)
    teacher patch encode the B x P region crop-resize + frozen ViT forwards
    teacher tail         token-level text encode + cross-attention +
                         aggregation (the caption-dependent part)
  cache-warm step        student fwd/bwd + optimizer only (later epochs,
                         teacher targets from the target cache)

Each phase runs its warm-up calls, then `--steps` chained calls ended by
one `torch.cuda.synchronize()`, timed on the host clock; MFU of the two
end-to-end paths under both conventions (3x forward, and the default
trainable mask's model FLOPs) comes from `core.flops` against the card's
dense peak.

Both steps take the pixels already on the device (JAX's layout): the
upload of a real input pipeline's pixels is in no row. A SigLIP preset
(`siglip-so400m-14-384`) profiles the cache-warm step alone, its targets
put in the cache from a seed: the uncached step with a SigLIP teacher is
not brought, so its rows, and its MFU, are absent (null); `--trace_dir`
then records cache-warm steps.

`--trace_dir` records a separate window of min(3, steps) uncached steps
after the timed one (a recording perturbs step time) through
`core.metrics.start_trace`, and prints the window's kernel time, busy
share and unranged device time (outside every `dclip.*` range), and the
device span and host time of each `dclip.*` range of it.
`--per_op` runs `cli.profile_ops` instead: each op of the cache-warm step
against its floor.

Usage:
  python -m dclip_tpu_torch.cli.profile --model_preset vit-b-16 --batch 256
  python -m dclip_tpu_torch.cli.profile --json          # one JSON line last
  python -m dclip_tpu_torch.cli.profile --trace_dir /tmp/dclip_trace
  python -m dclip_tpu_torch.cli.profile --per_op [--json]
  python -m dclip_tpu_torch.cli.profile --device cpu --model_preset tiny --batch 4
"""
from __future__ import annotations

import argparse
import json as _json
import time
from typing import Callable, Optional

__all__ = ["main"]


def _time_phase(fn: Callable, sync: Callable, steps: int, warmup: int = 2) -> float:
    """Seconds per step: `warmup` untimed calls, each synchronized, then
    `steps` chained calls ended by ONE synchronize (a per-step synchronize
    would charge every step the host's wait, which a training loop never
    pays)."""
    for _ in range(warmup):
        fn()
        sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    sync()
    return (time.perf_counter() - t0) / steps


def print_ranges(trace: dict, steps: int, card: str) -> None:
    """The trace window's device (kernel) time, busy share and the device
    time no `dclip.*` range holds, and each range's device span and host ms
    per step (`core.metrics.device_time_by_range`)."""
    if trace["busy"] is None:
        print(f"trace: {steps} uncached steps; device time not measured ({card}: no "
              "device activity in the profile)")
        print("unranged ms/step: not measured")
    else:
        print(f"trace: {steps} uncached steps, kernels {trace['device_ms']:.3f} ms/step, busy "
              f"{trace['busy_ms']:.3f} ms/step, {100.0 * trace['busy']:.1f}% of the wall "
              f"({card})")
        print(f"unranged ms/step: {trace['unranged_ms']:.3f} (device work outside every "
              "dclip range)")
    print(f"{'range':<26}{'device span ms':>16}{'host ms':>12}")
    for name, r in trace["ranges"].items():
        dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        print(f"{name:<26}{dev:>16}{r['host_ms']:>12.3f}")


def main(argv: Optional[list] = None) -> int:
    from dclip_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(
        description="Profile one distillation training step phase by phase"
    )
    p.add_argument("--model_preset", default="vit-b-16",
                   help="CLIP preset: vit-b-32|vit-b-16|vit-l-14|tiny, or the SigLIP "
                        "siglip-so400m-14-384|tiny-siglip (the cache-warm step only)")
    p.add_argument("--batch", type=int, default=None,
                   help="batch (default: 256 on the card, 8 on the CPU)")
    p.add_argument("--steps", type=int, default=10,
                   help="timed steps per phase")
    p.add_argument("--max_patches", type=int, default=8,
                   help="teacher region slots per image")
    p.add_argument("--trace_dir", default=None,
                   help="also write a torch.profiler trace of a short uncached window "
                        "here and print its device time by range")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print one JSON line (last) instead of the table")
    p.add_argument("--per_op", action="store_true",
                   help="per-op floor decomposition of the cache-warm student step "
                        "(cli/profile_ops.py) instead of the phase table")
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error(f"--steps must be >= 1 (got {args.steps})")

    import torch

    from dclip_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)  # raises without a card
    on_card = device.type == "cuda"
    batch = args.batch if args.batch is not None else (256 if on_card else 8)
    if args.per_op:
        from dclip_tpu_torch.cli.profile_ops import run_per_op

        return run_per_op(batch, args.steps, args.as_json, device=device)

    import numpy as np

    from dclip_tpu_torch.cli.common import load_clip_state_dict, synthetic_distill_batch
    from dclip_tpu_torch.core.config import DistillConfig, TeacherConfig, model_family
    from dclip_tpu_torch.core.flops import distill_step_flops, mfu
    from dclip_tpu_torch.core.metrics import device_time_by_range, start_trace, stop_trace
    from dclip_tpu_torch.models.weights import random_teacher_state_dict
    from dclip_tpu_torch.ops.packing import pack_captions
    from dclip_tpu_torch.parallel.mesh import local_mesh
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    clip_cfg, clip_sd = load_clip_state_dict(args.model_preset, "random", 0)
    teacher_cfg = TeacherConfig(
        embed_dim=clip_cfg.projection_dim,
        num_heads=8 if clip_cfg.projection_dim % 64 == 0 else 4,
        max_patches=args.max_patches,
        max_text_tokens=clip_cfg.text.max_length,
    )
    cfg = DistillConfig(
        train_batch_size=batch,
        accumulate_grad_batches=1,
        teacher=teacher_cfg,
        student_model=args.model_preset,
        teacher_clip_model=args.model_preset,
    )
    cache = TeacherTargetCache(salt="profile-ephemeral")
    trainer = DistillTrainer(cfg, clip_sd, clip_sd, random_teacher_state_dict(teacher_cfg, 1),
                             clip_cfg, clip_cfg, device=device, teacher_cache=cache,
                             mesh=local_mesh())
    del clip_sd
    card = torch.cuda.get_device_name(device) if on_card else "cpu"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)

    host_batch = synthetic_distill_batch(clip_cfg, teacher_cfg, batch)
    host_batch["index"] = np.arange(batch, dtype=np.int64)
    data_dev = trainer._device_batch(host_batch)
    # The cache-warm batch: device pixels, host ids and index (the cache
    # keys and the host packing read them).
    data_hybrid = dict(host_batch)
    for k in ("pixel_values", "teacher_pixels"):
        data_hybrid[k] = data_dev[k]
    # With packing on, the uncached step keeps the text ids on the host so
    # that the trainer packs them as in a real first epoch: a batch of
    # device ids would silently time the UNPACKED text path while the warm
    # row times the packed one.
    data_uncached = dict(data_dev)
    text_frac = 1.0
    if trainer._packed_text:
        for k in ("input_ids", "attention_mask"):
            data_uncached[k] = host_batch[k]
        text_frac = pack_captions(
            host_batch["input_ids"], host_batch["attention_mask"],
            clip_cfg.text.eos_token_id,
        )["packed_ids"].shape[0] / batch

    steps = args.steps
    cache_only = model_family(clip_cfg) == "siglip"
    dt_full = dt_pe = dt_tail = pe = trace = None
    if cache_only:  # the targets from a seed, into the cache the warm step reads
        cache.put_batch(cache.keys_for(host_batch), np.random.RandomState(1).standard_normal(
            (batch, 2, teacher_cfg.embed_dim)).astype(np.float32))
        if args.trace_dir:
            trainer.train_step_on_batch(data_hybrid)
            n_traced = min(3, steps)
            start_trace(args.trace_dir)
            t0 = time.perf_counter()
            for _ in range(n_traced):
                trainer.train_step_on_batch(data_hybrid)
            sync()
            trace = device_time_by_range(stop_trace(), n_traced, time.perf_counter() - t0)

    # -- full uncached step (first-epoch path; no cache bookkeeping) ------
    if not cache_only:
        trainer.teacher_cache = None
        dt_full = _time_phase(lambda: trainer.train_step_on_batch(data_uncached), sync, steps)
    if args.trace_dir and not cache_only:
        # A SEPARATE window after the timed one: a recording perturbs step
        # time, so tracing the timed window would make dt_full and both
        # uncached MFU figures incomparable to the other rows.
        n_traced = min(3, steps)
        start_trace(args.trace_dir)
        t0 = time.perf_counter()
        for _ in range(n_traced):
            trainer.train_step_on_batch(data_uncached)
        sync()
        wall = time.perf_counter() - t0
        trace = device_time_by_range(stop_trace(), n_traced, wall)

    # -- teacher phases, isolated ----------------------------------------
    if not cache_only:
        with torch.no_grad():
            dt_pe = _time_phase(lambda: trainer._encode_patches_budgeted(host_batch, data_dev),
                                sync, steps)
            pe = trainer._encode_patches_budgeted(host_batch, data_dev)
            dt_tail = _time_phase(lambda: trainer._teacher_tail(pe, data_dev), sync, steps)

    # -- cache-warm step (later epochs: student fwd/bwd + optimizer) ------
    trainer.teacher_cache = cache
    dt_warm = _time_phase(
        lambda: trainer.train_step_on_batch(data_hybrid), sync, steps,
        warmup=3,  # the first warm call fills the target cache
    )

    dtype = trainer.cfg.compute_dtype
    scfg, tccfg = trainer.student_config, trainer.teacher_clip_config

    def _mfu(dt, cached, honest):
        if dt is None:
            return None
        f = distill_step_flops(scfg, tccfg, teacher_cfg, batch,
                               teacher_cached=cached, reference_mask=honest,
                               text_rows_fraction=text_frac)
        return mfu(f / dt, device, dtype)

    rows = [("  student step (cache-warm)", dt_warm, batch / dt_warm)]
    if not cache_only:
        rows = [
            ("full uncached step", dt_full, batch / dt_full),
            ("  teacher patch encode", dt_pe, None),
            ("  teacher tail (text+xattn)", dt_tail, None),
            rows[0],
            ("  residual (dispatch/overlap)",
             dt_full - dt_pe - dt_tail - dt_warm, None),
        ]
    result = {
        "preset": args.model_preset,
        "batch": batch,
        "backend": f"cuda ({card})" if on_card else "cpu",
        "compute_dtype": dtype,
        "use_pallas": bool(trainer.cfg.use_pallas),
        "packed_text": bool(trainer._packed_text),
        "phases_ms": {
            name.strip(): round(dt * 1e3, 2) for name, dt, _ in rows
        },
        "images_per_sec_uncached": None if dt_full is None else round(batch / dt_full, 2),
        "images_per_sec_cache_warm": round(batch / dt_warm, 2),
        "mfu_uncached": _mfu(dt_full, False, False),
        "mfu_uncached_masked_true": _mfu(dt_full, False, True),
        "mfu_cache_warm": _mfu(dt_warm, True, False),
        "mfu_cache_warm_masked_true": _mfu(dt_warm, True, True),
        "trace_dir": args.trace_dir,
    }
    for k in list(result):
        if k.startswith("mfu_") and result[k] is not None:
            result[k] = round(result[k], 4)
    del trainer, data_dev, data_hybrid, data_uncached, pe

    if trace is not None:
        print_ranges(trace, min(3, steps), card)
        print(f"torch.profiler trace written to {args.trace_dir}")
    if args.as_json:
        print(_json.dumps(result))
        return 0

    print(f"== dclip_tpu_torch step profile: {args.model_preset} batch={batch} "
          f"backend={result['backend']} dtype={dtype} "
          f"kernels={result['use_pallas']} ==")
    print(f"{'phase':<32}{'ms/step':>10}{'img/s':>10}{'share':>9}")
    for name, dt, ips in rows:
        share = 100.0 * dt / (dt_full or dt_warm)
        print(f"{name:<32}{dt * 1e3:>10.2f}"
              f"{(f'{ips:.1f}' if ips else '-'):>10}{share:>8.1f}%")
    print("note: the student row is timed via the cacheable hybrid batch, so"
          " it also pays host cache-key hashing + the cache gather that the"
          " all-device full-step rows do not; its share is slightly"
          " overstated and the residual can go negative.")
    fmt = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
    print(f"MFU uncached {fmt(result['mfu_uncached'])} "
          f"(true {fmt(result['mfu_uncached_masked_true'])})   "
          f"cache-warm {fmt(result['mfu_cache_warm'])} "
          f"(true {fmt(result['mfu_cache_warm_masked_true'])})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
