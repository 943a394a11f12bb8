#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases; each one passes or raises, and any failure exits non-zero:

1. Device: requires `torch.cuda.is_available()`; prints the card's
   `nvidia-smi --query-gpu=name,power.limit` line.
2. Build and load: compiles `dclip_tpu_torch/kernels/csrc/*.cu` with nvcc
   from the checkout, prints the build time and ptxas resource lines, then
   loads the library, which runs its self-check (one x2 launch on an
   [8, 128] f32 buffer, compared exactly) and prints the result.
3. Kernels: at ViT-B/16 shapes (B=64, S=197, D=768, 12 heads, MLP 3072,
   bf16) holds every CUDA kernel (layernorm, the four GEMM epilogues,
   attention) and both blocks (attention, MLP) against their plain
   PyTorch twins on the same inputs, plus a ragged B=1 case, and times
   kernel and twin with CUDA events in turns (plain, kernel, kernel, plain).
4. Slice: builds the B/16 `ClipService` through the serve CLI's own
   `build_service` (random weights from seed 0, bf16, buckets 1,4,16,64,
   index_dim 512), runs `warmup()`, the CLI's `--selftest` against a live
   HTTP server, and 8 random images; checks the launch counters rose by
   exactly 12 layers x launches per layer x image batches, the embeddings
   are 512-d, finite and unit-norm, and the bf16 kernel path agrees with
   the f32 plain-twin path on the card in cosine.
5. Timing: `--bench`-style lines per modality at concurrency 1 and 32.
6. Training kernels: at the ViT-B/16 cache-warm step's shapes holds the
   attention forward with stats (vision S=197 D=768 H=12 at B=256; the
   text tower's packed rows, causal + segments, and unpacked batch, causal
   + padding, S=77 D=512 H=8), its stats-free mode, the attention
   backward (dq, dk, dv), the frozen-MLP forward (y, a1) and dx, the
   LayerNorm backward, and the distillation loss (parts; dsi, dst) at
   B=256 against their plain twins, plus a ragged small case of each, with
   CUDA-event times in turns.
7. Cross-attention kernels (K10): at the teacher tail's shapes (B=256, 77
   text tokens with the synthetic batch's content-token masks, 8 boxes with
   two all-invalid rows and random others, D=512, 8 heads, f32 inputs)
   holds the fused cross-attention, its attention core and its add +
   LayerNorm pass against their twins, and times them; times the loader's
   self-check kernel.
8. Training slice, cache-warm: the port's `DistillTrainer` at ViT-B/16
   (student = teacher CLIP, random weights from seed 0, bf16, kernels on,
   packed text, B=256, accumulate 1) on the synthetic batch (seed 0) with
   its full teacher targets in an in-memory `TeacherTargetCache` (seeded
   unit vectors): 2 warm-up and 5 timed steps, finite and falling loss,
   launch counters at exactly 7 x the per-step count, one no-grad packed
   text encode on the stats-free attention, a torch.profiler window of 2
   steps, ms per step and cache-warm images/s.
9. Training slice, uncached (the main path of this slice): the same trainer
   with the meta-teacher `TeacherConfig(512, 8 heads, 8 boxes, 77 tokens)`
   (random weights from seed 0) and no teacher cache, as bench.py runs it:
   every step crops the 2,048 boxes, runs the teacher ViT over them (K1 /
   K2), the teacher text tower (K3) and the cross-attention (K10), then the
   student step. 2 warm-up and 5 timed steps: ms per step, images/s, peak
   device memory, exact launch counts (7 x the per-step count), a
   torch.profiler breakdown of one step by stage and by kernel.
10. Cache levels: a `TeacherTargetCache`; the first step misses and fills
   every level, a repeat hits the device full-target level (no K1 / K2 /
   K10 launch), the same images with resampled captions hit the device
   patch-embedding level (no K1 / K2 launch, one K10).
11. Teacher-target agreement: B=2, 8 boxes (3 invalid), full width and
   depth: the bf16 kernels on the card vs the port's f32 plain path (the
   modules, no kernel) on the CPU on the same weights; per-row cosine
   >= 0.99 for the image and the text target.
12. Gradient agreement: one cache-warm step's trainable gradients at full
   width and depth, B=8, bf16 kernels on the card vs the same step in f32
   on the CPU through the twins: global cosine >= 0.99, every tensor >= 0.95.
13. Trainable-block kernels (K8, K9): at the fused step's shapes (the
   packed text rows [R, 77, 512], mlp 2048; vision [256, 197, 768], 12
   heads) holds K8's forward (y, a1) and its seven gradients, K9's forward
   (o, q, k, v, attn, m, rinv) and its eleven gradients, and their CUDA
   parts (the GEMM's NT and TN modes, the column sums, the LayerNorm
   weight-gradient backward) against their twins, plus a ragged small case
   of each, with CUDA-event times in turns.
14. K7 at ViT-L/14 widths: the frozen-MLP pair (K6, which K7 folds into)
   forward and dx at [32, 257, 1024], mlp 4096, against its twin, timed.
15. Training slice, fused cache-warm: the slice of phase 8 with
   `fused_text_mlp` (K8) and `fused_attn_block` (K9): 2 warm-up and 5 timed
   steps, exact launch counts by the blocks' skip rules, peak memory, a
   profile, printed beside phase 8's numbers.
16. Gradient agreement in the fused configuration, as phase 12, with the
   vision LN1 unfrozen at epoch 0 so that K9's LayerNorm weight gradients
   are held too.
17. Fit: `DistillTrainer.fit` at B=32 in the fused configuration, 2 epochs
   of 2 steps, `UnfreezeStage(epoch=1, patterns=("mlp", "layer_norm"))`, a
   `CheckpointManager` in a temporary directory: K6 runs in epoch 0 only,
   K9 in both, the vision LN1 / MLP gradients are non-zero in epoch 1; a
   fresh trainer's `resume` restores step, parameters and optimizer state
   bit for bit and replays the stage, and its next update equals the
   uninterrupted trainer's bit for bit (no kernel sums with atomics).

Every kernel's entry in the `kernels` line carries its bound: the larger
of its operations over the card's peak for their type (989 TFLOP/s bf16
tensor cores, 67 TFLOP/s f32 CUDA cores) and the bytes it must move (each
input read once, each output written once) over 3.35 TB/s, from the
shapes of this run; and `library_ms`, the time of one PyTorch call that
computes the same function, where there is one
(`scaled_dot_product_attention` and its backward), else null.

The second-to-last line is `{"kernels": [...]}` and the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

B, S, D, HEADS, MLP = 64, 197, 768, 12, 3072
EPS = 1e-5
# Kernel vs twin: bf16 keeps 8 significant bits (unit roundoff 2^-9). The
# kernels round their output and their bf16 intermediates (LN output,
# q/k/v, softmax weights P, GELU output) where the f32 twin does not, so a
# few bf16 roundings at the top of the output's range must pass:
# max |kernel - twin| <= 2^-6 * max(1, max |twin|).
REL_TOL = 2.0**-6
# Backward kernels vs their f32 twins: the gradients chain two more bf16
# roundings (e and dS, or da1, enter the tensor cores as bf16) and the
# twin runs from the f32 forward's statistics (ROADMAP Queue 3: the bf16
# forward's rinv comes from rounded exponentials), so one more bit:
# max |kernel - twin| <= 2^-5 * max(1, max |twin|).
BWD_TOL = 2.0**-5
# The distillation loss computes in f32 from the same bf16 / f32 inputs as
# its twin; only the summation order differs. Each of the four parts is
# held to a relative f32 bound; the gradients (O(1/B)) are both rounded
# from f32 to bf16 at the end, so they differ by at most one bf16 ulp:
# max |kernel - twin| <= 2^-7 * max |twin|.
DL_RTOL = 1e-5
DL_BWD_TOL = 2.0**-7
# Service: bf16 kernel path vs f32 plain-twin path, 12 layers of bf16
# rounding on random weights; every image's cosine must reach this.
COS_BOUND = 0.99

# The card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W).
BF16_PEAK, F32_PEAK, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12

SRC = "dclip_tpu_torch/kernels/csrc/"
TPU = "dclip_tpu/kernels/vit_block.py"
KERNELS = {  # wrapper -> (source, TPU kernel it replaces)
    "layernorm": (SRC + "layernorm.cu", TPU + ":47,96"),
    "gemm_bias_act_residual": (SRC + "gemm.cu", TPU + ":47,96"),
    "attention": (SRC + "attention.cu", TPU + ":47"),
    "attention_block": ("dclip_tpu_torch/kernels/vit_block.py", TPU + ":47"),
    "mlp_block": ("dclip_tpu_torch/kernels/vit_block.py", TPU + ":96"),
}
# The training path's kernels (K3/K4/K5, K6, K11).
TRAIN_KERNELS = {
    "self_attention_fused": (SRC + "attention.cu", "dclip_tpu/kernels/vit_attention.py:127"),
    "self_attention_fwd_stats": (SRC + "attention.cu", "dclip_tpu/kernels/vit_attention.py:246"),
    "self_attention_bwd_stats": (SRC + "attention_bwd.cu",
                                 "dclip_tpu/kernels/vit_attention.py:308"),
    "mlp_frozen_fwd": ("dclip_tpu_torch/kernels/mlp_frozen.py",
                       "dclip_tpu/kernels/mlp_frozen.py:135"),
    "mlp_frozen_bwd": ("dclip_tpu_torch/kernels/mlp_frozen.py",
                       "dclip_tpu/kernels/mlp_frozen.py:159"),
    "layernorm_bwd": (SRC + "layernorm.cu", "dclip_tpu/kernels/mlp_frozen.py:159"),
    "distill_loss_fwd": (SRC + "distill_loss.cu", "dclip_tpu/kernels/distill_loss.py:47"),
    "distill_loss_bwd": (SRC + "distill_loss.cu", "dclip_tpu/kernels/distill_loss.py:73"),
}
# The uncached step's new kernels: K10 and its two CUDA kernels, and the
# loader's self-check (K13).
XATTN = "dclip_tpu/kernels/cross_attention.py:74"
TEACHER_KERNELS = {
    "cross_attention": ("dclip_tpu_torch/kernels/cross_attention.py", XATTN),
    "cross_attention_core": (SRC + "cross_attention.cu", XATTN),
    "add_layernorm_f32": (SRC + "cross_attention.cu", XATTN),
    "loader_self_check": (SRC + "status.cu", "dclip_tpu/kernels/__init__.py:39"),
}
# The fused-trainable step's kernels: K8, K9 and the GEMM modes and row
# reductions they add.
K8 = "dclip_tpu/kernels/mlp_trainable.py"
K9 = "dclip_tpu/kernels/attn_block_trainable.py"
TRAINABLE_KERNELS = {
    "mlp_trainable_fwd": ("dclip_tpu_torch/kernels/mlp_trainable.py",
                          "dclip_tpu/kernels/mlp_frozen.py:135"),
    "mlp_trainable_bwd": ("dclip_tpu_torch/kernels/mlp_trainable.py", K8 + ":82,134"),
    "attn_block_trainable_fwd": ("dclip_tpu_torch/kernels/attn_block_trainable.py", K9 + ":78"),
    "attn_block_trainable_bwd": ("dclip_tpu_torch/kernels/attn_block_trainable.py",
                                 K9 + ":224"),
    "gemm_nt": (SRC + "gemm.cu", K9 + ":78"),
    "gemm_tn": (SRC + "gemm.cu", K8 + ":82,134"),
    "colsum": (SRC + "reduce.cu", K8 + ":82,134"),
    "layernorm_bwd_wgrad": (SRC + "layernorm.cu", K8 + ":82"),
}
TRAIN_B, TEXT_S, TEXT_D, TEXT_HEADS, TEXT_MLP = 256, 77, 512, 8, 2048
# A weight or bias gradient, kernel vs twin on the same bf16 operands: f32
# sums of the same products in another order, within 1e-4 of the largest
# |twin| (csrc/gemm.cu TN mode, csrc/reduce.cu, the LayerNorm sums).
SUM_TOL = 1e-4
# K7 at ViT-L/14 widths (CLIPConfig.vit_l_14().vision, B=32).
L14_B, L14_S, L14_D, L14_MLP = 32, 257, 1024, 4096
FIT_B, FIT_EPOCHS, FIT_STEPS = 32, 2, 2
WARMUP_STEPS, TIMED_STEPS = 2, 5
GRAD_B, GRAD_COS_GLOBAL, GRAD_COS_TENSOR = 8, 0.99, 0.95
# k_proj.bias gradients are rounding noise (see grad_agreement_phase); their
# norm must stay below this share of the layer's q_proj.bias gradient.
GRAD_NOISE_RATIO = 0.1
# bench.py's teacher: TeacherConfig(embed_dim=512, num_heads=8,
# max_patches=8, max_text_tokens=77).
TEACHER_P = 8
AGREE_B, TARGET_COS = 2, 0.99


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_state() -> str:
    """The card's SM clock, power draw and temperature, now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return "sm clock, power, temperature: " + out.stdout.strip().splitlines()[0]


def import_port_modules():
    """The port modules the phases use (each phase imports its own lazily,
    so that the script fails fast, and cleanly, without a card)."""
    import importlib

    for name in ("dclip_tpu_torch.cli.serve", "dclip_tpu_torch.cli.common",
                 "dclip_tpu_torch.kernels._build", "dclip_tpu_torch.kernels.vit_block",
                 "dclip_tpu_torch.kernels.vit_attention", "dclip_tpu_torch.kernels.mlp_frozen",
                 "dclip_tpu_torch.kernels.distill_loss",
                 "dclip_tpu_torch.kernels.cross_attention", "dclip_tpu_torch.models.weights",
                 "dclip_tpu_torch.kernels.mlp_trainable",
                 "dclip_tpu_torch.kernels.attn_block_trainable",
                 "dclip_tpu_torch.kernels.trainable_ops", "dclip_tpu_torch.train.checkpoint",
                 "dclip_tpu_torch.train.distill_trainer", "dclip_tpu_torch.ops.image_ops",
                 "dclip_tpu_torch.ops.packing"):
        importlib.import_module(name)


# -- the kernel table: errors, times, bounds --------------------------------------


class KernelTable:
    """Per kernel: the largest error against its twin, and summed over the
    timed cases its time, its twin's, its bound and its library call's."""

    def __init__(self, names):
        self.rows = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "library_ms": None, "_ops_ms": 0.0, "_bytes_ms": 0.0} for n in names}

    def error(self, name, err):
        r = self.rows[name]
        r["max_abs_err"] = max(r["max_abs_err"], float(err))

    def timed(self, name, ms, plain_ms, bound, library_ms=None):
        """`bound` = (operations ms, bytes ms) of the timed call."""
        r = self.rows[name]
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += max(bound)
        r["_ops_ms"] += bound[0]
        r["_bytes_ms"] += bound[1]
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms

    def entry(self, name):
        r = dict(self.rows[name])
        r["bound_by"] = "operations" if r.pop("_ops_ms") >= r.pop("_bytes_ms") else "bytes"
        return r


def work(bf16_flops=0.0, f32_flops=0.0, nbytes=0.0):
    """(ms at the operations' peaks, ms at the memory rate)."""
    return (1e3 * (bf16_flops / BF16_PEAK + f32_flops / F32_PEAK),
            1e3 * nbytes / HBM_BYTES_PER_S)


def gemm_work(m, k, n, extra_mn=0):
    """A bf16 GEMM [m, k] @ [k, n] + bias, bf16 out; `extra_mn` more bf16
    [m, n] tensors moved (residual, saved pre-activation)."""
    return work(bf16_flops=2.0 * m * k * n,
                nbytes=2.0 * (m * k + k * n + m * n * (1 + extra_mn)) + 4.0 * n)


def time_pair(torch, kernel_fn, plain_fn, iters: int):
    """Mean ms per call of kernel and twin, in turns plain, kernel, kernel,
    plain, after one warm call of each."""
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if which == "kernel" else plain_fn
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms[which].append(start.elapsed_time(end) / iters)
    return sum(ms["kernel"]) / 2, sum(ms["plain"]) / 2


def time_one(torch, fn, iters: int) -> float:
    """Mean ms per call over two windows after a warm call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return sum(out) / 2


def sdpa_calls(torch, q, k, v, heads, keep, g=None):
    """`scaled_dot_product_attention` on the same q, k, v ([B, S, D] views)
    with the same boolean mask `keep` [B, S, S] (None: unmasked): the
    forward, and with `g` the backward of that call."""
    F = torch.nn.functional
    b, s, d = q.shape

    def h(t):
        return t.reshape(b, s, heads, d // heads).transpose(1, 2)

    mask = None
    if keep is not None:  # a 16-aligned row stride, as the fused backends want
        store = torch.zeros((b, 1, s, (s + 15) // 16 * 16), dtype=torch.bool, device=q.device)
        store[..., :s] = keep[:, None]
        mask = store[..., :s]
    if g is None:
        return lambda: F.scaled_dot_product_attention(h(q), h(k), h(v), attn_mask=mask)
    qg, kg, vg = (h(t).detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    g4 = h(g)
    return lambda: torch.autograd.grad(o, (qg, kg, vg), g4, retain_graph=True)


def layer_weights(rng, torch, device):
    """One encoder layer in the packed layout, drawn like random weights
    (N(0, 0.02) matrices) but with non-trivial biases and LN affines so
    every epilogue term is exercised."""
    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32") * 0.02).to(device)

    def f32(n, base):
        return torch.from_numpy(base + 0.1 * rng.standard_normal(n).astype("float32")).to(device)

    bf = torch.bfloat16
    return {
        "ln1_scale": f32(D, 1.0), "ln1_bias": f32(D, 0.0),
        "qkv_w": w(D, 3 * D).to(bf), "qkv_b": f32(3 * D, 0.0),
        "out_w": w(D, D).to(bf), "out_b": f32(D, 0.0),
        "ln2_scale": f32(D, 1.0), "ln2_bias": f32(D, 0.0),
        "fc1_w": w(D, MLP).to(bf), "fc1_b": f32(MLP, 0.0),
        "fc2_w": w(MLP, D).to(bf), "fc2_b": f32(D, 0.0),
    }


def kernel_phase(torch, vb, card: str, table: KernelTable):
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    p = layer_weights(rng, torch, dev)

    def randn(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype("float32") * scale)
                .to(dev).to(torch.bfloat16))

    for b in (B, 1):
        m = b * S
        x = randn(b, S, D)
        h = randn(b, S, D)
        a = randn(b, S, D)
        g = randn(b, S, MLP)
        qkv = randn(b, S, 3 * D)
        attn_flops = 4.0 * b * HEADS * S * S * (D // HEADS)
        cases = [  # name, variant, (kernel, twin), args, kwargs, bound, library call
            ("layernorm", "ln", (vb.layernorm, vb.layernorm_reference),
             (x, p["ln1_scale"], p["ln1_bias"], EPS), {},
             work(f32_flops=8.0 * m * D, nbytes=4.0 * m * D + 8.0 * D), None),
            ("gemm_bias_act_residual", "qkv",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (h, p["qkv_w"], p["qkv_b"]), {}, gemm_work(m, D, 3 * D), None),
            ("gemm_bias_act_residual", "out_proj+residual",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (a, p["out_w"], p["out_b"]), {"residual": x}, gemm_work(m, D, D, 1), None),
            ("gemm_bias_act_residual", "fc1+gelu",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (h, p["fc1_w"], p["fc1_b"]), {"gelu": True}, gemm_work(m, D, MLP), None),
            ("gemm_bias_act_residual", "fc2+residual",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (g, p["fc2_w"], p["fc2_b"]), {"residual": x}, gemm_work(m, MLP, D, 1), None),
            ("attention", "core", (vb.attention, vb.attention_reference), (qkv, HEADS), {},
             work(bf16_flops=attn_flops, nbytes=2.0 * m * 4 * D),
             sdpa_calls(torch, qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], HEADS, None)),
            ("attention_block", "block",
             (vb.attention_block_fused, vb.attention_block_reference), (x, p, HEADS, EPS), {},
             work(bf16_flops=2.0 * m * D * 4 * D + attn_flops,
                  nbytes=4.0 * m * D + 8.0 * D * D + 4.0 * 6 * D), None),
            ("mlp_block", "block", (vb.mlp_block_fused, vb.mlp_block_reference),
             (x, p, EPS), {},
             work(bf16_flops=4.0 * m * D * MLP,
                  nbytes=4.0 * m * D + 4.0 * D * MLP + 4.0 * (MLP + 3 * D)), None),
        ]
        for name, variant, (kernel, twin), args, kwargs, bound, library in cases:
            got = kernel(*args, **kwargs)
            want = twin(*args, **kwargs)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.bfloat16:
                raise AssertionError(f"{name}[{variant}] B={b}: got {got.shape} {got.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}[{variant}] B={b}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            tol = REL_TOL * max(1.0, want.float().abs().max().item())
            print(f"kernel {name}[{variant}] B={b}: max_abs_err {err} bound {tol}", flush=True)
            if not err <= tol:
                raise AssertionError(f"{name}[{variant}] B={b}: max_abs_err {err} > {tol}")
            table.error(name, err)
            if b == B:
                iters = 10 if name.endswith("block") else 20
                ms, plain_ms = time_pair(
                    torch, lambda: kernel(*args, **kwargs), lambda: twin(*args, **kwargs), iters)
                lib_ms = None if library is None else time_one(torch, library, iters)
                print(f"time {name}[{variant}] B={b}: kernel {ms} ms, plain {plain_ms} ms, "
                      f"bound {max(bound)} ms, library {lib_ms} ms ({card})", flush=True)
                # The GEMM entry sums its four epilogues: one layer's GEMMs.
                table.timed(name, ms, plain_ms, bound, lib_ms)


def slice_phase(torch, np, vb, cli_serve, card: str):
    from dclip_tpu_torch.ops.image_ops import normalize

    args = cli_serve.parse_args([
        "--model_preset", "vit-b-16", "--clip_weights", "random", "--seed", "0",
        "--tokenizer_dir", "hash", "--buckets", "1,4,16,64", "--index_dim", "512",
        "--device", "cuda",
    ])
    t0 = time.perf_counter()
    service = cli_serve.build_service(args)
    print(f"slice: service built in {time.perf_counter() - t0} s", flush=True)
    cfg = service.cfg
    if service.model.dtype != torch.bfloat16:
        raise AssertionError(f"compute dtype {service.model.dtype}, expected bf16 on CUDA")

    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (cfg.vision.image_size,) * 2 + (3,), np.uint8)
              for _ in range(8)]
    vb.reset_launches()
    print("slice: warmup", json.dumps(service.warmup()), f"({card})", flush=True)
    if cli_serve.selftest(service, args) != 0:
        raise AssertionError("serve --selftest failed")
    img = service.encode_images(images)
    txt = service.encode_texts(["a photo of a dog", "a red car", "two cats on a sofa"])
    torch.cuda.synchronize()
    launches = dict(vb.LAUNCHES)

    batches = len(service.buckets) + 1 + 1  # warmup buckets, selftest image, 8 images
    layers = cfg.vision.num_layers
    expected = {
        "layernorm": 2 * layers * batches,
        "gemm_bias_act_residual": 4 * layers * batches,
        "attention": layers * batches,
        "attention_block": layers * batches,
        "mlp_block": layers * batches,
        "encoder_forward": batches,
        "image_features": batches,
    }
    print("slice: launches", json.dumps(launches), "expected", json.dumps(expected), flush=True)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")

    for name, e in (("image", img), ("text", txt)):
        norms = np.linalg.norm(e, axis=-1)
        if e.shape[1] != cfg.projection_dim or not np.isfinite(e).all() \
                or not np.allclose(norms, 1.0, atol=1e-3):
            raise AssertionError(f"{name} embeddings bad: shape {e.shape}, norms {norms}")

    with torch.no_grad():
        w32 = vb.pack_vision_weights(cfg, service.model.state_dict(), torch.float32)
        px = torch.from_numpy(np.stack(images)).to(service.device)
        px = normalize(px.float() / 255.0)
        ref = vb.fused_image_features_reference(cfg, w32, px).float()
        ref = (ref / ref.norm(dim=-1, keepdim=True)).cpu().numpy()
    cos = (img * ref).sum(-1)
    print(f"slice: image cosine bf16 kernels vs f32 twin: min {cos.min()} "
          f"mean {cos.mean()} bound {COS_BOUND}", flush=True)
    if not cos.min() >= COS_BOUND:
        raise AssertionError(f"image cosine {cos.min()} < {COS_BOUND}")
    return service, args, launches


def _bound_check(torch, name, got, want, tol, with_one=True):
    """max |got - want| <= tol * max(1, max |want|) (or tol * max |want|)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    bound = tol * (max(1.0, scale) if with_one else scale)
    print(f"kernel {name}: max_abs_err {err} bound {bound}", flush=True)
    if not err <= bound:
        raise AssertionError(f"{name}: max_abs_err {err} > {bound}")
    return err


def _text_masks(torch, np, dev):
    """The text tower's masks at the training batch: the synthetic batch's
    captions (seed 0), packed (causal + segment ids) and unpacked (causal
    + key padding)."""
    from dclip_tpu_torch.cli.common import synthetic_distill_batch
    from dclip_tpu_torch.core import CLIPConfig, TeacherConfig
    from dclip_tpu_torch.ops.packing import pack_captions

    cfg = CLIPConfig.vit_b_16()
    batch = synthetic_distill_batch(cfg, TeacherConfig(), TRAIN_B, np.random.RandomState(0))
    packed = pack_captions(batch["input_ids"], batch["attention_mask"], cfg.text.eos_token_id)
    seg = torch.from_numpy(packed["packed_segments"]).to(dev)
    pad = torch.from_numpy(batch["attention_mask"]).to(dev)
    return seg, pad, batch


def _keep(torch, b, s, dev, kw):
    """The boolean [B, S, S] of the (query, key) pairs the masks keep, or
    None without masks."""
    if not kw:
        return None
    keep = torch.ones((b, s, s), dtype=torch.bool, device=dev)
    if kw.get("causal"):
        keep &= torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    if kw.get("segment_ids") is not None:
        seg = kw["segment_ids"]
        keep &= seg[:, :, None] == seg[:, None, :]
    if kw.get("padding_mask") is not None:
        keep &= kw["padding_mask"][:, None, :] > 0
    return keep


def train_kernel_phase(torch, np, card: str, table: KernelTable):
    """The training kernels against their twins at the cache-warm step's
    shapes, plus a ragged small case of each; CUDA-event times."""
    from dclip_tpu_torch.kernels import distill_loss as dl
    from dclip_tpu_torch.kernels import mlp_frozen as mf
    from dclip_tpu_torch.kernels import vit_attention as va

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.from_numpy(rng.standard_normal(shape).astype("float32") * scale)
                .to(dev).to(dtype))

    def record(name, err, timed, kernel_fn=None, plain_fn=None, iters=10, variant="",
               bound=(0.0, 0.0), library_fn=None):
        table.error(name, err)
        if timed:
            ms, plain_ms = time_pair(torch, kernel_fn, plain_fn, iters)
            lib_ms = None if library_fn is None else time_one(torch, library_fn, iters)
            print(f"time {name}[{variant}]: kernel {ms} ms, plain {plain_ms} ms, bound "
                  f"{max(bound)} ms, library {lib_ms} ms ({card})", flush=True)
            table.timed(name, ms, plain_ms, bound, lib_ms)

    seg, pad, _ = _text_masks(torch, np, dev)
    attn_cases = [  # (variant, b, s, d, heads, masks, timed)
        ("vision", TRAIN_B, S, D, HEADS, {}, True),
        ("text_packed", seg.shape[0], TEXT_S, TEXT_D, TEXT_HEADS,
         {"causal": True, "segment_ids": seg}, True),
        ("text_unpacked", TRAIN_B, TEXT_S, TEXT_D, TEXT_HEADS,
         {"causal": True, "padding_mask": pad}, True),
        ("ragged", 3, 50, 128, 2, {"padding_mask": (torch.arange(50, device=dev)[None]
                                                     < torch.tensor([[50], [17], [1]],
                                                                    device=dev)).float()}, False),
    ]
    for variant, b, s, d, heads, kw, timed in attn_cases:
        qkv = randn(b, s, 3 * d)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        g = randn(b, s, d)
        keep = _keep(torch, b, s, dev, kw)
        pairs = float(b * s * s if keep is None else keep.sum().item())
        hd = d // heads
        mask_bytes = 4.0 * b * s if kw.get("padding_mask") is not None \
            or kw.get("segment_ids") is not None else 0.0
        io = 2.0 * b * s * d  # one bf16 [B, S, D] tensor
        stats = 8.0 * b * s * heads
        fwd_bound = work(bf16_flops=4.0 * hd * heads * pairs, nbytes=4 * io + mask_bytes + stats)
        fused_bound = work(bf16_flops=4.0 * hd * heads * pairs, nbytes=4 * io + mask_bytes)
        bwd_bound = work(bf16_flops=10.0 * hd * heads * pairs,
                         nbytes=8 * io + stats + mask_bytes)
        o, m, r = va.self_attention_fwd_stats(q, k, v, heads, **kw)
        o_ref, m_ref, r_ref = va.attention_reference(q, k, v, heads, stats=True, **kw)
        err = max(_bound_check(torch, f"attention_fwd[{variant}] o", o, o_ref, REL_TOL),
                  _bound_check(torch, f"attention_fwd[{variant}] m", m, m_ref, REL_TOL))
        # rinv <= 1: held elementwise relative to the twin's.
        rel = ((r - r_ref).abs() / r_ref.abs()).max().item()
        print(f"kernel attention_fwd[{variant}] rinv: max_rel_err {rel} bound {REL_TOL}",
              flush=True)
        if not rel <= REL_TOL:
            raise AssertionError(f"rinv[{variant}] relative error {rel} > {REL_TOL}")
        lib_fwd = sdpa_calls(torch, q, k, v, heads, keep) if timed else None
        record("self_attention_fwd_stats", err, timed,
               lambda: va.self_attention_fwd_stats(q, k, v, heads, **kw),
               lambda: va.attention_reference(q, k, v, heads, stats=True, **kw), 10, variant,
               fwd_bound, lib_fwd)
        o3 = va.self_attention_fused(q, k, v, heads, **kw)
        err3 = _bound_check(torch, f"attention_fused[{variant}]", o3, o_ref, REL_TOL)
        record("self_attention_fused", err3, timed,
               lambda: va.self_attention_fused(q, k, v, heads, **kw),
               lambda: va.attention_reference(q, k, v, heads, **kw), 10, variant,
               fused_bound, lib_fwd)
        grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
        want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw)
        errb = max(_bound_check(torch, f"attention_bwd[{variant}] {n}", a, w, BWD_TOL)
                   for n, a, w in zip(("dq", "dk", "dv"), grads, want))
        record("self_attention_bwd_stats", errb, timed,
               lambda: va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw),
               lambda: va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw),
               5, variant, bwd_bound,
               sdpa_calls(torch, q, k, v, heads, keep, g) if timed else None)
        del qkv, q, k, v, g, o, m, r, o_ref, m_ref, r_ref, grads, want, lib_fwd

    for variant, b, timed in (("vision", TRAIN_B, True), ("ragged", 1, False)):
        mrows = b * S
        lw = layer_weights(rng, torch, dev)
        p = mf.pack_frozen_mlp(lw["ln2_scale"], lw["ln2_bias"], lw["fc1_w"].t(), lw["fc1_b"],
                               lw["fc2_w"].t(), lw["fc2_b"], torch.bfloat16)
        x, g = randn(b, S, D), randn(b, S, D)
        y, a1 = mf.mlp_frozen_fwd(x, p)
        y_ref, a1_ref = mf.mlp_frozen_fwd_reference(x, p)
        err = max(_bound_check(torch, f"mlp_frozen_fwd[{variant}] y", y, y_ref, REL_TOL),
                  _bound_check(torch, f"mlp_frozen_fwd[{variant}] a1", a1, a1_ref, REL_TOL))
        weights = 4.0 * D * MLP + 4.0 * (MLP + 3 * D)
        record("mlp_frozen_fwd", err, timed, lambda: mf.mlp_frozen_fwd(x, p),
               lambda: mf.mlp_frozen_fwd_reference(x, p), 5, variant,
               work(bf16_flops=4.0 * mrows * D * MLP,
                    nbytes=4.0 * mrows * D + 2.0 * mrows * MLP + weights))
        dx = mf.mlp_frozen_bwd(x, g, a1, p)
        errb = _bound_check(torch, f"mlp_frozen_bwd[{variant}] dx", dx,
                            mf.mlp_frozen_bwd_reference(x, g, a1_ref, p), BWD_TOL)
        record("mlp_frozen_bwd", errb, timed, lambda: mf.mlp_frozen_bwd(x, g, a1, p),
               lambda: mf.mlp_frozen_bwd_reference(x, g, a1_ref, p), 5, variant,
               work(bf16_flops=4.0 * mrows * D * MLP,
                    nbytes=6.0 * mrows * D + 2.0 * mrows * MLP + 4.0 * D * MLP + 4.0 * D))
        dh = randn(b, S, D, dtype=torch.float32)
        errl = _bound_check(torch, f"layernorm_bwd[{variant}]",
                            mf.layernorm_bwd(x, g, dh, p["ln2_scale"]),
                            mf.layernorm_bwd_reference(x, g, dh, p["ln2_scale"]), REL_TOL)
        record("layernorm_bwd", errl, timed, lambda: mf.layernorm_bwd(x, g, dh, p["ln2_scale"]),
               lambda: mf.layernorm_bwd_reference(x, g, dh, p["ln2_scale"]), 20, variant,
               work(f32_flops=12.0 * mrows * D, nbytes=10.0 * mrows * D + 4.0 * D))
        del x, g, y, a1, y_ref, a1_ref, dx, dh

    for variant, b, timed in (("b256", TRAIN_B, True), ("ragged", 5, False)):
        d = 512
        si, st = randn(b, d), randn(b, d)
        # Targets correlated with the student rows (cosine ~0.9), so li and
        # lt sit far from 1 and a dropped cosine term moves them.
        ti = si.float() + randn(b, d, scale=0.5, dtype=torch.float32)
        tt = st.float() + randn(b, d, scale=0.5, dtype=torch.float32)
        parts = dl.distill_loss_fwd(si, st, ti, tt)
        want = dl.distill_loss_fwd_reference(si, st, ti, tt)
        torch.cuda.synchronize()
        if not (want[0] < 0.5 and want[1] < 0.5):
            raise AssertionError(f"distill_loss_fwd[{variant}]: li, lt {want[:2].tolist()} "
                                 f"not far from 1")
        # f32 throughout on identical bf16/f32 inputs: only the summation
        # order differs, so each part within DL_RTOL of its twin.
        rel = ((parts - want).abs() / want.abs()).tolist()
        print(f"kernel distill_loss_fwd[{variant}]: parts {parts.tolist()} twin "
              f"{want.tolist()} rel_err {rel} bound {DL_RTOL}", flush=True)
        if parts.shape != want.shape or not all(r <= DL_RTOL for r in rel):
            raise AssertionError(f"distill_loss_fwd[{variant}]: rel_err {rel} > {DL_RTOL}")
        err = (parts - want).abs().max().item()
        inputs = 4.0 * b * d + 8.0 * b * d
        record("distill_loss_fwd", err, timed, lambda: dl.distill_loss_fwd(si, st, ti, tt),
               lambda: dl.distill_loss_fwd_reference(si, st, ti, tt), 20, variant,
               work(f32_flops=2.0 * b * b * d + 10.0 * b * d, nbytes=inputs + 16.0))
        cts = torch.tensor([1.0, 1.0, 1.0], device=dev)
        got = dl.distill_loss_bwd(si, st, ti, tt, cts)
        want = dl.distill_loss_bwd_reference(si, st, ti, tt, cts)
        errb = max(_bound_check(torch, f"distill_loss_bwd[{variant}] {n}", a, w, DL_BWD_TOL,
                                with_one=False)
                   for n, a, w in zip(("dsi", "dst"), got, want))
        record("distill_loss_bwd", errb, timed, lambda: dl.distill_loss_bwd(si, st, ti, tt, cts),
               lambda: dl.distill_loss_bwd_reference(si, st, ti, tt, cts), 20, variant,
               work(f32_flops=6.0 * b * b * d + 20.0 * b * d,
                    nbytes=inputs + 12.0 + 4.0 * b * d))
    torch.cuda.empty_cache()


def _teacher_sd(rng, torch, d, device):
    """Cross-attention weights with 1/sqrt(D) matrices (attention far from
    uniform), non-zero biases and LN affines, in the teacher's names."""
    def n(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype("float32"))

    sd = {}
    for direction in ("text_to_image", "image_to_text"):
        pre = f"cross_modal_attention.{direction}."
        sd[pre + "in_proj_weight"] = n(3 * d, d, scale=d**-0.5)
        sd[pre + "in_proj_bias"] = n(3 * d, scale=0.1)
        sd[pre + "out_proj.weight"] = n(d, d, scale=d**-0.5)
        sd[pre + "out_proj.bias"] = n(d, scale=0.1)
    for norm in ("norm_text", "norm_image"):
        sd[f"cross_modal_attention.{norm}.weight"] = 1.0 + n(d, scale=0.1)
        sd[f"cross_modal_attention.{norm}.bias"] = n(d, scale=0.1)
    return {k: v.to(device) for k, v in sd.items()}


def xattn_kernel_phase(torch, np, card: str, table: KernelTable):
    """K10 at the teacher tail's shapes, its two CUDA kernels, and the
    loader's self-check kernel, against their twins; CUDA-event times."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.kernels import _build
    from dclip_tpu_torch.kernels import cross_attention as xa

    dev = torch.device("cuda")
    rng = np.random.RandomState(3)
    b, t, p, d, heads = TRAIN_B, TEXT_S, TEACHER_P, TEXT_D, TEXT_HEADS
    w = xa.pack_cross_attention(_teacher_sd(rng, torch, d, dev), torch.bfloat16)
    _, _, batch = _text_masks(torch, np, dev)
    ids, am = batch["input_ids"], batch["attention_mask"]
    # The content-token mask of encode_tokens: valid, not BOS, not EOS.
    eos = CLIPConfig.vit_b_16().text.eos_token_id
    tmask_np = (am > 0) & (np.arange(t)[None] > 0) & (ids != eos)
    tmask = torch.from_numpy(tmask_np.astype("float32")).to(dev)
    imask_np = (rng.rand(b, p) > 0.25).astype("float32")
    imask_np[:2] = 0.0  # two images with no valid box
    imask = torch.from_numpy(imask_np).to(dev)
    # bf16-valued f32 inputs zeroed at masked slots, as the trainer gives them.
    text = (torch.from_numpy(rng.standard_normal((b, t, d)).astype("float32")).to(dev)
            .bfloat16().float() * tmask[..., None])
    image = (torch.from_numpy(rng.standard_normal((b, p, d)).astype("float32")).to(dev)
             .bfloat16().float() * imask[..., None])
    rows = b * (t + p)

    got = xa.cross_attention_fused(w, text, image, tmask, imask, heads)
    want = xa.cross_attention_reference(w, text, image, tmask, imask, heads)
    err = max(_bound_check(torch, f"cross_attention[{name}]", g, r, REL_TOL)
              for name, g, r in zip(("text", "image"), got, want))
    if got[0].dtype != torch.float32:
        raise AssertionError(f"cross_attention: f32 inputs gave {got[0].dtype}")
    # The two boxless rows: every text query averages the image values.
    table.error("cross_attention", err)
    gemm_flops = 2.0 * b * (t + p) * d * 3 * d + 2.0 * rows * d * d
    core_flops = 8.0 * b * t * p * d
    bound = work(bf16_flops=gemm_flops, f32_flops=core_flops + 10.0 * rows * d,
                 nbytes=8.0 * rows * d + 4.0 * rows + 2.0 * 8 * d * d + 4.0 * 12 * d)
    ms, plain_ms = time_pair(torch, lambda: xa.cross_attention_fused(w, text, image, tmask,
                                                                      imask, heads),
                             lambda: xa.cross_attention_reference(w, text, image, tmask, imask,
                                                                  heads), 20)
    print(f"time cross_attention: kernel {ms} ms, plain {plain_ms} ms, bound {max(bound)} ms "
          f"({card})", flush=True)
    table.timed("cross_attention", ms, plain_ms, bound)

    qkv_t = (text.bfloat16() @ w["w_text"]).float() + w["b_text"]
    qkv_i = (image.bfloat16() @ w["w_image"]).float() + w["b_image"]
    out = xa.cross_attention_core(qkv_t, qkv_i, tmask, imask, heads)
    ref = xa.cross_attention_core_reference(qkv_t, qkv_i, tmask, imask, heads)
    err = max(_bound_check(torch, f"cross_attention_core[{name}]", g, r, REL_TOL)
              for name, g, r in zip(("text", "image"), out, ref))
    boxless = ref[0][:2]
    uniform = qkv_i[:2, :, 2 * d:].mean(1, keepdim=True).expand_as(boxless)
    _bound_check(torch, "cross_attention_core[boxless rows: uniform average]", out[0][:2],
                 uniform, REL_TOL)
    table.error("cross_attention_core", err)
    bound = work(f32_flops=core_flops, nbytes=12.0 * rows * d + 4.0 * rows + 2.0 * rows * d)
    ms, plain_ms = time_pair(
        torch, lambda: xa.cross_attention_core(qkv_t, qkv_i, tmask, imask, heads),
        lambda: xa.cross_attention_core_reference(qkv_t, qkv_i, tmask, imask, heads), 20)
    print(f"time cross_attention_core: kernel {ms} ms, plain {plain_ms} ms, bound "
          f"{max(bound)} ms ({card})", flush=True)
    table.timed("cross_attention_core", ms, plain_ms, bound)

    a_t = torch.from_numpy(rng.standard_normal((b, t, d)).astype("float32")).to(dev)
    a_i = torch.from_numpy(rng.standard_normal((b, p, d)).astype("float32")).to(dev)
    streams = ((text, a_t), (image, a_i))
    scales, biases = (w["lnt_scale"], w["lni_scale"]), (w["lnt_bias"], w["lni_bias"])
    out = xa.add_layernorm_f32(streams, scales, biases)
    err = max(_bound_check(torch, f"add_layernorm_f32[{i}]", g,
                           xa.add_layernorm_reference(x, a, s, bb), REL_TOL)
              for i, (g, (x, a), s, bb) in enumerate(zip(out, streams, scales, biases)))
    table.error("add_layernorm_f32", err)
    bound = work(f32_flops=10.0 * rows * d, nbytes=12.0 * rows * d + 16.0 * d)
    ms, plain_ms = time_pair(
        torch, lambda: xa.add_layernorm_f32(streams, scales, biases),
        lambda: [xa.add_layernorm_reference(x, a, s, bb)
                 for (x, a), s, bb in zip(streams, scales, biases)], 20)
    print(f"time add_layernorm_f32: kernel {ms} ms, plain {plain_ms} ms, bound {max(bound)} ms "
          f"({card})", flush=True)
    table.timed("add_layernorm_f32", ms, plain_ms, bound)

    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128) * 0.25 - 7.0
    err = (_build.probe_x2(x) - _build.probe_x2_reference(x)).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"loader self-check kernel: max_abs_err {err}")
    table.error("loader_self_check", err)
    bound = work(f32_flops=1024.0, nbytes=8.0 * 1024)
    ms, plain_ms = time_pair(torch, lambda: _build.probe_x2(x),
                             lambda: _build.probe_x2_reference(x), 50)
    print(f"time loader_self_check: kernel {ms} ms, plain {plain_ms} ms, bound {max(bound)} ms "
          f"({card})", flush=True)
    table.timed("loader_self_check", ms, plain_ms, bound)
    torch.cuda.empty_cache()


# -- the training slices --------------------------------------------------------------


def _all_modules():
    from dclip_tpu_torch.kernels import (
        _build,
        attn_block_trainable,
        cross_attention,
        distill_loss,
        mlp_frozen,
        mlp_trainable,
        trainable_ops,
        vit_attention,
        vit_block,
    )

    return (vit_block, vit_attention, mlp_frozen, distill_loss, cross_attention, _build,
            mlp_trainable, attn_block_trainable, trainable_ops)


def _reset_all_launches():
    for mod in _all_modules():
        mod.reset_launches()


def _all_launches():
    out = {}
    for mod in _all_modules():
        out.update(mod.LAUNCHES)
    return out


def _teacher_config():
    from dclip_tpu_torch.core import TeacherConfig

    return TeacherConfig(embed_dim=512, num_heads=TEXT_HEADS, max_patches=TEACHER_P,
                         max_text_tokens=TEXT_S)


def _distill_config(batch_size, **changes):
    import dataclasses

    from dclip_tpu_torch.core import DistillConfig

    return dataclasses.replace(
        DistillConfig(train_batch_size=batch_size, accumulate_grad_batches=1,
                      learning_rate=1e-4, student_model="vit-b-16",
                      teacher_clip_model="vit-b-16", packed_text=True,
                      teacher=_teacher_config()), **changes)


def _batch(np, batch_size):
    from dclip_tpu_torch.cli.common import synthetic_distill_batch
    from dclip_tpu_torch.core import CLIPConfig

    batch = synthetic_distill_batch(CLIPConfig.vit_b_16(), _teacher_config(), batch_size,
                                    np.random.RandomState(0))
    batch["index"] = np.arange(batch_size, dtype=np.int64)
    return batch


def _distill_trainer(torch, np, sd, tsd, device, batch_size, **changes):
    """The port's DistillTrainer at ViT-B/16 with the batch's full teacher
    targets (seeded unit vectors) in an in-memory cache."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = CLIPConfig.vit_b_16()
    batch = _batch(np, batch_size)
    targets = np.random.RandomState(2).standard_normal(
        (batch_size, 2, cfg.projection_dim)).astype(np.float32)
    targets /= np.linalg.norm(targets, axis=-1, keepdims=True)
    cache = TeacherTargetCache(salt="chip-smoke")  # a salt: no teacher fingerprint pass
    trainer = DistillTrainer(_distill_config(batch_size, **changes), sd, sd, tsd, cfg, cfg,
                             device=device, teacher_cache=cache)
    cache.put_batch(cache.keys_for(batch), targets)
    return trainer, batch


def _student_per_step(trainer):
    v, t = trainer.student_config.vision.num_layers, trainer.student_config.text.num_layers
    return {"layernorm": v, "gemm_bias_act_residual": 4 * v,
            "self_attention_fwd_stats": v + t, "self_attention_bwd_stats": v + t,
            "mlp_frozen_fwd": v, "mlp_frozen_bwd": v, "layernorm_bwd": v,
            "distill_loss_fwd": 1, "distill_loss_bwd": 1}


def _expected(per_step, steps):
    names = _all_launches()
    return {k: per_step.get(k, 0) * steps for k in names}


def _run_steps(torch, np, trainer, batch, what, card):
    """Warm-up steps, then timed steps on the host clock ending in a
    synchronize; CUDA events between steps give each step's span on the
    device clock without a host synchronize."""
    losses = []
    for _ in range(WARMUP_STEPS):
        losses.append(trainer.train_step_on_batch(batch)["loss"])
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(TIMED_STEPS):
        losses.append(trainer.train_step_on_batch(batch)["loss"])
        marks[i + 1].record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_step = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    print(f"{what}: per-step ms (device clock between steps) {json.dumps(per_step)}; "
          f"{gpu_state()}", flush=True)
    losses = [float(x) for x in losses]
    print(f"{what}: losses", json.dumps(losses), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: training loss not finite and falling: {losses}")
    ms = 1000.0 * seconds / TIMED_STEPS
    print(f"{what}: step {ms} ms, {TRAIN_B * TIMED_STEPS / seconds} images/s (B={TRAIN_B}, "
          f"{TIMED_STEPS} steps after {WARMUP_STEPS} warm-up; {card})", flush=True)
    return ms


def train_slice_phase(torch, np, sd, tsd, card: str):
    """The cache-warm B/16 training step at B=256 on the card."""
    trainer, batch = _distill_trainer(torch, np, sd, tsd, "cuda", TRAIN_B)
    student = trainer.student
    if student.dtype != torch.bfloat16 or not trainer._use_kernels or not trainer._packed_text:
        raise AssertionError("expected bf16, kernels on and packed text on CUDA")
    steps = WARMUP_STEPS + TIMED_STEPS
    _reset_all_launches()
    ms = _run_steps(torch, np, trainer, batch, "train cache-warm", card)
    launches = _all_launches()
    if trainer._dev_full.hits != steps - 1:
        raise AssertionError(f"device target cache hits {trainer._dev_full.hits}, "
                             f"expected {steps - 1} (the first step hits the host cache)")
    expected = _expected(_student_per_step(trainer), steps)
    print("train: launches", json.dumps(launches), "expected", json.dumps(expected), flush=True)
    if launches != expected:
        raise AssertionError(f"training launch counts {launches} != {expected}")
    print(f"train: peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB",
          flush=True)

    # One no-grad packed text encode: the stats-free attention mode.
    t = trainer.student_config.text.num_layers
    sb = trainer._maybe_pack_text(batch, {})
    keys = ("packed_ids", "packed_segments", "packed_positions", "packed_eos_rows",
            "packed_eos_cols")
    _reset_all_launches()
    with torch.no_grad():
        emb = student.get_packed_text_features(*(sb[k] for k in keys))
    torch.cuda.synchronize()
    text_launches = _all_launches()
    print(f"train: no-grad packed text encode of {sb['packed_ids'].shape[0]} rows, launches "
          f"{json.dumps(text_launches)}", flush=True)
    if text_launches["self_attention_fused"] != t or text_launches["self_attention_fwd_stats"] \
            or not torch.isfinite(emb.float()).all() or emb.shape != (TRAIN_B, 512):
        raise AssertionError(f"no-grad text encode: launches {text_launches}, {emb.shape}")
    launches["self_attention_fused"] = text_launches["self_attention_fused"]

    profile_steps(torch, trainer, batch, card)
    del trainer
    torch.cuda.empty_cache()
    return launches, ms


def _uncached_per_step(trainer):
    """Launches of one uncached step: the region encode over B x P crops
    (12 layers of K1 + K2), the teacher text tower (K3 x 12), K10 (4
    GEMMs, its core, its add + LayerNorm), then the student step."""
    v = trainer.teacher_clip_config.vision.num_layers
    t = trainer.teacher_clip_config.text.num_layers
    per = _student_per_step(trainer)
    per.update({
        "layernorm": per["layernorm"] + 2 * v,
        "gemm_bias_act_residual": per["gemm_bias_act_residual"] + 4 * v + 4,
        "attention": v, "attention_block": v, "mlp_block": v,
        "encoder_forward": 1, "image_features": 1,
        "self_attention_fused": t,
        "cross_attention_core": 1, "add_layernorm_f32": 1, "cross_attention": 1,
    })
    return per


def uncached_slice_phase(torch, np, sd, tsd, card: str):
    """The uncached B/16 step at B=256, P=8 on the card: the main path."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    cfg = CLIPConfig.vit_b_16()
    trainer = DistillTrainer(_distill_config(TRAIN_B), sd, sd, tsd, cfg, cfg, device="cuda",
                             teacher_cache=None)
    if trainer._xattn is None or trainer._teacher_image_features is None \
            or not trainer._compact:
        raise AssertionError("expected the teacher kernels and crop compaction on CUDA")
    batch = _batch(np, TRAIN_B)
    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    ms = _run_steps(torch, np, trainer, batch, "uncached", card)
    launches = _all_launches()
    expected = _expected(_uncached_per_step(trainer), steps)
    print("uncached: launches", json.dumps(launches), "expected", json.dumps(expected),
          flush=True)
    if launches != expected:
        raise AssertionError(f"uncached launch counts {launches} != {expected}")
    print(f"uncached: peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB "
          f"({card})", flush=True)
    profile_steps(torch, trainer, batch, card, steps=1,
                  spans=("dclip.h2d", "dclip.crop", "dclip.region_encode", "dclip.teacher_text",
                         "dclip.cross_attention", "dclip.student_step"))
    del trainer
    torch.cuda.empty_cache()
    return launches, ms


def cache_levels_phase(torch, np, sd, tsd, card: str):
    """A teacher cache's three levels, told apart by their launches."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = CLIPConfig.vit_b_16()
    cache = TeacherTargetCache()
    trainer = DistillTrainer(_distill_config(TRAIN_B), sd, sd, tsd, cfg, cfg, device="cuda",
                             teacher_cache=cache)
    batch = _batch(np, TRAIN_B)
    resampled = dict(batch, input_ids=np.roll(batch["input_ids"], 1, axis=0),
                     attention_mask=np.roll(batch["attention_mask"], 1, axis=0))
    t = cfg.text.num_layers
    cases = [  # what, batch, attention_block, self_attention_fused, cross_attention
        ("miss: every level filled", batch, cfg.vision.num_layers, t, 1),
        ("repeat: device full-target hit", batch, 0, 0, 0),
        ("resampled captions: device pe hit", resampled, 0, t, 1),
    ]
    for what, b, k1, k3, k10 in cases:
        _reset_all_launches()
        loss = trainer.train_step_on_batch(b)["loss"]
        torch.cuda.synchronize()
        n = _all_launches()
        got = (n["attention_block"], n["mlp_block"], n["self_attention_fused"],
               n["cross_attention"])
        print(f"levels: {what}: K1 {got[0]}, K2 {got[1]}, K3 {got[2]}, K10 {got[3]}, loss "
              f"{float(loss)}, device full hits {trainer._dev_full.hits}, pe hits "
              f"{trainer._dev_pe.hits}", flush=True)
        if got != (k1, k1, k3, k10) or not np.isfinite(float(loss)):
            raise AssertionError(f"cache level '{what}': launches {got} != {(k1, k1, k3, k10)}")
    if trainer._dev_full.hits != 1 or trainer._dev_pe.hits != 1:
        raise AssertionError(f"cache hits: full {trainer._dev_full.hits}, pe "
                             f"{trainer._dev_pe.hits}; expected 1 and 1")
    del trainer
    torch.cuda.empty_cache()


def target_agreement_phase(torch, np, sd, tsd):
    """Teacher targets at B=2, full width and depth: bf16 kernels on the card
    vs the f32 modules on the CPU, on the same weights."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    cfg = CLIPConfig.vit_b_16()
    batch = _batch(np, AGREE_B)
    batch["box_mask"][1, 5:] = 0.0
    targets = {}
    for device, changes in (("cuda", {}),
                            ("cpu", {"use_pallas": False, "compute_dtype": "float32"})):
        trainer = DistillTrainer(_distill_config(AGREE_B, **changes), sd, sd, tsd, cfg, cfg,
                                 device=device)
        t0 = time.perf_counter()
        got = trainer._teacher_targets(trainer._device_batch(batch))
        targets[device] = [x.double().cpu() for x in got]
        print(f"targets: {device} ({'kernels, bf16' if device == 'cuda' else 'modules, f32'}) "
              f"{time.perf_counter() - t0} s", flush=True)
        del trainer
    for name, a, b in zip(("teacher_img", "teacher_txt"), targets["cuda"], targets["cpu"]):
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        print(f"targets: {name} per-row cosine {cos.tolist()} bound {TARGET_COS}", flush=True)
        if not torch.isfinite(a).all() or not cos.min().item() >= TARGET_COS:
            raise AssertionError(f"{name}: cosine {cos.tolist()} < {TARGET_COS}")
    torch.cuda.empty_cache()


def profile_steps(torch, trainer, batch, card: str, steps: int = 2, spans=()):
    """Device busy share and device time by kernel over `steps` steps, and
    the device time under each of `spans` (torch.profiler ranges)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step_on_batch(batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # Device-side events only (kernels, copies): the host-side rows of
    # key_averages() also carry their children's device time, and the
    # device-side rows of the `dclip.*` ranges span their kernels.
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == cuda and e.self_device_time_total > 0
            and not e.key.startswith("dclip.")]
    device_us = sum(r[1] for r in rows)
    if device_us == 0:
        print("profile: key_averages() show no device time", flush=True)
        return
    print(f"profile: {steps} steps, wall {wall_us / 1e3} ms, device {device_us / 1e3} ms, "
          f"busy {100.0 * device_us / wall_us}% ({card})", flush=True)
    for name in spans:
        dev = [e for e in events if e.key == name and e.device_type == cuda]
        host = [e for e in events if e.key == name and e.device_type != cuda]
        dev_ms = sum(e.device_time_total for e in dev) / 1e3 / steps
        host_ms = sum(e.cpu_time_total for e in host) / 1e3 / steps
        print(f"profile: stage {name}: device span {dev_ms} ms/step "
              f"({100.0 * dev_ms * steps * 1e3 / wall_us:.2f}% of the wall), host "
              f"{host_ms} ms/step", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"profile: {100.0 * us / device_us:6.2f}% {us / 1e3 / steps:9.3f} ms/step "
              f"x{count // steps:<5d} {key[:110]}", flush=True)


def grad_agreement_phase(torch, np, sd, tsd, what="grads", must_hold=(), **changes):
    """One step's trainable gradients, B=8: bf16 kernels on the card vs
    f32 twins on the CPU. `changes` go to the DistillConfig; the trainer
    enters epoch 0 first (its unfreeze stages at epoch 0 apply); each of
    `must_hold` must name some held tensor."""
    grads = {}
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        trainer, batch = _distill_trainer(torch, np, sd, tsd, device, GRAD_B,
                                          compute_dtype=dtype, use_pallas=True, **changes)
        trainer._on_epoch_start(0)
        t0 = time.perf_counter()
        trainer.train_step_on_batch(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"{what}: {device} {dtype} step {time.perf_counter() - t0} s", flush=True)
        grads[device] = {n: (torch.zeros_like(p) if p.grad is None else p.grad).double().cpu()
                         for n, p in trainer.student.named_parameters() if p.requires_grad}
        del trainer
    # k_proj.bias: its gradient is zero in exact arithmetic (a key bias adds
    # q . b_k to every logit of a row, and softmax ignores a per-row shift),
    # so both sides hold rounding noise there; it counts in the global
    # cosine, and its norm is held below GRAD_NOISE_RATIO of the layer's
    # q_proj.bias gradient on both sides.
    dot = na = nb = 0.0
    cos = {}
    for name, a in grads["cuda"].items():
        b = grads["cpu"][name]
        dot += float((a * b).sum())
        na += float((a * a).sum())
        nb += float((b * b).sum())
        if float(b.abs().max()) == 0.0 and float(a.abs().max()) == 0.0:
            continue  # a leaf the loss does not reach (logit_scale)
        cos[name] = float((a * b).sum() / (a.norm() * b.norm()))
    glob = dot / (na ** 0.5 * nb ** 0.5)
    noise = sorted(n for n in cos if n.endswith("self_attn.k_proj.bias"))
    held = {n: c for n, c in cos.items() if n not in noise}
    worst_name = min(held, key=held.get)
    ratio = max(float(grads[d][n].norm() / grads[d][n.replace("k_proj", "q_proj")].norm())
                for n in noise for d in ("cuda", "cpu"))
    lowest = sorted(held.items(), key=lambda kv: kv[1])[:5]
    for pattern in must_hold:
        if not any(pattern in n for n in held):
            raise AssertionError(f"{what}: no held gradient matches {pattern!r}")
    print(f"{what}: {len(grads['cuda'])} trainable tensors, global cosine {glob}, min cosine "
          f"{held[worst_name]} ({worst_name}); lowest {json.dumps(lowest)}; "
          f"{len(held)} held, {len(noise)} k_proj.bias (max |g| / |g q_proj.bias| {ratio}), "
          f"{len(grads['cuda']) - len(cos)} all-zero (logit_scale); bounds {GRAD_COS_GLOBAL} / "
          f"{GRAD_COS_TENSOR}, noise ratio {GRAD_NOISE_RATIO}", flush=True)
    if not (glob >= GRAD_COS_GLOBAL and held[worst_name] >= GRAD_COS_TENSOR
            and ratio < GRAD_NOISE_RATIO):
        raise AssertionError(f"{what} agreement: global {glob}, min {held[worst_name]} "
                             f"({worst_name}), k_proj.bias noise ratio {ratio}")


# -- the fused-trainable configuration (K8, K9), K7 at L/14, fit and resume -------------


def trainable_kernel_phase(torch, np, card: str, table: KernelTable):
    """K8 and K9 at the fused step's shapes and a ragged small case, their
    CUDA parts, against their f32 twins; CUDA-event times in turns."""
    from dclip_tpu_torch.kernels import attn_block_trainable as ab
    from dclip_tpu_torch.kernels import mlp_trainable as mt
    from dclip_tpu_torch.kernels import trainable_ops as to
    from dclip_tpu_torch.kernels import vit_attention as va
    from dclip_tpu_torch.kernels import vit_block as vb

    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    F = torch.nn.functional

    def randn(*shape, base=0.0, scale=1.0, dtype=torch.bfloat16):
        t = base + scale * rng.standard_normal(shape).astype("float32")
        return torch.from_numpy(t.astype("float32")).to(dev).to(dtype)

    def f32(*shape, base=0.0, scale=1.0):
        return randn(*shape, base=base, scale=scale, dtype=torch.float32)

    def timed(name, variant, kernel_fn, plain_fn, iters, bound, library_fn=None, lib_note=""):
        ms, plain_ms = time_pair(torch, kernel_fn, plain_fn, iters)
        lib_ms = None if library_fn is None else time_one(torch, library_fn, iters)
        print(f"time {name}[{variant}]: kernel {ms} ms, plain {plain_ms} ms, bound {max(bound)} "
              f"ms, library {lib_ms} ms{lib_note} ({card})", flush=True)
        table.timed(name, ms, plain_ms, bound, lib_ms)

    def sum_check(name, got, want):
        return _bound_check(torch, name, got, want, SUM_TOL)

    def tn_work(rows, p, q):
        return work(bf16_flops=2.0 * rows * p * q, nbytes=2.0 * rows * (p + q) + 4.0 * p * q)

    def colsum_work(rows, n):
        return work(f32_flops=1.0 * rows * n, nbytes=2.0 * rows * n + 4.0 * n)

    def lnw_work(rows, d):
        return work(f32_flops=14.0 * rows * d, nbytes=10.0 * rows * d + 12.0 * d)

    seg, _, _ = _text_masks(torch, np, dev)
    text_rows = seg.shape[0]
    for variant, (b, s, d, mlp), timed_case in (
            ("text_packed", (text_rows, TEXT_S, TEXT_D, TEXT_MLP), True),
            ("ragged", (3, 50, 128, 256), False)):
        m = b * s
        weights = [f32(d, base=1.0, scale=0.1), f32(d, scale=0.1), f32(mlp, d, scale=d**-0.5),
                   f32(mlp, scale=0.1), f32(d, mlp, scale=mlp**-0.5), f32(d, scale=0.1)]
        x, g = randn(b, s, d), randn(b, s, d)
        p = mt.pack_trainable_mlp(*weights, dtype=torch.bfloat16)
        y, a1, h, act = mt.mlp_trainable_fwd(x, p)
        y_ref, a1_ref = mt.mlp_trainable_fwd_reference(x, *weights)
        table.error("mlp_trainable_fwd", max(
            _bound_check(torch, f"mlp_trainable_fwd[{variant}] y", y, y_ref, REL_TOL),
            _bound_check(torch, f"mlp_trainable_fwd[{variant}] a1", a1, a1_ref, REL_TOL)))
        grads = mt.mlp_trainable_bwd(x, g, a1, h, act, p)
        want = mt.mlp_trainable_bwd_reference(x, g, a1_ref, *weights)
        names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
        table.error("mlp_trainable_bwd", max(
            _bound_check(torch, f"mlp_trainable_bwd[{variant}] {n}", a, w, BWD_TOL)
            for n, a, w in zip(names, grads, want)))
        # Its CUDA parts on the same operands.
        nt_cases = [("fc1+gelu", (h, p["w1"], p["b1"]), {"gelu": True, "save_preact": True},
                     gemm_work(m, d, mlp, 1)),
                    ("fc2+residual", (act, p["w2"], p["b2"]), {"residual": x},
                     gemm_work(m, mlp, d, 1))]
        da1 = vb.gemm_bias_act_residual(g, p["w2"], dgelu_of=a1)
        dh = f32(b, s, d)
        tn_cases = [("dw2", (g, act), tn_work(m, d, mlp)), ("dw1", (da1, h), tn_work(m, mlp, d))]
        cs_cases = [("db2", g, colsum_work(m, d)), ("db1", da1, colsum_work(m, mlp))]
        _trainable_parts(torch, to, table, timed, sum_check, variant, timed_case, nt_cases,
                         tn_cases, cs_cases, (x, g, dh, p["ln_scale"]), lnw_work(m, d))
        if timed_case:
            w_bytes = 8.0 * d * mlp + 4.0 * (mlp + 3 * d)
            timed("mlp_trainable_fwd", variant, lambda: mt.mlp_trainable_fwd(x, p),
                  lambda: mt.mlp_trainable_fwd_reference(x, *weights), 5,
                  work(bf16_flops=4.0 * m * d * mlp,
                       nbytes=4.0 * m * d + 2.0 * m * mlp + w_bytes))
            timed("mlp_trainable_bwd", variant, lambda: mt.mlp_trainable_bwd(x, g, a1, h, act, p),
                  lambda: mt.mlp_trainable_bwd_reference(x, g, a1_ref, *weights), 5,
                  work(bf16_flops=8.0 * m * d * mlp,
                       nbytes=6.0 * m * d + 2.0 * m * mlp + 2 * w_bytes))
        del x, g, y, a1, h, act, y_ref, a1_ref, grads, want, da1, dh

    for variant, (b, s, d, heads), timed_case in (("vision", (TRAIN_B, S, D, HEADS), True),
                                                  ("ragged", (3, 50, 128, 2), False)):
        m = b * s
        weights = [f32(d, base=1.0, scale=0.1), f32(d, scale=0.1)]
        for _ in range(4):
            weights += [f32(d, d, scale=d**-0.5), f32(d, scale=0.1)]
        x, g = randn(b, s, d), randn(b, s, d)
        p = ab.pack_trainable_attn(*weights, dtype=torch.bfloat16)
        o, h, qkv, attn, mx, r = ab.attention_block_trainable_fwd(x, p, heads)
        want = ab.attention_block_trainable_fwd_reference(x, *weights, heads)
        err = max(_bound_check(torch, f"attn_block_trainable_fwd[{variant}] {n}", a, w, REL_TOL)
                  for n, a, w in zip(("o", "q", "k", "v", "attn", "m"),
                                     (o, *qkv.split(d, -1), attn, mx), want))
        # rinv: its logits come from bf16 q and k here and from f32 ones in
        # the twin, and a logit's rounding error grows with its size: held
        # relative to the twin's at the backward bound.
        rel = ((r - want[6]).abs() / want[6].abs()).max().item()
        print(f"kernel attn_block_trainable_fwd[{variant}] rinv: max_rel_err {rel} bound "
              f"{BWD_TOL}", flush=True)
        if not rel <= BWD_TOL:
            raise AssertionError(f"attn_block_trainable_fwd[{variant}] rinv: {rel} > {BWD_TOL}")
        table.error("attn_block_trainable_fwd", err)
        grads = ab.attention_block_trainable_bwd(x, g, h, qkv, attn, mx, r, p, heads)
        wgrads = ab.attention_block_trainable_bwd_reference(x, g, *want[1:], *weights, heads)
        names = ("dx", "dln_scale", "dln_bias", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
                 "dbo")
        errs = []
        for n, a, w in zip(names, grads, wgrads):
            if n == "dbk":
                # 0 in exact arithmetic (softmax ignores a per-row shift):
                # both sides hold rounding noise of the row sum, held to the
                # backward bound on the scale of its sibling dbq.
                e = (a - w).abs().max().item()
                bound = BWD_TOL * wgrads[4].abs().max().item()
                print(f"kernel attn_block_trainable_bwd[{variant}] dbk: max_abs_err {e} bound "
                      f"{bound} (scale of dbq)", flush=True)
                if not e <= bound:
                    raise AssertionError(f"attn_block_trainable_bwd[{variant}] dbk: {e} > {bound}")
            else:
                errs.append(_bound_check(torch, f"attn_block_trainable_bwd[{variant}] {n}", a, w,
                                         BWD_TOL))
        table.error("attn_block_trainable_bwd", max(errs))
        ga = vb.gemm_bias_act_residual(g, p["wo"])
        dqkv = torch.empty_like(qkv)
        va.self_attention_bwd_stats(*qkv.split(d, -1), ga, attn, mx, r, heads,
                                    out=dqkv.split(d, -1))
        dh = f32(b, s, d)
        nt_cases = [("qkv", (h, p["wqkv"], p["bqkv"]), {}, gemm_work(m, d, 3 * d)),
                    ("out_proj+residual", (attn, p["wo"], p["bo"]), {"residual": x},
                     gemm_work(m, d, d, 1))]
        tn_cases = [("dwqkv", (dqkv, h), tn_work(m, 3 * d, d)), ("dwo", (g, attn), tn_work(m, d, d))]
        cs_cases = [("dbqkv", dqkv, colsum_work(m, 3 * d)), ("dbo", g, colsum_work(m, d))]
        _trainable_parts(torch, to, table, timed, sum_check, variant, timed_case, nt_cases,
                         tn_cases, cs_cases, (x, g, dh, p["ln_scale"]), lnw_work(m, d))
        if timed_case:
            h2 = h.reshape(m, d)
            bias = p["bqkv"].to(torch.bfloat16)
            lib = time_one(torch, lambda: F.linear(h2, p["wqkv"], bias), 10)
            print(f"time gemm_nt[qkv] yardstick: F.linear on the same operands (bf16 bias) "
                  f"{lib} ms ({card})", flush=True)
            attn_flops = 4.0 * b * heads * s * s * (d // heads)
            w_bytes = 16.0 * d * d + 24.0 * d
            timed("attn_block_trainable_fwd", variant,
                  lambda: ab.attention_block_trainable_fwd(x, p, heads),
                  lambda: ab.attention_block_trainable_fwd_reference(x, *weights, heads), 3,
                  work(bf16_flops=8.0 * m * d * d + attn_flops,
                       nbytes=12.0 * m * d + 8.0 * m * heads + w_bytes))
            timed("attn_block_trainable_bwd", variant,
                  lambda: ab.attention_block_trainable_bwd(x, g, h, qkv, attn, mx, r, p, heads),
                  lambda: ab.attention_block_trainable_bwd_reference(x, g, *want[1:], *weights,
                                                                     heads), 2,
                  work(bf16_flops=16.0 * m * d * d + 2.5 * attn_flops,
                       nbytes=14.0 * m * d + 8.0 * m * heads + 2 * w_bytes))
        del x, g, o, h, qkv, attn, mx, r, want, grads, wgrads, ga, dqkv, dh
    torch.cuda.empty_cache()


def _trainable_parts(torch, to, table, timed, sum_check, variant, timed_case, nt_cases, tn_cases,
                     cs_cases, ln_args, ln_bound):
    """The GEMM's NT and TN modes, the column sums and the LayerNorm
    weight-gradient backward on one block's operands, against their twins."""
    for what, args, kw, bound in nt_cases:
        got, want = to.gemm_nt(*args, **kw), to.gemm_nt_reference(*args, **kw)
        pairs = zip(got, want) if kw.get("save_preact") else ((got, want),)
        table.error("gemm_nt", max(_bound_check(torch, f"gemm_nt[{variant} {what}]", a, w,
                                                REL_TOL) for a, w in pairs))
        if timed_case:
            timed("gemm_nt", f"{variant} {what}", lambda: to.gemm_nt(*args, **kw),
                  lambda: to.gemm_nt_reference(*args, **kw), 10, bound)
    for what, (xa, ya), bound in tn_cases:
        got = to.gemm_tn(xa, ya)
        table.error("gemm_tn", sum_check(f"gemm_tn[{variant} {what}]", got,
                                         to.gemm_tn_reference(xa, ya)))
        if not torch.equal(got, to.gemm_tn(xa, ya)):
            raise AssertionError(f"gemm_tn[{variant} {what}]: two runs differ")
        if timed_case:
            x2, y2 = xa.reshape(-1, xa.shape[-1]), ya.reshape(-1, ya.shape[-1])
            timed("gemm_tn", f"{variant} {what}", lambda: to.gemm_tn(xa, ya),
                  lambda: to.gemm_tn_reference(xa, ya), 10, bound,
                  lambda: torch.matmul(x2.t(), y2), " (torch.matmul, bf16 out)")
    for what, xa, bound in cs_cases:
        table.error("colsum", sum_check(f"colsum[{variant} {what}]", to.colsum(xa),
                                        to.colsum_reference(xa)))
        if timed_case:
            x2 = xa.reshape(-1, xa.shape[-1])
            timed("colsum", f"{variant} {what}", lambda: to.colsum(xa),
                  lambda: to.colsum_reference(xa), 20, bound,
                  lambda: x2.sum(0, dtype=torch.float32), " (Tensor.sum)")
    x, g, dh, scale = ln_args
    got = to.layernorm_bwd_wgrad(x, g, dh, scale)
    want = to.layernorm_bwd_wgrad_reference(x, g, dh, scale)
    err = max(_bound_check(torch, f"layernorm_bwd_wgrad[{variant}] dx", got[0], want[0], REL_TOL),
              sum_check(f"layernorm_bwd_wgrad[{variant}] dscale", got[1], want[1]),
              sum_check(f"layernorm_bwd_wgrad[{variant}] dbias", got[2], want[2]))
    table.error("layernorm_bwd_wgrad", err)
    if timed_case:
        timed("layernorm_bwd_wgrad", variant, lambda: to.layernorm_bwd_wgrad(x, g, dh, scale),
              lambda: to.layernorm_bwd_wgrad_reference(x, g, dh, scale), 20, ln_bound)


def l14_frozen_mlp_phase(torch, np, card: str):
    """K7's proof: the port's K6 (its GEMMs tile at every width) at ViT-L/14
    widths, forward (y, a1) and dx against the twin, timed with its bound.
    Printed only: L/14 is not on this slice's path, so it adds nothing to
    the kernel table's K6 rows."""
    from dclip_tpu_torch.kernels import mlp_frozen as mf

    dev = torch.device("cuda")
    rng = np.random.RandomState(14)
    b, s, d, mlp = L14_B, L14_S, L14_D, L14_MLP

    def randn(*shape, base=0.0, scale=1.0, dtype=torch.float32):
        t = (base + scale * rng.standard_normal(shape)).astype("float32")
        return torch.from_numpy(t).to(dev).to(dtype)

    p = mf.pack_frozen_mlp(randn(d, base=1.0, scale=0.1), randn(d, scale=0.1),
                           randn(mlp, d, scale=d**-0.5), randn(mlp, scale=0.1),
                           randn(d, mlp, scale=mlp**-0.5), randn(d, scale=0.1), torch.bfloat16)
    x, g = randn(b, s, d, dtype=torch.bfloat16), randn(b, s, d, dtype=torch.bfloat16)
    y, a1 = mf.mlp_frozen_fwd(x, p)
    y_ref, a1_ref = mf.mlp_frozen_fwd_reference(x, p)
    _bound_check(torch, "k7_l14 mlp_frozen_fwd y", y, y_ref, REL_TOL)
    _bound_check(torch, "k7_l14 mlp_frozen_fwd a1", a1, a1_ref, REL_TOL)
    dx = mf.mlp_frozen_bwd(x, g, a1, p)
    _bound_check(torch, "k7_l14 mlp_frozen_bwd dx", dx, mf.mlp_frozen_bwd_reference(x, g, a1_ref, p),
                 BWD_TOL)
    m = b * s
    weights = 4.0 * d * mlp + 4.0 * (mlp + 3 * d)
    for name, kernel_fn, plain_fn, bound in (
            ("mlp_frozen_fwd", lambda: mf.mlp_frozen_fwd(x, p),
             lambda: mf.mlp_frozen_fwd_reference(x, p),
             work(bf16_flops=4.0 * m * d * mlp, nbytes=4.0 * m * d + 2.0 * m * mlp + weights)),
            ("mlp_frozen_bwd", lambda: mf.mlp_frozen_bwd(x, g, a1, p),
             lambda: mf.mlp_frozen_bwd_reference(x, g, a1_ref, p),
             work(bf16_flops=4.0 * m * d * mlp,
                  nbytes=6.0 * m * d + 2.0 * m * mlp + 4.0 * d * mlp + 4.0 * d))):
        ms, plain_ms = time_pair(torch, kernel_fn, plain_fn, 5)
        print(f"time k7_l14 {name}[{b}x{s}x{d}, mlp {mlp}]: kernel {ms} ms, plain {plain_ms} ms, "
              f"bound {max(bound)} ms ({'operations' if bound[0] >= bound[1] else 'bytes'}) "
              f"({card})", flush=True)
    del x, g, y, a1, y_ref, a1_ref, dx, p
    torch.cuda.empty_cache()


def _fused_changes(**more):
    return dict(fused_text_mlp=True, fused_attn_block=True, **more)


def _fused_per_step(trainer):
    """Launches of one fused step by the skip rules of
    `kernels/{mlp_trainable,attn_block_trainable}.py`, read off the
    student's current flags and trainable mask: a weight that needs no
    gradient gets no weight-gradient launch, and a block whose input and
    LayerNorm need none (the first vision layer, behind frozen embeddings)
    runs neither its dh product nor its LayerNorm backward."""
    per: dict = {"distill_loss_fwd": 1, "distill_loss_bwd": 1}

    def add(name, n=1):
        per[name] = per.get(name, 0) + n

    def trains(*params):
        return any(p.requires_grad for p in params)

    vision = trainer.student.vision_model
    x_grad = trains(*vision.embeddings.parameters(), *vision.pre_layrnorm.parameters())
    for layer in vision.encoder.layers:
        attn, ln1 = layer.self_attn, layer.layer_norm1
        if not layer.fused_trainable_attn_block:
            raise AssertionError("fused configuration: a vision layer without K9")
        add("layernorm"), add("gemm_nt", 2), add("self_attention_fwd_stats")
        add("attn_block_trainable_fwd"), add("attn_block_trainable_bwd")
        add("gemm_bias_act_residual"), add("self_attention_bwd_stats")  # g Wo, K5
        add("gemm_tn", trains(attn.out_proj.weight)), add("colsum", trains(attn.out_proj.bias))
        add("gemm_tn", trains(*(getattr(attn, n).weight for n in ("q_proj", "k_proj", "v_proj"))))
        add("colsum", trains(*(getattr(attn, n).bias for n in ("q_proj", "k_proj", "v_proj"))))
        if x_grad or trains(*ln1.parameters()):
            add("gemm_bias_act_residual")
            add("layernorm_bwd_wgrad" if trains(*ln1.parameters()) else "layernorm_bwd")
        if layer.fused_frozen_mlp:  # K6
            add("layernorm"), add("gemm_bias_act_residual", 4), add("layernorm_bwd")
            add("mlp_frozen_fwd"), add("mlp_frozen_bwd")
        x_grad = x_grad or trains(*layer.parameters())
    text = trainer.student.text_model
    for layer in text.encoder.layers:
        if not layer.fused_trainable_mlp:
            raise AssertionError("fused configuration: a text layer without K8")
        ln2, mlp = layer.layer_norm2, layer.mlp
        add("self_attention_fwd_stats"), add("self_attention_bwd_stats")
        add("layernorm"), add("gemm_nt", 2), add("mlp_trainable_fwd"), add("mlp_trainable_bwd")
        add("gemm_bias_act_residual", 2)  # da1, dh (the text input always trains here)
        add("layernorm_bwd_wgrad" if trains(*ln2.parameters()) else "layernorm_bwd")
        add("gemm_tn", trains(mlp.fc1.weight) + trains(mlp.fc2.weight))
        add("colsum", trains(mlp.fc1.bias) + trains(mlp.fc2.bias))
    return per


def fused_slice_phase(torch, np, sd, tsd, card: str, default_ms: float):
    """The cache-warm B/16 step at B=256 with K8 and K9 on, beside the
    default configuration's step of phase 8."""
    trainer, batch = _distill_trainer(torch, np, sd, tsd, "cuda", TRAIN_B, **_fused_changes())
    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    ms = _run_steps(torch, np, trainer, batch, "fused cache-warm", card)
    launches = _all_launches()
    expected = _expected(_fused_per_step(trainer), steps)
    print("fused: launches", json.dumps(launches), "expected", json.dumps(expected), flush=True)
    if launches != expected:
        raise AssertionError(f"fused launch counts {launches} != {expected}")
    print(f"fused: peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB ({card})",
          flush=True)
    print(f"fused: step {ms} ms vs the default configuration's {default_ms} ms in this run "
          f"({TRAIN_B * 1000.0 / ms} vs {TRAIN_B * 1000.0 / default_ms} images/s; {card})",
          flush=True)
    profile_steps(torch, trainer, batch, card)
    del trainer
    torch.cuda.empty_cache()
    return launches


def fit_phase(torch, np, sd, tsd, card: str):
    """fit across an unfreeze stage with checkpoints, then resume."""
    import shutil
    import tempfile

    from dclip_tpu_torch.core.config import UnfreezeStage
    from dclip_tpu_torch.train.checkpoint import CheckpointManager

    changes = _fused_changes(phase1_epochs=FIT_EPOCHS, unfreeze_schedule=(
        UnfreezeStage(epoch=1, patterns=("mlp", "layer_norm")),))
    trainer, batch = _distill_trainer(torch, np, sd, tsd, "cuda", FIT_B, **changes)
    log = []

    class Pipeline:
        def epoch(self, epoch):
            expected = _expected(_fused_per_step(trainer), FIT_STEPS)
            _reset_all_launches()
            for _ in range(FIT_STEPS):
                yield batch
            torch.cuda.synchronize()
            layers = trainer.student.vision_model.encoder.layers
            grads = [float(p.grad.abs().max()) if p.grad is not None else 0.0
                     for lay in layers for p in (lay.mlp.fc1.weight, lay.layer_norm1.weight)]
            log.append((epoch, _all_launches(), expected, min(grads)))

    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpts = CheckpointManager(directory, save_top_k=2)
        t0 = time.perf_counter()
        history = trainer.fit(Pipeline(), checkpoints=ckpts)
        print(f"fit: {FIT_EPOCHS} epochs x {FIT_STEPS} steps at B={FIT_B} with checkpoints in "
              f"{time.perf_counter() - t0} s, losses {json.dumps(history['train_loss'])}",
              flush=True)
        layers = trainer.student.vision_model.encoder.layers
        for epoch, got, expected, min_grad in log:
            k6, k9 = got["mlp_frozen_fwd"], got["attn_block_trainable_fwd"]
            print(f"fit: epoch {epoch}: K6 {k6} + {got['mlp_frozen_bwd']}, K9 {k9} + "
                  f"{got['attn_block_trainable_bwd']}, K8 {got['mlp_trainable_fwd']}, min over "
                  f"vision layers of max |grad| of fc1 / LN1 {min_grad}", flush=True)
            if got != expected:
                raise AssertionError(f"fit epoch {epoch}: launches {got} != {expected}")
            n = len(layers) * FIT_STEPS
            want_k6 = n if epoch == 0 else 0
            if k6 != want_k6 or got["mlp_frozen_bwd"] != want_k6 or k9 != n \
                    or got["attn_block_trainable_bwd"] != n:
                raise AssertionError(f"fit epoch {epoch}: K6 {k6}, K9 {k9}")
            if epoch == 1 and not min_grad > 0.0:
                raise AssertionError("fit epoch 1: a vision LN1 / MLP gradient is zero")
        fresh, _ = _distill_trainer(torch, np, sd, tsd, "cuda", FIT_B, **changes)
        start = fresh.resume(ckpts)
        same = all(torch.equal(a, b) for a, b in zip(trainer.student.parameters(),
                                                     fresh.student.parameters()))
        mine, theirs = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
        same_opt = (mine["count"], mine["mini_step"]) == (theirs["count"], theirs["mini_step"]) \
            and all(torch.equal(a, b) for k in ("mu", "nu") for a, b in zip(mine[k], theirs[k]))
        replayed = not any(lay.fused_frozen_mlp for lay in fresh.student.vision_model.encoder.layers)
        print(f"fit: resume from {ckpts.latest()['path'].rsplit('/', 1)[-1]}: start epoch {start}, "
              f"step {fresh.step} (uninterrupted {trainer.step}), parameters bit-equal {same}, "
              f"optimizer state bit-equal {same_opt}, stage replayed (K6 off) {replayed}",
              flush=True)
        if not (start == FIT_EPOCHS and fresh.step == trainer.step and same and same_opt
                and replayed):
            raise AssertionError("fit: resume did not restore the uninterrupted state")
        for t in (trainer, fresh):
            t.train_step_on_batch(batch)
        torch.cuda.synchronize()
        diff = max((a - b).abs().max().item() for a, b in zip(trainer.student.parameters(),
                                                                fresh.student.parameters()))
        print(f"fit: next update after resume vs uninterrupted: max |diff| {diff} (bound 0: no "
              f"kernel sums with atomics)", flush=True)
        if diff != 0.0:
            raise AssertionError(f"fit: the resumed run's next update differs by {diff}")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    del trainer, fresh
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from dclip_tpu_torch.cli import serve as cli_serve
    from dclip_tpu_torch.kernels import _build
    from dclip_tpu_torch.kernels import vit_block as vb

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    seconds = _build.build(force=True)
    print(f"build: {seconds} s", flush=True)
    with open(_build.LOG_PATH) as f:
        for line in f:
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print("build:", line.strip(), flush=True)
    # The loader's path: the first load runs the self-check launch.
    _build.reset_launches()
    _build.load_library()
    loader_launches = dict(_build.LAUNCHES)
    print(f"load: self-check {json.dumps(_build.SELF_CHECK)}, launches "
          f"{json.dumps(loader_launches)}", flush=True)

    table = KernelTable(list(KERNELS) + list(TRAIN_KERNELS) + list(TEACHER_KERNELS)
                        + list(TRAINABLE_KERNELS))
    kernel_phase(torch, vb, card, table)
    service, args, launches = slice_phase(torch, np, vb, cli_serve, card)
    cli_serve.bench(service, args, concurrencies=(1, 32))
    del service
    torch.cuda.empty_cache()

    train_kernel_phase(torch, np, card, table)
    xattn_kernel_phase(torch, np, card, table)
    trainable_kernel_phase(torch, np, card, table)
    l14_frozen_mlp_phase(torch, np, card)
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict

    sd = random_state_dict(CLIPConfig.vit_b_16(), seed=0)
    tsd = random_teacher_state_dict(_teacher_config(), seed=0)
    train_launches, default_ms = train_slice_phase(torch, np, sd, tsd, card)
    fused_launches = fused_slice_phase(torch, np, sd, tsd, card, default_ms)
    uncached_launches, _ = uncached_slice_phase(torch, np, sd, tsd, card)
    cache_levels_phase(torch, np, sd, tsd, card)
    target_agreement_phase(torch, np, sd, tsd)
    grad_agreement_phase(torch, np, sd, tsd)
    # The vision LN1 unfrozen at epoch 0: K9's LayerNorm weight gradients
    # are held too, beside the text LN2 / MLP ones of K8.
    from dclip_tpu_torch.core.config import UnfreezeStage

    grad_agreement_phase(torch, np, sd, tsd, "fused grads",
                         must_hold=("vision_model.encoder.layers.0.layer_norm1.weight",
                                    "text_model.encoder.layers.0.layer_norm2.weight",
                                    "text_model.encoder.layers.0.mlp.fc1.weight"),
                         **_fused_changes(unfreeze_schedule=(
                             UnfreezeStage(epoch=0, patterns=("layer_norm1",)),)))
    fit_phase(torch, np, sd, tsd, card)

    counts = {**{n: launches[n] for n in KERNELS}, **{n: train_launches[n] for n in TRAIN_KERNELS},
              **{n: uncached_launches[n] for n in TEACHER_KERNELS if n in uncached_launches},
              "loader_self_check": loader_launches["loader_self_check"],
              **{n: fused_launches[n] for n in TRAINABLE_KERNELS}}
    sources = {**KERNELS, **TRAIN_KERNELS, **TEACHER_KERNELS, **TRAINABLE_KERNELS}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], **table.entry(name)}
               for name, (src, rep) in sources.items()]
    print(f"chip_smoke: {time.perf_counter() - t_start} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
