#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases; each one passes or raises, and any failure exits non-zero:

1. Device: requires `torch.cuda.is_available()`; prints the card's
   `nvidia-smi --query-gpu=name,power.limit` line.
2. Build: compiles `dclip_tpu_torch/kernels/csrc/*.cu` with nvcc from the
   checkout and prints the build time and ptxas resource lines.
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
7. Training slice: the port's `DistillTrainer` at ViT-B/16 (student =
   teacher CLIP, random weights from seed 0, bf16, kernels on, packed
   text, B=256, accumulate 1) on the synthetic batch (seed 0) with its full
   teacher targets in an in-memory `TeacherTargetCache` (seeded unit
   vectors): 3 warm-up and 10 timed steps on the cache-warm path, finite
   and falling loss, launch counters at exactly 13 x the per-step count,
   then one no-grad packed text encode on the stats-free attention; a
   torch.profiler window of 2 steps for the device busy share and the
   time by kernel; ms per step and cache-warm images/s.
8. Gradient agreement: one step's trainable gradients at full width and
   depth, B=8, bf16 kernels on the card vs the same step in f32 on the
   CPU through the twins: global cosine >= 0.99, every tensor >= 0.95.

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
TRAIN_B, TEXT_S, TEXT_D, TEXT_HEADS = 256, 77, 512, 8
WARMUP_STEPS, TIMED_STEPS = 3, 10
GRAD_B, GRAD_COS_GLOBAL, GRAD_COS_TENSOR = 8, 0.99, 0.95
# k_proj.bias gradients are rounding noise (see grad_agreement_phase); their
# norm must stay below this share of the layer's q_proj.bias gradient.
GRAD_NOISE_RATIO = 0.1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def kernel_phase(torch, vb, card: str):
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    p = layer_weights(rng, torch, dev)
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for name in KERNELS}

    def randn(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype("float32") * scale)
                .to(dev).to(torch.bfloat16))

    for b in (B, 1):
        x = randn(b, S, D)
        h = randn(b, S, D)
        a = randn(b, S, D)
        g = randn(b, S, MLP)
        qkv = randn(b, S, 3 * D)
        cases = [
            ("layernorm", "ln", (vb.layernorm, vb.layernorm_reference),
             (x, p["ln1_scale"], p["ln1_bias"], EPS), {}),
            ("gemm_bias_act_residual", "qkv",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (h, p["qkv_w"], p["qkv_b"]), {}),
            ("gemm_bias_act_residual", "out_proj+residual",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (a, p["out_w"], p["out_b"]), {"residual": x}),
            ("gemm_bias_act_residual", "fc1+gelu",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (h, p["fc1_w"], p["fc1_b"]), {"gelu": True}),
            ("gemm_bias_act_residual", "fc2+residual",
             (vb.gemm_bias_act_residual, vb.gemm_bias_act_residual_reference),
             (g, p["fc2_w"], p["fc2_b"]), {"residual": x}),
            ("attention", "core", (vb.attention, vb.attention_reference), (qkv, HEADS), {}),
            ("attention_block", "block",
             (vb.attention_block_fused, vb.attention_block_reference), (x, p, HEADS, EPS), {}),
            ("mlp_block", "block", (vb.mlp_block_fused, vb.mlp_block_reference),
             (x, p, EPS), {}),
        ]
        for name, variant, (kernel, twin), args, kwargs in cases:
            got = kernel(*args, **kwargs)
            want = twin(*args, **kwargs)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.bfloat16:
                raise AssertionError(f"{name}[{variant}] B={b}: got {got.shape} {got.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}[{variant}] B={b}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            bound = REL_TOL * max(1.0, want.float().abs().max().item())
            print(f"kernel {name}[{variant}] B={b}: max_abs_err {err} bound {bound}", flush=True)
            if not err <= bound:
                raise AssertionError(f"{name}[{variant}] B={b}: max_abs_err {err} > {bound}")
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if b == B:
                iters = 10 if name.endswith("block") else 20
                ms, plain_ms = time_pair(
                    torch, lambda: kernel(*args, **kwargs), lambda: twin(*args, **kwargs), iters)
                print(f"time {name}[{variant}] B={b}: kernel {ms} ms, plain {plain_ms} ms "
                      f"({card})", flush=True)
                # The GEMM entry sums its four epilogues: one layer's GEMMs.
                r["ms"] += ms
                r["plain_ms"] += plain_ms
    return results


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
    return seg, pad


def train_kernel_phase(torch, np, card: str):
    """The training kernels against their twins at the cache-warm step's
    shapes, plus a ragged small case of each; CUDA-event times."""
    from dclip_tpu_torch.kernels import distill_loss as dl
    from dclip_tpu_torch.kernels import mlp_frozen as mf
    from dclip_tpu_torch.kernels import vit_attention as va

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for name in TRAIN_KERNELS}

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.from_numpy(rng.standard_normal(shape).astype("float32") * scale)
                .to(dev).to(dtype))

    def record(name, err, timed, kernel_fn=None, plain_fn=None, iters=10, variant=""):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timed:
            ms, plain_ms = time_pair(torch, kernel_fn, plain_fn, iters)
            print(f"time {name}[{variant}]: kernel {ms} ms, plain {plain_ms} ms ({card})",
                  flush=True)
            r["ms"] += ms
            r["plain_ms"] += plain_ms

    seg, pad = _text_masks(torch, np, dev)
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
        record("self_attention_fwd_stats", err, timed,
               lambda: va.self_attention_fwd_stats(q, k, v, heads, **kw),
               lambda: va.attention_reference(q, k, v, heads, stats=True, **kw), 10, variant)
        o3 = va.self_attention_fused(q, k, v, heads, **kw)
        err3 = _bound_check(torch, f"attention_fused[{variant}]", o3, o_ref, REL_TOL)
        record("self_attention_fused", err3, timed,
               lambda: va.self_attention_fused(q, k, v, heads, **kw),
               lambda: va.attention_reference(q, k, v, heads, **kw), 10, variant)
        grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
        want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw)
        errb = max(_bound_check(torch, f"attention_bwd[{variant}] {n}", a, w, BWD_TOL)
                   for n, a, w in zip(("dq", "dk", "dv"), grads, want))
        record("self_attention_bwd_stats", errb, timed,
               lambda: va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw),
               lambda: va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw),
               5, variant)
        del qkv, q, k, v, g, o, m, r, o_ref, m_ref, r_ref, grads, want

    for variant, b, timed in (("vision", TRAIN_B, True), ("ragged", 1, False)):
        lw = layer_weights(rng, torch, dev)
        p = mf.pack_frozen_mlp(lw["ln2_scale"], lw["ln2_bias"], lw["fc1_w"].t(), lw["fc1_b"],
                               lw["fc2_w"].t(), lw["fc2_b"], torch.bfloat16)
        x, g = randn(b, S, D), randn(b, S, D)
        y, a1 = mf.mlp_frozen_fwd(x, p)
        y_ref, a1_ref = mf.mlp_frozen_fwd_reference(x, p)
        err = max(_bound_check(torch, f"mlp_frozen_fwd[{variant}] y", y, y_ref, REL_TOL),
                  _bound_check(torch, f"mlp_frozen_fwd[{variant}] a1", a1, a1_ref, REL_TOL))
        record("mlp_frozen_fwd", err, timed, lambda: mf.mlp_frozen_fwd(x, p),
               lambda: mf.mlp_frozen_fwd_reference(x, p), 5, variant)
        dx = mf.mlp_frozen_bwd(x, g, a1, p)
        errb = _bound_check(torch, f"mlp_frozen_bwd[{variant}] dx", dx,
                            mf.mlp_frozen_bwd_reference(x, g, a1_ref, p), BWD_TOL)
        record("mlp_frozen_bwd", errb, timed, lambda: mf.mlp_frozen_bwd(x, g, a1, p),
               lambda: mf.mlp_frozen_bwd_reference(x, g, a1_ref, p), 5, variant)
        dh = randn(b, S, D, dtype=torch.float32)
        errl = _bound_check(torch, f"layernorm_bwd[{variant}]",
                            mf.layernorm_bwd(x, g, dh, p["ln2_scale"]),
                            mf.layernorm_bwd_reference(x, g, dh, p["ln2_scale"]), REL_TOL)
        record("layernorm_bwd", errl, timed, lambda: mf.layernorm_bwd(x, g, dh, p["ln2_scale"]),
               lambda: mf.layernorm_bwd_reference(x, g, dh, p["ln2_scale"]), 20, variant)
        del x, g, y, a1, y_ref, a1_ref, dx, dh

    for variant, b, timed in (("b256", TRAIN_B, True), ("ragged", 5, False)):
        si, st = randn(b, 512), randn(b, 512)
        # Targets correlated with the student rows (cosine ~0.9), so li and
        # lt sit far from 1 and a dropped cosine term moves them.
        ti = si.float() + randn(b, 512, scale=0.5, dtype=torch.float32)
        tt = st.float() + randn(b, 512, scale=0.5, dtype=torch.float32)
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
        record("distill_loss_fwd", err, timed, lambda: dl.distill_loss_fwd(si, st, ti, tt),
               lambda: dl.distill_loss_fwd_reference(si, st, ti, tt), 20, variant)
        cts = torch.tensor([1.0, 1.0, 1.0], device=dev)
        got = dl.distill_loss_bwd(si, st, ti, tt, cts)
        want = dl.distill_loss_bwd_reference(si, st, ti, tt, cts)
        errb = max(_bound_check(torch, f"distill_loss_bwd[{variant}] {n}", a, w, DL_BWD_TOL,
                                with_one=False)
                   for n, a, w in zip(("dsi", "dst"), got, want))
        record("distill_loss_bwd", errb, timed, lambda: dl.distill_loss_bwd(si, st, ti, tt, cts),
               lambda: dl.distill_loss_bwd_reference(si, st, ti, tt, cts), 20, variant)
    torch.cuda.empty_cache()
    return results


def _reset_all_launches():
    from dclip_tpu_torch.kernels import distill_loss, mlp_frozen, vit_attention, vit_block

    for mod in (vit_block, vit_attention, mlp_frozen, distill_loss):
        mod.reset_launches()


def _all_launches():
    from dclip_tpu_torch.kernels import distill_loss, mlp_frozen, vit_attention, vit_block

    out = {}
    for mod in (vit_block, vit_attention, mlp_frozen, distill_loss):
        out.update(mod.LAUNCHES)
    return out


def _distill_trainer(torch, np, sd, device, batch_size, **changes):
    """The port's DistillTrainer at ViT-B/16 with the batch's full teacher
    targets (seeded unit vectors) in an in-memory cache."""
    import dataclasses

    from dclip_tpu_torch.cli.common import synthetic_distill_batch
    from dclip_tpu_torch.core import CLIPConfig, DistillConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = CLIPConfig.vit_b_16()
    dcfg = dataclasses.replace(
        DistillConfig(train_batch_size=batch_size, accumulate_grad_batches=1,
                      learning_rate=1e-4, student_model="vit-b-16",
                      teacher_clip_model="vit-b-16", packed_text=True), **changes)
    batch = synthetic_distill_batch(cfg, dcfg.teacher, batch_size, np.random.RandomState(0))
    batch["index"] = np.arange(batch_size, dtype=np.int64)
    targets = np.random.RandomState(2).standard_normal(
        (batch_size, 2, cfg.projection_dim)).astype(np.float32)
    targets /= np.linalg.norm(targets, axis=-1, keepdims=True)
    cache = TeacherTargetCache(salt="chip-smoke")  # a salt: no teacher fingerprint pass
    trainer = DistillTrainer(dcfg, sd, sd, None, cfg, cfg, device=device, teacher_cache=cache)
    cache.put_batch(cache.keys_for(batch), targets)
    return trainer, batch


def train_slice_phase(torch, np, sd, card: str):
    """The cache-warm B/16 training step at B=256 on the card."""
    trainer, batch = _distill_trainer(torch, np, sd, "cuda", TRAIN_B)
    student = trainer.student
    if student.dtype != torch.bfloat16 or not trainer._use_kernels or not trainer._packed_text:
        raise AssertionError("expected bf16, kernels on and packed text on CUDA")
    _reset_all_launches()
    losses = []
    for _ in range(WARMUP_STEPS):
        losses.append(trainer.train_step_on_batch(batch)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        losses.append(trainer.train_step_on_batch(batch)["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _all_launches()
    losses = [float(x) for x in losses]
    steps = WARMUP_STEPS + TIMED_STEPS
    print("train: losses", json.dumps(losses), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: {losses}")
    if trainer._dev_full.hits != steps - 1:
        raise AssertionError(f"device target cache hits {trainer._dev_full.hits}, "
                             f"expected {steps - 1} (the first step hits the host cache)")
    v, t = trainer.student_config.vision.num_layers, trainer.student_config.text.num_layers
    per_step = {
        "layernorm": v, "gemm_bias_act_residual": 4 * v, "attention": 0,
        "attention_block": 0, "mlp_block": 0, "encoder_forward": 0, "image_features": 0,
        "self_attention_fused": 0, "self_attention_fwd_stats": v + t,
        "self_attention_bwd_stats": v + t, "mlp_frozen_fwd": v, "mlp_frozen_bwd": v,
        "layernorm_bwd": v, "distill_loss_fwd": 1, "distill_loss_bwd": 1,
    }
    expected = {k: n * steps for k, n in per_step.items()}
    print("train: launches", json.dumps(launches), "expected", json.dumps(expected), flush=True)
    if launches != expected:
        raise AssertionError(f"training launch counts {launches} != {expected}")
    ms = 1000.0 * seconds / TIMED_STEPS
    print(f"train: cache-warm step {ms} ms, {TRAIN_B * TIMED_STEPS / seconds} images/s "
          f"(B={TRAIN_B}, {TIMED_STEPS} steps after {WARMUP_STEPS} warm-up; {card})", flush=True)
    print(f"train: peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB",
          flush=True)

    # One no-grad packed text encode: the stats-free attention mode.
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


def profile_steps(torch, trainer, batch, card: str, steps: int = 2):
    """Device busy share and device time by kernel over `steps` steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step_on_batch(batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # Device-side events only (kernels, copies): the host-side rows of
    # key_averages() also carry their children's device time.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    if device_us == 0:
        print("profile: key_averages() show no device time", flush=True)
        return
    print(f"profile: {steps} steps, wall {wall_us / 1e3} ms, device {device_us / 1e3} ms, "
          f"busy {100.0 * device_us / wall_us}% ({card})", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"profile: {100.0 * us / device_us:6.2f}% {us / 1e3 / steps:9.3f} ms/step "
              f"x{count // steps:<5d} {key[:110]}", flush=True)


def grad_agreement_phase(torch, np, sd):
    """One step's trainable gradients, B=8: bf16 kernels on the card vs
    f32 twins on the CPU."""
    grads = {}
    for device, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        trainer, batch = _distill_trainer(torch, np, sd, device, GRAD_B, compute_dtype=dtype,
                                          use_pallas=True)
        t0 = time.perf_counter()
        trainer.train_step_on_batch(batch)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"grads: {device} {dtype} step {time.perf_counter() - t0} s", flush=True)
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
    print(f"grads: {len(grads['cuda'])} trainable tensors, global cosine {glob}, min cosine "
          f"{held[worst_name]} ({worst_name}); lowest {json.dumps(lowest)}; "
          f"{len(held)} held, {len(noise)} k_proj.bias (max |g| / |g q_proj.bias| {ratio}), "
          f"{len(grads['cuda']) - len(cos)} all-zero (logit_scale); bounds {GRAD_COS_GLOBAL} / "
          f"{GRAD_COS_TENSOR}, noise ratio {GRAD_NOISE_RATIO}", flush=True)
    if not (glob >= GRAD_COS_GLOBAL and held[worst_name] >= GRAD_COS_TENSOR
            and ratio < GRAD_NOISE_RATIO):
        raise AssertionError(f"gradient agreement: global {glob}, min {held[worst_name]} "
                             f"({worst_name}), k_proj.bias noise ratio {ratio}")


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

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    seconds = _build.build(force=True)
    _build.load_library()
    print(f"build: {seconds} s", flush=True)
    with open(_build.LOG_PATH) as f:
        for line in f:
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print("build:", line.strip(), flush=True)

    results = kernel_phase(torch, vb, card)
    service, args, launches = slice_phase(torch, np, vb, cli_serve, card)
    cli_serve.bench(service, args, concurrencies=(1, 32))
    del service
    torch.cuda.empty_cache()

    train_results = train_kernel_phase(torch, np, card)
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.models.weights import random_state_dict

    sd = random_state_dict(CLIPConfig.vit_b_16(), seed=0)
    train_launches, _ = train_slice_phase(torch, np, sd, card)
    grad_agreement_phase(torch, np, sd)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": train_launches[name], **train_results[name]}
        for name, (src, rep) in TRAIN_KERNELS.items()
    ]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
