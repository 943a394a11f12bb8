#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

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

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
