"""Fused ViT encoder blocks for the frozen image tower, on Hopper.

Counterpart of `dclip_tpu/kernels/vit_block.py`. Two blocks per encoder
layer, as on the TPU:

  attention_block:  x + out_proj(MHA(LN1(x)))
  mlp_block:        x + fc2(quick_gelu(fc1(LN2(x))))

The TPU kernels (`_attn_kernel`, `_mlp_kernel`) run each block as ONE
Pallas program per image with every weight matrix resident in VMEM. A
Hopper block has at most 227 KB of shared memory, so each block here is a
short sequence of tiled CUDA kernels from `csrc/`:

  layernorm               LN1 / LN2, f32 statistics, bf16 out
  gemm_bias_act_residual  QKV (one GEMM over the concatenated [D, 3D]
                          weight), out_proj + residual, fc1 + quick-GELU,
                          fc2 + residual; bf16 tensor cores, f32 accumulate
                          (its pre-activation save, quick-GELU' and f32
                          output epilogues serve `kernels.mlp_frozen`)
  attention               log2-domain softmax(q k^T / sqrt(64)) v per
                          (image, head, query tile), reading q/k/v from the
                          fused QKV buffer by stride

Every wrapper has a plain PyTorch twin beside it (`*_reference`, same
signature) that computes in f32 from whatever dtype it is given and
returns the input dtype. A wrapper takes its twin only when the tensor it
was given lies on the CPU; for a CUDA tensor it launches its kernel or
raises. `LAUNCHES` counts kernel launches per wrapper (CUDA only), so a
run can show that its main path went through the kernels.

Weights enter in the kernels' layouts, made once by `pack_vision_weights`
(Linear [out, in] -> [in, out], q/k/v concatenated, LN params and biases
in f32): there is no per-call transpose or concatenation. There is no
VMEM gate (`block_fit` on the TPU): the kernels tile, so every width runs
on them.

Under tensor parallelism (`pack_vision_weights(..., mesh)` with a model
axis, `parallel.tp`) the packed layers are this rank's slices and each
layer is composed from the same kernels at shard width
(`encoder_forward_tp`): LN1, the QKV GEMM over [q_m; k_m; v_m], the
attention core on `heads / mp` heads, the out_proj GEMM without bias in
f32, the all-reduce over the model group, + bias + residual; then LN2,
fc1 + quick-GELU, fc2 without bias in f32, the all-reduce, + bias +
residual. The whole-block wrappers do not run there.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Mapping, Optional

import torch

from dclip_tpu_torch.kernels._build import check, load_library

LOG2E = 1.4426950408889634

LAUNCHES: Dict[str, int] = {
    "layernorm": 0,
    "gemm_bias_act_residual": 0,
    "attention": 0,
    "attention_block": 0,
    "mlp_block": 0,
    "encoder_forward": 0,
    "image_features": 0,
}


# NN / NT launches of `csrc/gemm.cu` by the schedule `gemm_tile_n` chose
# (CUDA only): whether the wide tiles ran where they should.
GEMM_SCHEDULES: Dict[str, int] = {"wide": 0, "narrow": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in GEMM_SCHEDULES:
        GEMM_SCHEDULES[k] = 0


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ROOT_TWO_OVER_PI = 0.7978845608028654


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """HF's `gelu_pytorch_tanh` (SigLIP): 0.5 x (1 + tanh(sqrt(2 / pi) (x +
    0.044715 x^3)))."""
    return 0.5 * x * (1.0 + torch.tanh(_ROOT_TWO_OVER_PI * (x + 0.044715 * x * x * x)))


def gelu_tanh_grad(a: torch.Tensor) -> torch.Tensor:
    """d/da gelu_tanh(a) = (1 + t) / 2 + a (1 - t^2) sqrt(2 / pi) (1 + 3
    0.044715 a^2) / 2, t = tanh(sqrt(2 / pi) (a + 0.044715 a^3))."""
    t = torch.tanh(_ROOT_TWO_OVER_PI * (a + 0.044715 * a * a * a))
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * _ROOT_TWO_OVER_PI * (
        1.0 + 3 * 0.044715 * a * a)


# -- dispatch helpers ----------------------------------------------------------


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU (the twin runs), False when
    every tensor lies on one CUDA device (the kernel runs); raises on a mix
    or any other device."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, got {devices}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _launch(device: torch.device, fn, *args):
    """fn(*args, stream) on the current stream of a CUDA tensor's device,
    switching the current device only when it differs: for a kernel of a
    few microseconds the wrapper's host time is of the order of the
    kernel's own, and the switch is a part of it."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))


# -- layernorm -----------------------------------------------------------------


def layernorm_reference(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


# The widest row the LayerNorm kernels hold in registers (`csrc/layernorm.cu`).
LAYERNORM_MAX_D = 1280


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim. CUDA: x bf16 [..., D] (D % 8 == 0,
    D <= 1280), scale / bias f32 [D]; returns bf16 like x."""
    if _on_cpu(x, scale, bias):
        return layernorm_reference(x, scale, bias, eps)
    d = x.shape[-1]
    _require(x, "x", torch.bfloat16, x.dim())
    _require(scale, "scale", torch.float32, 1)
    _require(bias, "bias", torch.float32, 1)
    if d % 8 or d > LAYERNORM_MAX_D or scale.shape[0] != d or bias.shape[0] != d \
            or x.numel() == 0:
        raise ValueError(f"layernorm: bad shapes x {tuple(x.shape)}, scale {tuple(scale.shape)} "
                         f"(D % 8 == 0, <= {LAYERNORM_MAX_D})")
    lib = load_library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.dclip_layernorm_bf16(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel() // d, d, float(eps), _stream(x),
        )
    check(lib, code, "layernorm")
    LAUNCHES["layernorm"] += 1
    return y


# -- GEMM + bias + activation + residual ---------------------------------------


def quick_gelu_grad(a: torch.Tensor) -> torch.Tensor:
    """d/da quick_gelu(a) = s + 1.702 a s (1 - s), s = sigmoid(1.702 a)."""
    s = torch.sigmoid(1.702 * a)
    return s + 1.702 * a * s * (1.0 - s)


# The MLP activations by the HF config's `hidden_act`: (function, derivative,
# the GEMM epilogue codes of `csrc/gemm.cu` for the activation and for a
# multiply by its derivative).
ACTIVATIONS = {
    "quick_gelu": (quick_gelu, quick_gelu_grad, 1, 2),
    "gelu_pytorch_tanh": (gelu_tanh, gelu_tanh_grad, 3, 4),
}


def activation(act: str):
    """(function, derivative, epilogue codes) of `act`; raises on others."""
    if act not in ACTIVATIONS:
        raise ValueError(f"activation {act!r}: the port's MLP takes {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[act]


def gemm_bias_act_residual_reference(a, w, bias=None, residual=None, gelu: bool = False,
                                     save_preact: bool = False, dgelu_of=None,
                                     out_dtype: Optional[torch.dtype] = None,
                                     act: str = "quick_gelu"):
    fn, grad = activation(act)[:2]
    y = a.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    pre = y
    if gelu:
        y = fn(y)
    if dgelu_of is not None:
        y = y * grad(dgelu_of.float())
    if residual is not None:
        y = y + residual.float()
    y = y.to(out_dtype or a.dtype)
    return (y, pre.to(a.dtype)) if save_preact else y


def gemm_bias_act_residual(a: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           residual: Optional[torch.Tensor] = None,
                           gelu: bool = False, save_preact: bool = False,
                           dgelu_of: Optional[torch.Tensor] = None,
                           out_dtype: Optional[torch.dtype] = None,
                           act: str = "quick_gelu"):
    """a [..., K] @ w [K, N] (+ bias [N]), then the activation `act`
    (quick-GELU, or SigLIP's tanh-GELU "gelu_pytorch_tanh") if `gelu` or a
    multiply by its derivative at dgelu_of [..., N], then + residual
    [..., N]. `save_preact=True` also returns the pre-activation (a @ w +
    bias) in a's dtype: (out, preact). CUDA: a, w, residual, dgelu_of bf16;
    bias f32; K % 8 == 0, N % 8 == 0; out bf16, or f32 with out_dtype."""
    if _on_cpu(a, w, bias, residual, dgelu_of):
        return gemm_bias_act_residual_reference(a, w, bias, residual, gelu, save_preact,
                                                dgelu_of, out_dtype, act)
    out = launch_gemm(a, w, bias, residual, gelu, save_preact, dgelu_of, out_dtype, act=act)
    LAUNCHES["gemm_bias_act_residual"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm_tile_n(m: int, n: int, sms: int) -> int:
    """The output-tile width of `csrc/gemm.cu`'s NN / NT schedule for an
    [m, k] @ [k, n] product on a card of `sms` SMs: 256, the wide
    cooperative tiles, where there are at least two row blocks of 128 an SM
    (the region encode, K6) and padding N to 256 wastes at most an eighth of
    the columns; else 128, the narrow ping-pong tiles (the serving buckets,
    K10's projections, the packed text rows), which keep more SMs busy on
    few row blocks and overlap their epilogues."""
    wide_cols = -(-n // 256) * 256
    return 256 if -(-m // 128) >= 2 * sms and 8 * (wide_cols - n) <= n else 128


def launch_gemm(a, w, bias=None, residual=None, gelu: bool = False, save_preact: bool = False,
                dgelu_of=None, out_dtype=None, w_is_nk: bool = False, act: str = "quick_gelu"):
    """Check the operands and launch `csrc/gemm.cu` on CUDA tensors: w is
    [K, N] (the NN mode), or [N, K] with `w_is_nk` (the NT mode)."""
    epi_gelu, epi_dgelu = activation(act)[2:]
    n, k = w.shape if w_is_nk else w.shape[::-1]
    _require(a, "a", torch.bfloat16, a.dim())
    _require(w, "w", torch.bfloat16, 2)
    out_shape = a.shape[:-1] + (n,)
    if bias is not None:
        _require(bias, "bias", torch.float32, 1)
        if bias.shape[0] != n:
            raise ValueError(f"gemm: bias {tuple(bias.shape)} for N = {n}")
    for name, t in (("residual", residual), ("dgelu_of", dgelu_of)):
        if t is not None:
            _require(t, name, torch.bfloat16, t.dim())
            if t.shape != out_shape:
                raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(out_shape)}")
    if gelu and dgelu_of is not None:
        raise ValueError("gemm: gelu and dgelu_of exclude each other")
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"gemm: the CUDA kernel writes bf16 or f32, not {out_dtype}")
    if a.shape[-1] != k or k % 8 or n % 8 or a.numel() == 0:
        raise ValueError(
            f"gemm: bad shapes a {tuple(a.shape)}, w {tuple(w.shape)} "
            "(need K % 8 == 0, N % 8 == 0)"
        )
    lib = load_library()
    c = torch.empty(out_shape, dtype=out_dtype or a.dtype, device=a.device)
    pre = torch.empty(out_shape, dtype=a.dtype, device=a.device) if save_preact else None
    epilogue = epi_gelu if gelu else (epi_dgelu if dgelu_of is not None else 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    m = a.numel() // k
    sms = _sm_count(a.device.index if a.device.index is not None else torch.cuda.current_device())
    tile_n = gemm_tile_n(m, n, sms)
    entry = lib.dclip_gemm_nt_bf16 if w_is_nk else lib.dclip_gemm_bf16
    with torch.cuda.device(a.device):
        code = entry(
            a.data_ptr(), w.data_ptr(), ptr(bias), ptr(residual), ptr(dgelu_of), ptr(pre),
            c.data_ptr(), m, n, k, epilogue, int(c.dtype == torch.float32), tile_n, sms,
            _stream(a),
        )
    check(lib, code, "gemm (NT mode)" if w_is_nk else "gemm_bias_act_residual")
    GEMM_SCHEDULES["wide" if tile_n == 256 else "narrow"] += 1
    return (c, pre) if save_preact else c


# -- attention core ------------------------------------------------------------


def attention_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The TPU kernel's algebra in f32: log2-domain logits (scale folded
    with log2 e), exp2, normalisation after the PV product."""
    from dclip_tpu_torch.kernels.vit_attention import attention_reference as masked

    d = qkv.shape[-1] // 3
    return masked(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], num_heads)


def attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Unmasked MHA core over the fused buffer qkv [B, S, 3D] -> [B, S, D].
    CUDA: bf16, head_dim 64 only. The kernel is `csrc/attention.cu`, the
    one `kernels.vit_attention` drives with masks and statistics."""
    if _on_cpu(qkv):
        return attention_reference(qkv, num_heads)
    _require(qkv, "qkv", torch.bfloat16, 3)
    b, s, three_d = qkv.shape
    d = three_d // 3
    if three_d % 3 or d % num_heads or d // num_heads != 64 or b * s == 0:
        raise ValueError(
            f"attention: the CUDA kernel takes head_dim 64, got qkv "
            f"{tuple(qkv.shape)} with {num_heads} heads"
        )
    lib = load_library()
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        code = lib.dclip_attention_bf16(qkv.data_ptr(), out.data_ptr(), b, s,
                                        num_heads, _stream(qkv))
    check(lib, code, "attention")
    LAUNCHES["attention"] += 1
    return out


# -- blocks --------------------------------------------------------------------


def attention_block_reference(x, p: Mapping[str, torch.Tensor], num_heads: int,
                              eps: float = 1e-5):
    xf = x.float()
    h = layernorm_reference(xf, p["ln1_scale"], p["ln1_bias"], eps)
    qkv = gemm_bias_act_residual_reference(h, p["qkv_w"], p["qkv_b"])
    a = attention_reference(qkv, num_heads)
    out = gemm_bias_act_residual_reference(a, p["out_w"], p["out_b"], residual=xf)
    return out.to(x.dtype)


def attention_block_fused(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                          num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x + out_proj(MHA(LN1(x))) over x [B, S, D]; `p` is one layer of
    `pack_vision_weights(...)["layers"]`."""
    if _on_cpu(x):
        return attention_block_reference(x, p, num_heads, eps)
    h = layernorm(x, p["ln1_scale"], p["ln1_bias"], eps)
    qkv = gemm_bias_act_residual(h, p["qkv_w"], p["qkv_b"])
    a = attention(qkv, num_heads)
    out = gemm_bias_act_residual(a, p["out_w"], p["out_b"], residual=x)
    LAUNCHES["attention_block"] += 1
    return out


def mlp_block_reference(x, p: Mapping[str, torch.Tensor], eps: float = 1e-5,
                        act: str = "quick_gelu"):
    xf = x.float()
    h = layernorm_reference(xf, p["ln2_scale"], p["ln2_bias"], eps)
    h = gemm_bias_act_residual_reference(h, p["fc1_w"], p["fc1_b"], gelu=True, act=act)
    out = gemm_bias_act_residual_reference(h, p["fc2_w"], p["fc2_b"], residual=xf)
    return out.to(x.dtype)


def mlp_block_fused(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                    eps: float = 1e-5, act: str = "quick_gelu") -> torch.Tensor:
    """x + fc2(act(fc1(LN2(x)))) over x [B, S, D]; `act` quick-GELU or
    "gelu_pytorch_tanh"."""
    if _on_cpu(x):
        return mlp_block_reference(x, p, eps, act)
    h = layernorm(x, p["ln2_scale"], p["ln2_bias"], eps)
    h = gemm_bias_act_residual(h, p["fc1_w"], p["fc1_b"], gelu=True, act=act)
    out = gemm_bias_act_residual(h, p["fc2_w"], p["fc2_b"], residual=x)
    LAUNCHES["mlp_block"] += 1
    return out


def encoder_forward_reference(layers: List[Mapping[str, torch.Tensor]], x,
                              num_heads: int, eps: float = 1e-5):
    for p in layers:
        x = attention_block_reference(x, p, num_heads, eps)
        x = mlp_block_reference(x, p, eps)
    return x


def _reduced_residual(partial: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                      mesh) -> torch.Tensor:
    """x + (the f32 sum of the model ranks' partial products + bias), in
    x's dtype."""
    from dclip_tpu_torch.parallel.tp import all_reduce_model_

    return (all_reduce_model_(partial, mesh) + bias + x.float()).to(x.dtype)


def encoder_forward_tp(layers: List[Mapping[str, torch.Tensor]], x: torch.Tensor,
                       num_heads: int, eps: float, mesh) -> torch.Tensor:
    """The encoder stack over this rank's slices (module docstring);
    `num_heads` is the rank's. Every wrapper takes its twin on the CPU."""
    for p in layers:
        h = layernorm(x, p["ln1_scale"], p["ln1_bias"], eps)
        a = attention(gemm_bias_act_residual(h, p["qkv_w"], p["qkv_b"]), num_heads)
        x = _reduced_residual(gemm_bias_act_residual(a, p["out_w"], out_dtype=torch.float32),
                              p["out_b"], x, mesh)
        h = layernorm(x, p["ln2_scale"], p["ln2_bias"], eps)
        h = gemm_bias_act_residual(h, p["fc1_w"], p["fc1_b"], gelu=True)
        x = _reduced_residual(gemm_bias_act_residual(h, p["fc2_w"], out_dtype=torch.float32),
                              p["fc2_b"], x, mesh)
    return x


def encoder_forward_fused(layers: List[Mapping[str, torch.Tensor]], x: torch.Tensor,
                          num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The encoder stack as 2 * len(layers) fused blocks."""
    if _on_cpu(x):
        return encoder_forward_reference(layers, x, num_heads, eps)
    for p in layers:
        x = attention_block_fused(x, p, num_heads, eps)
        x = mlp_block_fused(x, p, eps)
    LAUNCHES["encoder_forward"] += 1
    return x


# -- weights in the kernels' layouts -------------------------------------------


def pack_layer(sd: Mapping[str, torch.Tensor], prefix: str,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One HF-named encoder layer (`{prefix}self_attn.q_proj.weight`, ...)
    -> the block kernels' operands: GEMM weights [in, out] in `dtype`
    (q/k/v concatenated to [D, 3D]), LN params and biases in f32."""

    def t(name):
        return sd[prefix + name].detach()

    def gemm_w(*names):
        return torch.cat([t(f"{n}.weight") for n in names], 0).t().to(dtype).contiguous()

    def f32(*names):
        return torch.cat([t(n) for n in names], 0).float().contiguous()

    qkv = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")
    return {
        "ln1_scale": f32("layer_norm1.weight"),
        "ln1_bias": f32("layer_norm1.bias"),
        "qkv_w": gemm_w(*qkv),
        "qkv_b": f32(*(f"{n}.bias" for n in qkv)),
        "out_w": gemm_w("self_attn.out_proj"),
        "out_b": f32("self_attn.out_proj.bias"),
        "ln2_scale": f32("layer_norm2.weight"),
        "ln2_bias": f32("layer_norm2.bias"),
        "fc1_w": gemm_w("mlp.fc1"),
        "fc1_b": f32("mlp.fc1.bias"),
        "fc2_w": gemm_w("mlp.fc2"),
        "fc2_b": f32("mlp.fc2.bias"),
    }


def _check_shard_widths(cfg, mp: int) -> None:
    """The GEMM's K % 32 == 0 and N % 8 == 0 and the attention core's
    head_dim 64 at every shard width of the image tower."""
    c = cfg.vision
    d, m, hd = c.hidden_size // mp, c.mlp_dim // mp, c.hidden_size // c.num_heads
    if c.hidden_size % mp or c.mlp_dim % mp or c.num_heads % mp or d % 32 or m % 32 \
            or hd != 64:
        raise ValueError(
            f"tensor parallelism at mp={mp}: shard widths D/mp={c.hidden_size / mp}, "
            f"MLP/mp={c.mlp_dim / mp}, {c.num_heads} heads of {hd} do not meet the CUDA "
            "kernels' K % 32 == 0, N % 8 == 0 and head_dim 64")


def pack_vision_weights(cfg, sd: Mapping[str, torch.Tensor], dtype: torch.dtype,
                        mesh=None) -> Dict[str, object]:
    """The image tower of an HF-named CLIP state dict, laid out once for
    `fused_image_features`: the patch conv OIHW [D, 3, p, p] becomes the
    (ph, pw, c)-ordered matrix [p*p*3, D] of the JAX HWIO kernel, the
    projection [P, D] becomes [D, P], embeddings go to `dtype`. With a
    `mesh` that has a model axis, the layers are this rank's slices (of a
    whole state dict, or one already sharded) and `"tp"` holds the mesh;
    on CUDA the shard widths must meet the kernels' constraints."""
    c = cfg.vision
    v = "vision_model."
    from dclip_tpu_torch.parallel.tp import model_axis, shard_clip_params

    tp = model_axis(mesh)
    if tp is not None:
        if sd[v + "encoder.layers.0.self_attn.q_proj.weight"].device.type == "cuda":
            _check_shard_widths(cfg, tp.model_size)
        if sd[v + "encoder.layers.0.self_attn.q_proj.weight"].shape[0] == c.hidden_size:
            sd = shard_clip_params({k: t for k, t in sd.items() if k.startswith(v)}
                                   | {"visual_projection.weight": sd["visual_projection.weight"]},
                                   tp)

    def t(name):
        return sd[v + name].detach()

    patch = t("embeddings.patch_embedding.weight")  # [D, 3, p, p]
    return {
        "patch_w": patch.permute(2, 3, 1, 0).reshape(-1, c.hidden_size).to(dtype).contiguous(),
        "class_emb": t("embeddings.class_embedding").to(dtype),
        "pos_emb": t("embeddings.position_embedding.weight").to(dtype),
        "pre_ln_scale": t("pre_layrnorm.weight").float(),
        "pre_ln_bias": t("pre_layrnorm.bias").float(),
        "layers": [pack_layer(sd, f"{v}encoder.layers.{i}.", dtype)
                   for i in range(c.num_layers)],
        "post_ln_scale": t("post_layernorm.weight").float(),
        "post_ln_bias": t("post_layernorm.bias").float(),
        "proj": sd["visual_projection.weight"].detach().t().to(dtype).contiguous(),
        "tp": tp,
    }


# -- the image tower -----------------------------------------------------------


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, (H/p)(W/p), p*p*C] in (ph, pw, c) order, so
    `patchify(x) @ W` is the stride-p VALID convolution with the HWIO kernel
    W reshaped to [p*p*C, D] (exact: no TF32 convolution path)."""
    b, h, w, ch = pixel_values.shape
    x = pixel_values.reshape(b, h // patch, patch, w // patch, patch, ch)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // patch) * (w // patch), -1)


def _image_features(cfg, w: Mapping[str, object], pixel_values: torch.Tensor,
                    encoder: Callable) -> torch.Tensor:
    c = cfg.vision
    dtype = w["patch_w"].dtype
    x = patchify(pixel_values.to(dtype), c.patch_size) @ w["patch_w"]
    b = x.shape[0]
    cls = w["class_emb"].reshape(1, 1, -1).expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + w["pos_emb"][None]
    x = layernorm_reference(x.float(), w["pre_ln_scale"], w["pre_ln_bias"],
                            c.layer_norm_eps).to(dtype)
    tp = w.get("tp")
    if tp is not None:
        x = encoder_forward_tp(w["layers"], x.contiguous(), c.num_heads // tp.model_size,
                               c.layer_norm_eps, tp)
    else:
        x = encoder(w["layers"], x.contiguous(), c.num_heads, c.layer_norm_eps)
    pooled = layernorm_reference(x[:, 0].float(), w["post_ln_scale"],
                                 w["post_ln_bias"], c.layer_norm_eps).to(dtype)
    return pooled @ w["proj"]


def fused_image_features_reference(cfg, w: Mapping[str, object],
                                   pixel_values: torch.Tensor) -> torch.Tensor:
    return _image_features(cfg, w, pixel_values, encoder_forward_reference)


def fused_image_features(cfg, w: Mapping[str, object],
                         pixel_values: torch.Tensor) -> torch.Tensor:
    """`get_image_features` of the frozen image tower: patch embedding,
    CLS + position embedding, pre-LN, post-LN and projection as plain
    tensor ops (the JAX version leaves them to XLA), the encoder stack as
    fused block kernels (a mesh's shard: `encoder_forward_tp`).
    pixel_values: NHWC [B, H, W, 3], CLIP-normalized. `w` comes from
    `pack_vision_weights`; its dtype is the compute dtype."""
    if _on_cpu(pixel_values):
        return fused_image_features_reference(cfg, w, pixel_values)
    out = _image_features(cfg, w, pixel_values, encoder_forward_fused)
    LAUNCHES["image_features"] += 1
    return out
