"""Fused bidirectional cross-attention on Hopper (K10; counterpart of
`dclip_tpu/kernels/cross_attention.py:202` `cross_attention_fused`):

    attended_text  = LN(text  + MHA(q=text,  kv=image, key mask = image_mask))
    attended_image = LN(image + MHA(q=image, kv=text,  key mask = text_mask))

The TPU kernel runs one program per batch row with the eight projection
matrices resident in VMEM. Here one call is six launches:

  gemm_bias_act_residual x2   text rows @ [Wq_t2i | Wk_i2t | Wv_i2t] and
                              image rows @ [Wq_i2t | Wk_t2i | Wv_t2i]
                              ([D, 3D] each, + bias, f32 out; `csrc/gemm.cu`,
                              bf16 tensor cores)
  cross_attention_core        both directions, grid (batch, head, direction)
                              (`csrc/cross_attention.cu`), bf16 out
  gemm_bias_act_residual x2   the out-projections (+ bias, f32 out)
  add_layernorm_f32           residual + LayerNorm of both streams in f32
                              (`csrc/cross_attention.cu`)

The algebra is the TPU kernel's (`_kernel`, `_mha`): q scaled by
head_dim**-0.5, f32 logits, a masked key at the finite -1e30 (a row with
no valid key averages the values uniformly), f32 softmax, LayerNorm eps
1e-5 in f32; a single-sided mask is completed with ones; the outputs take
the inputs' dtype. The GEMMs take bf16 operands: the weights are rounded
once when packed, the inputs when they enter (exact for the trainer's
inputs, bf16 features times 0/1 masks); the residual enters the LayerNorm
in f32.

Weights come packed by `pack_cross_attention` from the port's teacher
state dict (`cross_modal_attention.*`, torch `nn.MultiheadAttention`
names): once for the frozen teacher, on every call for the trainable
form `cross_attention_trainable` (the teacher trainer's; its backward
recomputes through `models.cross_modal`). Every wrapper has its plain twin
(`*_reference`) in f32; a wrapper takes it only when its tensors lie on
the CPU, and for CUDA tensors launches its kernels or raises.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.profiler import record_function

from dclip_tpu_torch.kernels._build import check, load_library
from dclip_tpu_torch.kernels.vit_block import _on_cpu, _stream, gemm_bias_act_residual
from dclip_tpu_torch.models.cross_modal import CrossModalAttention

NEG = -1e30
EPS = 1e-5
MAX_KEYS = 128  # the core keeps four key slots per lane

LAUNCHES: Dict[str, int] = {
    "cross_attention_core": 0,
    "add_layernorm_f32": 0,
    "cross_attention": 0,
    "cross_attention_trainable": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_cross_attention(sd: Mapping[str, torch.Tensor], dtype: torch.dtype,
                         prefix: str = "cross_modal_attention.") -> Dict[str, torch.Tensor]:
    """The teacher's `CrossModalAttention` weights in the kernel's layout:
    GEMM weights [in, out] in `dtype` (the two [D, 3D] input projections of
    the concatenated q/k/v rows, the two [D, D] out-projections), biases and
    LayerNorm parameters in f32, on the weights' device."""

    def t(name):
        return sd[prefix + name].detach()

    d = t("text_to_image.in_proj_weight").shape[1]

    def in_proj(q_dir, kv_dir):
        w = torch.cat([t(f"{q_dir}.in_proj_weight")[:d], t(f"{kv_dir}.in_proj_weight")[d:]])
        b = torch.cat([t(f"{q_dir}.in_proj_bias")[:d], t(f"{kv_dir}.in_proj_bias")[d:]])
        return w.t().to(dtype).contiguous(), b.float().contiguous()

    w_text, b_text = in_proj("text_to_image", "image_to_text")
    w_image, b_image = in_proj("image_to_text", "text_to_image")
    return {
        "w_text": w_text, "b_text": b_text, "w_image": w_image, "b_image": b_image,
        "wo_t2i": t("text_to_image.out_proj.weight").t().to(dtype).contiguous(),
        "bo_t2i": t("text_to_image.out_proj.bias").float().contiguous(),
        "wo_i2t": t("image_to_text.out_proj.weight").t().to(dtype).contiguous(),
        "bo_i2t": t("image_to_text.out_proj.bias").float().contiguous(),
        "lnt_scale": t("norm_text.weight").float().contiguous(),
        "lnt_bias": t("norm_text.bias").float().contiguous(),
        "lni_scale": t("norm_image.weight").float().contiguous(),
        "lni_bias": t("norm_image.bias").float().contiguous(),
    }


def _masks(text, image, text_mask, image_mask):
    """Both masks as f32 [B, S], or (None, None): a single-sided mask is
    completed with ones, as the TPU kernel does (cross_attention.py:214-220)."""
    if text_mask is None and image_mask is None:
        return None, None
    if text_mask is None:
        text_mask = torch.ones(text.shape[:2], dtype=torch.float32, device=text.device)
    if image_mask is None:
        image_mask = torch.ones(image.shape[:2], dtype=torch.float32, device=image.device)
    return text_mask.float().contiguous(), image_mask.float().contiguous()


# -- plain twins ----------------------------------------------------------------


def _direction_reference(q, k, v, key_mask, num_heads):
    """[B, Sq, D] x [B, Sk, D] f32 -> [B, Sq, D] f32: `_mha` between its
    projections."""
    b, sq, d = q.shape
    hd = d // num_heads

    def heads(x):
        return x.reshape(b, x.shape[1], num_heads, hd).transpose(1, 2)

    logits = heads(q * hd**-0.5) @ heads(k).transpose(-1, -2)
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, NEG))
    probs = torch.softmax(logits, dim=-1)
    return (probs @ heads(v)).transpose(1, 2).reshape(b, sq, d)


def cross_attention_core_reference(qkv_t, qkv_i, text_mask, image_mask, num_heads: int):
    """(out_t [B, T, D], out_i [B, P, D]) in f32 from the f32 input
    projections qkv_t [B, T, 3D], qkv_i [B, P, 3D] (q | k | v)."""
    d = qkv_t.shape[-1] // 3
    qt, kt, vt = qkv_t.float().split(d, -1)
    qi, ki, vi = qkv_i.float().split(d, -1)
    return (_direction_reference(qt, ki, vi, image_mask, num_heads),
            _direction_reference(qi, kt, vt, text_mask, num_heads))


def add_layernorm_reference(x, a, scale, bias, eps: float = EPS):
    z = x.float() + a.float()
    mean = z.mean(-1, keepdim=True)
    var = (z - mean).square().mean(-1, keepdim=True)
    return (z - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def cross_attention_reference(p: Mapping[str, torch.Tensor], text: torch.Tensor,
                              image: torch.Tensor, text_mask=None, image_mask=None,
                              num_heads: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's algebra in f32, from the packed weights."""
    tm, im = _masks(text, image, text_mask, image_mask)
    tf, imf = text.float(), image.float()
    qkv_t = tf @ p["w_text"].float() + p["b_text"]
    qkv_i = imf @ p["w_image"].float() + p["b_image"]
    at, ai = cross_attention_core_reference(qkv_t, qkv_i, tm, im, num_heads)
    ot = add_layernorm_reference(tf, at @ p["wo_t2i"].float() + p["bo_t2i"],
                                 p["lnt_scale"], p["lnt_bias"])
    oi = add_layernorm_reference(imf, ai @ p["wo_i2t"].float() + p["bo_i2t"],
                                 p["lni_scale"], p["lni_bias"])
    return ot.to(text.dtype), oi.to(image.dtype)


# -- CUDA wrappers ----------------------------------------------------------------


def _f32(t: torch.Tensor, name: str, shape) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous, 16-byte aligned f32 tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def cross_attention_core(qkv_t: torch.Tensor, qkv_i: torch.Tensor, text_mask, image_mask,
                         num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both attention directions between the input projections; CUDA: qkv
    f32 contiguous, head_dim a multiple of 32 up to 128, 1 to 128 rows per
    stream; returns bf16."""
    if _on_cpu(qkv_t, qkv_i, text_mask, image_mask):
        return cross_attention_core_reference(qkv_t, qkv_i, text_mask, image_mask, num_heads)
    b, t, three_d = qkv_t.shape
    p, d = qkv_i.shape[1], three_d // 3
    hd = d // num_heads
    if three_d % 3 or d % num_heads or hd % 32 or hd > 128 \
            or not (1 <= t <= MAX_KEYS and 1 <= p <= MAX_KEYS):
        raise ValueError(f"cross_attention_core: needs head_dim % 32 == 0 and <= 128, and "
                         f"1..{MAX_KEYS} text and image rows, got qkv {tuple(qkv_t.shape)} / "
                         f"{tuple(qkv_i.shape)} with {num_heads} heads")
    _f32(qkv_t, "qkv_t", (b, t, three_d))
    _f32(qkv_i, "qkv_i", (b, p, three_d))
    if (text_mask is None) != (image_mask is None):
        raise ValueError("cross_attention_core: give both masks or neither")
    if text_mask is not None:
        _f32(text_mask, "text_mask", (b, t))
        _f32(image_mask, "image_mask", (b, p))
    lib = load_library()
    out_t = torch.empty((b, t, d), dtype=torch.bfloat16, device=qkv_t.device)
    out_i = torch.empty((b, p, d), dtype=torch.bfloat16, device=qkv_t.device)
    ptr = (lambda m: None if m is None else m.data_ptr())
    with torch.cuda.device(qkv_t.device):
        code = lib.dclip_cross_attention_core(
            qkv_t.data_ptr(), qkv_i.data_ptr(), ptr(text_mask), ptr(image_mask),
            out_t.data_ptr(), out_i.data_ptr(), b, t, p, d, num_heads, _stream(qkv_t))
    check(lib, code, "cross_attention_core")
    LAUNCHES["cross_attention_core"] += 1
    return out_t, out_i


def add_layernorm_f32(xs, scales, biases, eps: float = EPS):
    """LayerNorm(x + a) for the two streams of `xs` = ((x0, a0), (x1, a1)),
    with their own scale and bias: one launch. CUDA: f32, D % 4 == 0."""
    (x0, a0), (x1, a1) = xs
    if _on_cpu(x0, a0, x1, a1):
        return tuple(add_layernorm_reference(x, a, s, bb, eps)
                     for (x, a), s, bb in zip(xs, scales, biases))
    d = x0.shape[-1]
    if d % 4 or x1.shape[-1] != d:
        raise ValueError(f"add_layernorm_f32: needs D % 4 == 0, got {tuple(x0.shape)}, "
                         f"{tuple(x1.shape)}")
    for name, t, like in (("x0", x0, x0), ("a0", a0, x0), ("x1", x1, x1), ("a1", a1, x1)):
        _f32(t, name, like.shape)
    for name, t in (("scale0", scales[0]), ("bias0", biases[0]), ("scale1", scales[1]),
                    ("bias1", biases[1])):
        _f32(t, name, (d,))
    lib = load_library()
    y0, y1 = torch.empty_like(x0), torch.empty_like(x1)
    with torch.cuda.device(x0.device):
        code = lib.dclip_add_layernorm_f32(
            x0.data_ptr(), a0.data_ptr(), scales[0].data_ptr(), biases[0].data_ptr(),
            y0.data_ptr(), x0.numel() // d, x1.data_ptr(), a1.data_ptr(),
            scales[1].data_ptr(), biases[1].data_ptr(), y1.data_ptr(), x1.numel() // d, d,
            float(eps), _stream(x0))
    check(lib, code, "add_layernorm_f32")
    LAUNCHES["add_layernorm_f32"] += 1
    return y0, y1


def cross_attention_fused(p: Mapping[str, torch.Tensor], text: torch.Tensor, image: torch.Tensor,
                          text_mask: Optional[torch.Tensor] = None,
                          image_mask: Optional[torch.Tensor] = None,
                          num_heads: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 forward: text [B, T, D], image [B, P, D] (f32 or bf16), masks
    [B, T] / [B, P] (1 = valid) -> (attended_text, attended_image) in the
    inputs' dtypes. `p` comes from `pack_cross_attention` (bf16 for CUDA)."""
    if _on_cpu(text, image, text_mask, image_mask):
        return cross_attention_reference(p, text, image, text_mask, image_mask, num_heads)
    tm, im = _masks(text, image, text_mask, image_mask)
    tf, imf = text.float().contiguous(), image.float().contiguous()
    qkv_t = gemm_bias_act_residual(text.to(torch.bfloat16).contiguous(), p["w_text"],
                                   p["b_text"], out_dtype=torch.float32)
    qkv_i = gemm_bias_act_residual(image.to(torch.bfloat16).contiguous(), p["w_image"],
                                   p["b_image"], out_dtype=torch.float32)
    at, ai = cross_attention_core(qkv_t, qkv_i, tm, im, num_heads)
    ot = gemm_bias_act_residual(at, p["wo_t2i"], p["bo_t2i"], out_dtype=torch.float32)
    oi = gemm_bias_act_residual(ai, p["wo_i2t"], p["bo_i2t"], out_dtype=torch.float32)
    yt, yi = add_layernorm_f32(((tf, ot), (imf, oi)), (p["lnt_scale"], p["lni_scale"]),
                               (p["lnt_bias"], p["lni_bias"]))
    LAUNCHES["cross_attention"] += 1
    return yt.to(text.dtype), yi.to(image.dtype)


# -- the differentiable form ---------------------------------------------------------


class _CrossAttentionTrainable(torch.autograd.Function):
    """apply(text, image, text_mask, image_mask, num_heads, names, *params):
    masks already completed (`_masks`), `params` the live tensors named by
    `names` (`CrossModalAttention.named_parameters()`)."""

    @staticmethod
    def forward(ctx, text, image, text_mask, image_mask, num_heads, names, *params):
        on_cpu = _on_cpu(text, image, text_mask, image_mask)
        packed = pack_cross_attention(dict(zip(names, params)),
                                      torch.float32 if on_cpu else torch.bfloat16, prefix="")
        out = cross_attention_fused(packed, text, image, text_mask, image_mask, num_heads)
        if not on_cpu:
            LAUNCHES["cross_attention_trainable"] += 1
        ctx.num_heads, ctx.names = num_heads, names
        ctx.save_for_backward(text, image, text_mask, image_mask, *params)
        return out

    @staticmethod
    def backward(ctx, g_text, g_image):
        text, image, text_mask, image_mask, *params = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], ctx.needs_input_grad[1], *ctx.needs_input_grad[6:])
        with torch.enable_grad(), record_function("dclip.cross_attention_bwd"):
            leaves = [x.detach().float().requires_grad_(n)
                      for x, n in zip((text, image, *params), need)]
            module = CrossModalAttention(text.shape[-1], ctx.num_heads, device="meta")
            out = torch.func.functional_call(module, dict(zip(ctx.names, leaves[2:])),
                                             (leaves[0], leaves[1], text_mask, image_mask))
            got = iter(torch.autograd.grad(out, [x for x, n in zip(leaves, need) if n],
                                           (g_text.float(), g_image.float())))
        grads = [next(got).to(x.dtype) if n else None
                 for x, n in zip((text, image, *params), need)]
        return (grads[0], grads[1], None, None, None, None, *grads[2:])


def cross_attention_trainable(params: Mapping[str, torch.Tensor], text: torch.Tensor,
                              image: torch.Tensor, text_mask: Optional[torch.Tensor] = None,
                              image_mask: Optional[torch.Tensor] = None,
                              num_heads: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable K10 (counterpart of `dclip_tpu/kernels/cross_attention.py:148-198`).

    `params`: the 12 live parameters of a `models.cross_modal.CrossModalAttention`
    by their names in it (`text_to_image.in_proj_weight`, ..., `norm_image.bias`).
    Forward: `cross_attention_fused` on weights packed from `params` on every
    call (a pack made once would go stale as the parameters train), bf16
    on CUDA (K10's six launches), f32 for the plain twin on the CPU; the
    outputs take the inputs' dtypes. Backward, the JAX VJP's recipe
    (`:187-195`): no attention residuals are saved; the forward is recomputed
    in f32 through `CrossModalAttention` itself (`torch.func.functional_call`
    on the saved inputs and parameters) and differentiated with
    `torch.autograd.grad`, giving gradients for every parameter and both
    input streams, cast back to their dtypes. This backward is plain
    PyTorch by design: the JAX one is XLA, not Pallas, and a hand-written
    one waits until a profile of the teacher step ranks it among the top
    costs (ROADMAP Queue 2). A single-sided mask is completed with ones
    before both the forward and the recompute (`:165-175`), so the two
    never disagree."""
    tm, im = _masks(text, image, text_mask, image_mask)
    names = tuple(params)
    with record_function("dclip.cross_attention"):
        return _CrossAttentionTrainable.apply(text, image, tm, im, num_heads, names,
                                              *(params[n] for n in names))
