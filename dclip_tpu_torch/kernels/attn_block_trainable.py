"""The attention sub-block of a trainable, maskless encoder layer.

Counterpart of `dclip_tpu/kernels/attn_block_trainable.py` (K9,
`attention_block_trainable`, whose `_fwd_call`:155 runs `_fwd_kernel`:78):

  o = x + out_proj(MHA(LN1(x)))

differentiable in x and in all ten weights (HF layout: q/k/v/out_proj
.weight [D, D] as [out, in], biases [D]; LN1 scale and bias), valid under
any trainable mask. It serves the vision tower: no causal, padding or
segment mask (the text tower keeps `kernels.vit_attention` with its
in-kernel masks). On the card:

  forward   LN1 (csrc/layernorm.cu); one QKV product over [Wq; Wk; Wv]
            concatenated to [3D, D] and cast once per call (csrc/gemm.cu,
            NT mode); attention with the stats m (log2-domain max) and
            rinv per (row, head), the contract of the port's K4
            (`kernels.vit_attention.self_attention_fwd_stats`); out_proj +
            bias + residual (csrc/gemm.cu, NT). The TPU kernel runs all of
            it in one program per image with every weight in VMEM; a Hopper
            SM holds 227 KB, so the pieces are the port's tiled kernels. It
            emits what `_fwd_kernel` emits: o, q, k, v (thirds of one
            [B, S, 3D] buffer), attn, m, rinv, and saves the LN output h.
  backward  attn_block_trainable.py:224-289, with every product on the
            port's kernels where the JAX package leaves them to XLA:
            g Wo (NN), dWo = g^T attn (TN, split over rows), dbo = sum g;
            dq, dk, dv by the port's K5 (`self_attention_bwd_stats`) into
            one [B, S, 3D] buffer; dWqkv = dqkv^T h (TN) and the bias sums;
            dh = dqkv [Wq; Wk; Wv] in f32 (NN); the LN1 backward with its
            weight gradients (csrc/layernorm.cu).

Weight-gradient launches are skipped for weights that need no gradient
(`ctx.needs_input_grad`): under the default mask the vision LN1 is frozen
(its backward is then K6's dx-only LayerNorm backward), and the dh product
and the LayerNorm backward are skipped when neither x nor LN1 needs a
gradient (the first layer, whose input comes from frozen embeddings).

On CPU tensors the forward and backward run the plain f32 twins
(`attention_block_trainable_fwd_reference`, `..._bwd_reference`).
CUDA: x bf16, head_dim 64 (the port's attention kernels).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from dclip_tpu_torch.kernels.mlp_frozen import layernorm_bwd, layernorm_bwd_reference
from dclip_tpu_torch.kernels.trainable_ops import colsum, gemm_nt, gemm_tn, layernorm_bwd_wgrad
from dclip_tpu_torch.kernels.vit_attention import (
    attention_bwd_reference,
    attention_reference,
    self_attention_bwd_stats,
    self_attention_fwd_stats,
)
from dclip_tpu_torch.kernels.vit_block import (
    _on_cpu,
    gemm_bias_act_residual,
    layernorm,
    layernorm_reference,
)

LAUNCHES: Dict[str, int] = {"attn_block_trainable_fwd": 0, "attn_block_trainable_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_trainable_attn(ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                        dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The kernels' operands: [Wq; Wk; Wv] [3D, D] and Wo [D, D] in `dtype`
    (NT in the forward, NN in the backward), LN params and biases f32."""
    def f32(*ts):
        return torch.cat([t.detach().float() for t in ts]).contiguous()

    return {"ln_scale": f32(ln_scale), "ln_bias": f32(ln_bias),
            "wqkv": torch.cat([w.detach().to(dtype) for w in (wq, wk, wv)]).contiguous(),
            "bqkv": f32(bq, bk, bv), "wo": wo.detach().to(dtype).contiguous(), "bo": f32(bo)}


def _thirds(t: torch.Tensor):
    d = t.shape[-1] // 3
    return t[..., :d], t[..., d:2 * d], t[..., 2 * d:]


# -- plain twins ----------------------------------------------------------------------


def attention_block_trainable_fwd_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo,
                                            bo, num_heads: int, eps: float = 1e-5):
    """`_fwd_kernel` in f32: (o, q, k, v, attn, m, rinv); o, q, k, v, attn
    in x's dtype, m and rinv [B, S, H] f32."""
    xf = x.float()
    h = layernorm_reference(xf, ln_scale, ln_bias, eps)
    q, k, v = (h @ w.float().t() + b.float() for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    attn, m, rinv = attention_reference(q, k, v, num_heads, stats=True)
    o = xf + attn @ wo.float().t() + bo.float()
    dt = x.dtype
    return o.to(dt), q.to(dt), k.to(dt), v.to(dt), attn.to(dt), m, rinv


def attention_block_trainable_bwd_reference(x, g, q, k, v, attn, m, rinv, ln_scale, ln_bias, wq,
                                            bq, wk, bk, wv, bv, wo, bo, num_heads: int,
                                            eps: float = 1e-5):
    """The VJP of attn_block_trainable.py:224-289 in f32: (dx, dln_scale,
    dln_bias, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo), dx in g's dtype and
    the weight gradients f32 in HF layout."""
    def flat(t):
        return t.float().reshape(-1, t.shape[-1])

    gf = g.float()
    ga = gf @ wo.float()
    dq, dk, dv = attention_bwd_reference(q.float(), k.float(), v.float(), ga, attn.float(), m,
                                         rinv, num_heads)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    h = xhat * ln_scale.float() + ln_bias.float()
    dh = dq @ wq.float() + dk @ wk.float() + dv @ wv.float()
    dx = layernorm_bwd_reference(x, g, dh, ln_scale, eps)
    wgrads = []
    for dt in (dq, dk, dv):
        wgrads += [flat(dt).t() @ flat(h), flat(dt).sum(0)]
    return (dx, (flat(dh) * flat(xhat)).sum(0), flat(dh).sum(0), *wgrads,
            flat(gf).t() @ flat(attn), flat(gf).sum(0))


# -- the kernels ------------------------------------------------------------------------


def attention_block_trainable_fwd(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                                  num_heads: int, eps: float = 1e-5):
    """(o, h, qkv, attn, m, rinv) over x [B, S, D]; `p` from
    `pack_trainable_attn`. CUDA only."""
    h = layernorm(x, p["ln_scale"], p["ln_bias"], eps)
    qkv = gemm_nt(h, p["wqkv"], p["bqkv"])
    attn, m, rinv = self_attention_fwd_stats(*_thirds(qkv), num_heads)
    o = gemm_nt(attn, p["wo"], p["bo"], residual=x)
    LAUNCHES["attn_block_trainable_fwd"] += 1
    return o, h, qkv, attn, m, rinv


def attention_block_trainable_bwd(x, g, h, qkv, attn, m, rinv, p: Mapping[str, torch.Tensor],
                                  num_heads: int, eps: float = 1e-5, needs=(True,) * 11):
    """The eleven gradients of `attention_block_trainable_bwd_reference`,
    None where `needs` (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo,
    bo) is False. CUDA only."""
    need_x, need_ls, need_lb = needs[:3]
    need_w, need_b = needs[3:9:2], needs[4:9:2]
    need_ln = need_ls or need_lb
    g = g.to(x.dtype).contiguous()
    grads = [None] * 11
    if needs[9]:
        grads[9] = gemm_tn(g, attn)
    if needs[10]:
        grads[10] = colsum(g)
    ga = gemm_bias_act_residual(g, p["wo"])
    dqkv = torch.empty_like(qkv)
    self_attention_bwd_stats(*_thirds(qkv), ga, attn, m, rinv, num_heads, out=_thirds(dqkv))
    if any(need_w):
        grads[3:9:2] = [t if need else None
                        for t, need in zip(gemm_tn(dqkv, h).chunk(3), need_w)]
    if any(need_b):
        grads[4:9:2] = [t if need else None for t, need in zip(colsum(dqkv).chunk(3), need_b)]
    if need_x or need_ln:
        dh = gemm_bias_act_residual(dqkv, p["wqkv"], out_dtype=torch.float32)
        if need_ln:
            grads[0:3] = layernorm_bwd_wgrad(x, g, dh, p["ln_scale"], eps, need_dx=need_x)
        else:
            grads[0] = layernorm_bwd(x, g, dh, p["ln_scale"], eps)
    LAUNCHES["attn_block_trainable_bwd"] += 1
    return tuple(grads)


class _AttnBlockTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, num_heads, eps):
        weights = (ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo)
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.dtypes = [t.dtype for t in (x,) + weights]
        if _on_cpu(x, *weights):
            o, q, k, v, attn, m, rinv = attention_block_trainable_fwd_reference(
                x, *weights, num_heads, eps)
            ctx.save_for_backward(x, q, k, v, attn, m, rinv, *weights)
            ctx.packed = None
            return o
        ctx.packed = pack_trainable_attn(*weights, dtype=x.dtype)
        o, h, qkv, attn, m, rinv = attention_block_trainable_fwd(x, ctx.packed, num_heads, eps)
        ctx.save_for_backward(x, h, qkv, attn, m, rinv)
        return o

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:11]
        if ctx.packed is None:
            x, q, k, v, attn, m, rinv, *weights = ctx.saved_tensors
            grads = attention_block_trainable_bwd_reference(x, g, q, k, v, attn, m, rinv,
                                                            *weights, ctx.num_heads, ctx.eps)
            grads = [t if need else None for t, need in zip(grads, needs)]
        else:
            x, h, qkv, attn, m, rinv = ctx.saved_tensors
            grads = attention_block_trainable_bwd(x, g, h, qkv, attn, m, rinv, ctx.packed,
                                                  ctx.num_heads, ctx.eps, needs)
        return tuple(None if t is None else t.to(dt) for t, dt in zip(grads, ctx.dtypes)) \
            + (None, None)


def attention_block_trainable(x: torch.Tensor, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                              num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x + out_proj(MHA(LN1(x))) over x [B, S, D] without masks,
    differentiable in x and the ten weights (HF layout, any dtype;
    gradients in the weights' dtype)."""
    return _AttnBlockTrainable.apply(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                                     num_heads, eps)
