"""The MLP sub-block of a trainable encoder layer, with every gradient.

Counterpart of `dclip_tpu/kernels/mlp_trainable.py` (K8,
`mlp_block_trainable`):

  y = x + fc2(quick_gelu(fc1(LN2(x))))

differentiable in x and in all six weights, valid under any trainable
mask (the student's text tower trains every leaf). Weights enter in HF
layout (fc1.weight [mlp, D], fc2.weight [D, mlp]) and f32; each call casts
the two matrices to the compute dtype once, since they change every step.
On the card:

  forward   LN2 (csrc/layernorm.cu), fc1 + quick-GELU saving the
            pre-activation a1 beside the GELU output, fc2 + bias +
            residual (csrc/gemm.cu, NT mode on the HF weights): K6's
            forward (`_fwd_save_kernel`, mlp_frozen.py:135), which both JAX
            paths share. It saves x, the LN output h, a1 and the GELU output
            for the backward.
  backward  da1 = (g W2) * quick_gelu'(a1)  (csrc/gemm.cu, NN, epilogue 2)
            dh  = da1 W1 in f32              (csrc/gemm.cu, NN, f32 out)
            dx, dln_scale, dln_bias          (csrc/layernorm.cu weight-
                                              gradient backward)
            dW2 = g^T gelu(a1), dW1 = da1^T h (csrc/gemm.cu, TN mode, rows
                                              split, then csrc/reduce.cu)
            db2 = sum g, db1 = sum da1       (csrc/reduce.cu column sums)

The TPU's two backward kernels (`_bwd_a_kernel`:82, `_bwd_b_kernel`:134)
never write da1 to HBM: kernel B recomputes it chunk by chunk. Here da1 is
written once (bf16, [B, S, mlp]) and read by the dh product, the dW1
product and the db1 sum: three plain passes instead of one GEMM more, and
no kernel holds weight-gradient sums across a batch grid (Hopper blocks
run in no order). Weight-gradient launches are skipped for the weights
that need no gradient (`ctx.needs_input_grad`), and the dh product and the
LayerNorm backward when neither x nor the LayerNorm needs one.

On CPU tensors the forward and backward run the plain f32 twins
(`mlp_trainable_fwd_reference`, `mlp_trainable_bwd_reference`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from dclip_tpu_torch.kernels.mlp_frozen import layernorm_bwd, layernorm_bwd_reference
from dclip_tpu_torch.kernels.trainable_ops import colsum, gemm_nt, gemm_tn, layernorm_bwd_wgrad
from dclip_tpu_torch.kernels.vit_block import (
    _on_cpu,
    gemm_bias_act_residual,
    layernorm,
    layernorm_reference,
    quick_gelu,
    quick_gelu_grad,
)

LAUNCHES: Dict[str, int] = {"mlp_trainable_fwd": 0, "mlp_trainable_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_trainable_mlp(ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                       dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The kernels' operands: fc1.weight [mlp, D] and fc2.weight [D, mlp]
    in `dtype`, as they are (NT in the forward, NN in the backward); LN
    params and biases f32."""
    def f32(t):
        return t.detach().float().contiguous()

    return {"ln_scale": f32(ln_scale), "ln_bias": f32(ln_bias),
            "w1": fc1_weight.detach().to(dtype).contiguous(), "b1": f32(fc1_bias),
            "w2": fc2_weight.detach().to(dtype).contiguous(), "b2": f32(fc2_bias)}


# -- plain twins ----------------------------------------------------------------------


def mlp_trainable_fwd_reference(x, ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                                fc2_bias, eps: float = 1e-5):
    """`_fwd_save_kernel` in f32 on HF-layout weights: (y, a1) in x's dtype."""
    xf = x.float()
    h = layernorm_reference(xf, ln_scale, ln_bias, eps)
    a1 = h @ fc1_weight.float().t() + fc1_bias.float()
    y = xf + quick_gelu(a1) @ fc2_weight.float().t() + fc2_bias.float()
    return y.to(x.dtype), a1.to(x.dtype)


def mlp_trainable_bwd_reference(x, g, a1, ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                                fc2_bias, eps: float = 1e-5):
    """`_bwd_a_kernel` + `_bwd_b_kernel` in f32 from the saved a1: (dx,
    dln_scale, dln_bias, dfc1_weight, dfc1_bias, dfc2_weight, dfc2_bias),
    dx in g's dtype, the weight gradients f32 in HF layout."""
    xf = x.float()
    gf = g.float()
    a1f = a1.float()
    h = layernorm_reference(xf, ln_scale, ln_bias, eps)
    da1 = (gf @ fc2_weight.float()) * quick_gelu_grad(a1f)
    dh = da1 @ fc1_weight.float()
    dx = layernorm_bwd_reference(x, g, dh, ln_scale, eps)
    mean = xf.mean(-1, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    return (dx, (flat(dh) * flat(xhat)).sum(0), flat(dh).sum(0),
            flat(da1).t() @ flat(h), flat(da1).sum(0),
            flat(gf).t() @ flat(quick_gelu(a1f)), flat(gf).sum(0))


# -- the kernels ------------------------------------------------------------------------


def mlp_trainable_fwd(x: torch.Tensor, p: Mapping[str, torch.Tensor], eps: float = 1e-5):
    """(y, a1, h, act) over x [B, S, D]: the block's output, the fc1
    pre-activation, the LN output and the GELU output; `p` from
    `pack_trainable_mlp`. CUDA only."""
    h = layernorm(x, p["ln_scale"], p["ln_bias"], eps)
    act, a1 = gemm_nt(h, p["w1"], p["b1"], gelu=True, save_preact=True)
    y = gemm_nt(act, p["w2"], p["b2"], residual=x)
    LAUNCHES["mlp_trainable_fwd"] += 1
    return y, a1, h, act


def mlp_trainable_bwd(x, g, a1, h, act, p: Mapping[str, torch.Tensor], eps: float = 1e-5,
                      needs=(True,) * 7):
    """The seven gradients of `mlp_trainable_bwd_reference` from the saved
    tensors, None where `needs` (x, ln_scale, ln_bias, w1, b1, w2, b2) is
    False. CUDA only."""
    need_x, need_ls, need_lb, need_w1, need_b1, need_w2, need_b2 = needs
    need_ln = need_ls or need_lb
    g = g.to(x.dtype).contiguous()
    dx = dls = dlb = dw1 = db1 = dw2 = db2 = None
    if need_x or need_ln or need_w1 or need_b1:
        da1 = gemm_bias_act_residual(g, p["w2"], dgelu_of=a1)
        if need_x or need_ln:
            dh = gemm_bias_act_residual(da1, p["w1"], out_dtype=torch.float32)
            if need_ln:
                dx, dls, dlb = layernorm_bwd_wgrad(x, g, dh, p["ln_scale"], eps, need_dx=need_x)
            else:
                dx = layernorm_bwd(x, g, dh, p["ln_scale"], eps)
        if need_w1:
            dw1 = gemm_tn(da1, h)
        if need_b1:
            db1 = colsum(da1)
    if need_w2:
        dw2 = gemm_tn(g, act)
    if need_b2:
        db2 = colsum(g)
    LAUNCHES["mlp_trainable_bwd"] += 1
    return dx, dls, dlb, dw1, db1, dw2, db2


class _MLPTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias, eps,
                packed):
        weights = (ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias)
        ctx.eps = eps
        ctx.dtypes = [t.dtype for t in (x,) + weights]
        if _on_cpu(x, *weights):
            y, a1 = mlp_trainable_fwd_reference(x, *weights, eps)
            ctx.save_for_backward(x, a1, *weights)
            ctx.packed = None
            return y
        ctx.packed = packed if packed is not None else pack_trainable_mlp(*weights,
                                                                          dtype=x.dtype)
        y, a1, h, act = mlp_trainable_fwd(x, ctx.packed, eps)
        ctx.save_for_backward(x, a1, h, act)
        return y

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:7]
        if ctx.packed is None:
            x, a1, *weights = ctx.saved_tensors
            grads = mlp_trainable_bwd_reference(x, g, a1, *weights, ctx.eps)
            grads = tuple(t if need else None for t, need in zip(grads, needs))
        else:
            x, a1, h, act = ctx.saved_tensors
            grads = mlp_trainable_bwd(x, g, a1, h, act, ctx.packed, ctx.eps, needs)
        return tuple(None if t is None else t.to(dt) for t, dt in zip(grads, ctx.dtypes)) \
            + (None, None)


def mlp_block_trainable(x: torch.Tensor, ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                        fc2_bias, eps: float = 1e-5, packed=None) -> torch.Tensor:
    """x + fc2(quick_gelu(fc1(LN(x)))) over x [B, S, D], differentiable in
    x and the six weights (HF layout, any dtype; gradients in the weights'
    dtype). CUDA: x bf16, D % 32 == 0, mlp % 32 == 0. `packed`: this
    call's `pack_trainable_mlp` of the same weights, made here when None."""
    return _MLPTrainable.apply(x, ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                               eps, packed)
