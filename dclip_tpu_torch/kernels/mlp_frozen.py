"""The MLP sub-block of a frozen-weight encoder layer, differentiable in x.

Counterpart of `dclip_tpu/kernels/mlp_frozen.py` (K6, the weights-resident
pair `_mlp_block_frozen_resident`):

  y = x + fc2(act(fc1(LN2(x))))

(`act` quick-GELU, or SigLIP's tanh-GELU "gelu_pytorch_tanh") with zero
weight cotangents by contract: the student's default trainable
mask freezes every vision `mlp` and `layer_norm2` leaf, so the backward
needs only dx. On the card:

  forward   layernorm (csrc/layernorm.cu), then fc1 + the activation with
            the pre-activation a1 [.., mlp] saved beside its output
            (csrc/gemm.cu, epilogue 1 or 3 with aux_out), then fc2 + bias +
            residual (csrc/gemm.cu): the serving MLP block plus one
            store of a1
  backward  da1 = (g W2^T) * act'(a1)          (csrc/gemm.cu, epilogue 2 or 4)
            dh  = da1 W1^T into f32            (csrc/gemm.cu, f32 output)
            dx  = g + LN_bwd(dh), statistics recomputed from x
                                               (csrc/layernorm.cu backward)

W2^T and W1^T in the GEMM's [K, N] row-major layout are exactly HF's
`fc2.weight` [D, mlp] and `fc1.weight` [mlp, D]; with the forward's
[in, out] copies they are cast to the compute dtype once
(`pack_frozen_mlp`), since they are frozen while this path is on. The
weight-streaming TPU variant (K7, `_mlp_block_frozen_tiled`, L/14) needs no
counterpart here: these GEMMs tile at every width.

The no-grad call runs the serving block `vit_block.mlp_block_fused` (the
JAX primal runs `_mlp_kernel`). `mlp_block_frozen` raises if any of the six weights
requires grad: its autograd.Function returns None for them.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from dclip_tpu_torch.kernels import vit_block
from dclip_tpu_torch.kernels._build import check, load_library
from dclip_tpu_torch.kernels.vit_block import (
    LAYERNORM_MAX_D,
    _on_cpu,
    _require,
    _stream,
    activation,
    gemm_bias_act_residual,
    layernorm,
    layernorm_reference,
)

LAUNCHES: Dict[str, int] = {
    "layernorm_bwd": 0,
    "mlp_frozen_fwd": 0,
    "mlp_frozen_bwd": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_frozen_mlp(ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """HF-layout weights (fc1.weight [mlp, D], fc2.weight [D, mlp]) -> the
    kernels' operands: `vit_block.pack_layer`'s MLP keys ([in, out] GEMM
    weights in `dtype`, LN params and biases in f32) plus the backward's
    `fc1_wt` [mlp, D] and `fc2_wt` [D, mlp] in `dtype`."""
    def f32(t):
        return t.detach().float().contiguous()

    def cast(t):
        return t.detach().to(dtype).contiguous()

    return {
        "ln2_scale": f32(ln_scale), "ln2_bias": f32(ln_bias),
        "fc1_w": cast(fc1_weight.t()), "fc1_b": f32(fc1_bias),
        "fc2_w": cast(fc2_weight.t()), "fc2_b": f32(fc2_bias),
        "fc1_wt": cast(fc1_weight), "fc2_wt": cast(fc2_weight),
    }


# -- layernorm backward ---------------------------------------------------------


def layernorm_bwd_reference(x, g, dh, scale, eps: float = 1e-5):
    """dx = g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) with
    dxhat = dh * scale (mlp_frozen.py:193-198), in f32; returns g's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxhat = dh.float() * scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (g.float() + rstd * (dxhat - m1 - xhat * m2)).to(g.dtype)


def layernorm_bwd(x: torch.Tensor, g: torch.Tensor, dh: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm backward in x (frozen scale / bias) plus the residual g.
    CUDA: x, g bf16 [..., D]; dh f32 like x; scale f32 [D]; D % 8 == 0,
    D <= 1280."""
    if _on_cpu(x, g, dh, scale):
        return layernorm_bwd_reference(x, g, dh, scale, eps)
    d = x.shape[-1]
    _require(x, "x", torch.bfloat16, x.dim())
    _require(g, "g", torch.bfloat16, x.dim())
    _require(dh, "dh", torch.float32, x.dim())
    _require(scale, "scale", torch.float32, 1)
    if g.shape != x.shape or dh.shape != x.shape or scale.shape[0] != d or d % 8 \
            or d > LAYERNORM_MAX_D or x.numel() == 0:
        raise ValueError(f"layernorm_bwd: bad shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"dh {tuple(dh.shape)}, scale {tuple(scale.shape)}")
    lib = load_library()
    dx = torch.empty_like(g)
    with torch.cuda.device(x.device):
        code = lib.dclip_layernorm_bwd_bf16(x.data_ptr(), g.data_ptr(), dh.data_ptr(),
                                            scale.data_ptr(), dx.data_ptr(), x.numel() // d, d,
                                            float(eps), _stream(x))
    check(lib, code, "layernorm_bwd")
    LAUNCHES["layernorm_bwd"] += 1
    return dx


# -- the frozen MLP pair --------------------------------------------------------


def mlp_frozen_fwd_reference(x, p: Mapping[str, torch.Tensor], eps: float = 1e-5,
                             act: str = "quick_gelu"):
    """`_fwd_save_kernel` in f32: (y, a1), both in x's dtype."""
    xf = x.float()
    h = layernorm_reference(xf, p["ln2_scale"], p["ln2_bias"], eps)
    a1 = h @ p["fc1_w"].float() + p["fc1_b"]
    y = xf + activation(act)[0](a1) @ p["fc2_w"].float() + p["fc2_b"]
    return y.to(x.dtype), a1.to(x.dtype)


def mlp_frozen_fwd(x: torch.Tensor, p: Mapping[str, torch.Tensor], eps: float = 1e-5,
                   act: str = "quick_gelu"):
    """(y, a1) over x [B, S, D]; `p` from `pack_frozen_mlp`."""
    if _on_cpu(x):
        return mlp_frozen_fwd_reference(x, p, eps, act)
    h = layernorm(x, p["ln2_scale"], p["ln2_bias"], eps)
    out, a1 = gemm_bias_act_residual(h, p["fc1_w"], p["fc1_b"], gelu=True, save_preact=True,
                                     act=act)
    y = gemm_bias_act_residual(out, p["fc2_w"], p["fc2_b"], residual=x)
    LAUNCHES["mlp_frozen_fwd"] += 1
    return y, a1


def mlp_frozen_bwd_reference(x, g, a1, p: Mapping[str, torch.Tensor], eps: float = 1e-5,
                             act: str = "quick_gelu"):
    """`_bwd_dx_kernel` in f32: dx in g's dtype."""
    da1 = (g.float() @ p["fc2_wt"].float()) * activation(act)[1](a1.float())
    dh = da1 @ p["fc1_wt"].float()
    return layernorm_bwd_reference(x, g, dh, p["ln2_scale"], eps)


def mlp_frozen_bwd(x: torch.Tensor, g: torch.Tensor, a1: torch.Tensor,
                   p: Mapping[str, torch.Tensor], eps: float = 1e-5,
                   act: str = "quick_gelu") -> torch.Tensor:
    """dx of y = x + fc2(act(fc1(LN2(x)))) given dy = g."""
    if _on_cpu(x, g, a1):
        return mlp_frozen_bwd_reference(x, g, a1, p, eps, act)
    g = g.to(x.dtype).contiguous()
    da1 = gemm_bias_act_residual(g, p["fc2_wt"], dgelu_of=a1, act=act)
    dh = gemm_bias_act_residual(da1, p["fc1_wt"], out_dtype=torch.float32)
    dx = layernorm_bwd(x, g, dh, p["ln2_scale"], eps)
    LAUNCHES["mlp_frozen_bwd"] += 1
    return dx


class _MLPFrozen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias,
                packed, eps, act):
        y, a1 = mlp_frozen_fwd(x, packed, eps, act)
        ctx.save_for_backward(x, a1)
        ctx.packed, ctx.eps, ctx.act = packed, eps, act
        return y

    @staticmethod
    def backward(ctx, g):
        x, a1 = ctx.saved_tensors
        dx = mlp_frozen_bwd(x, g, a1, ctx.packed, ctx.eps, ctx.act)
        return (dx,) + (None,) * 9


def mlp_block_frozen(x: torch.Tensor, ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight,
                     fc2_bias, eps: float = 1e-5, packed=None,
                     act: str = "quick_gelu") -> torch.Tensor:
    """x + fc2(act(fc1(LN(x)))) over x [B, S, D], differentiable in x
    only. Weights in HF layout; `packed` (from `pack_frozen_mlp`, in x's
    dtype) is made here when not given."""
    weights = (ln_scale, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias)
    if any(w.requires_grad for w in weights):
        raise ValueError(
            "mlp_block_frozen: a weight requires grad, but this block's backward gives "
            "the weights no gradient; freeze LN2 and the MLP or use the trainable path"
        )
    if packed is None:
        packed = pack_frozen_mlp(*weights, dtype=x.dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        return _MLPFrozen.apply(x, *weights, packed, eps, act)
    return vit_block.mlp_block_fused(x, packed, eps, act)
