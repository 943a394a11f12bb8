"""The GEMM modes and row reductions the trainable blocks add (K8, K9).

The JAX package's trainable kernels (`dclip_tpu/kernels/mlp_trainable.py`,
`attn_block_trainable.py`) keep their weights resident in VMEM and sum
their weight gradients there across a sequential batch grid. On Hopper
those sums run over all B * S rows at once, in two passes without atomics
(the result is the same from run to run):

  gemm_nt              a @ w^T (+ bias, quick-GELU with the pre-activation
                       saved, residual) with w in nn.Linear's [N, K] layout
                       (`csrc/gemm.cu`, NT mode): a trainable weight is cast
                       to bf16 once per step, and the one copy serves the
                       forward (NT) and the backward's dx product (NN mode)
  gemm_tn              x^T y over the rows -> [P, Q] f32, the weight
                       gradient (`csrc/gemm.cu`, TN mode): the rows are split
                       over blocks so that the 36-108 output tiles of a
                       gradient fill the 132 SMs, then `csrc/reduce.cu` sums
                       the split partials
  colsum               the column sums of a bf16 [rows, N] tensor in f32,
                       the bias gradients (`csrc/reduce.cu`, two passes)
  layernorm_bwd_wgrad  the LayerNorm backward with trainable scale and bias:
                       dx (optional), dscale = sum dh * xhat, dbias = sum dh
                       (`csrc/layernorm.cu` partials per block, then
                       `csrc/reduce.cu`)

Every wrapper has its plain f32 twin (`*_reference`); a wrapper takes the
twin only when its tensors lie on the CPU, and for CUDA tensors launches
its kernels or raises. `LAUNCHES` counts one per wrapper call on CUDA.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dclip_tpu_torch.kernels._build import check, load_library
from dclip_tpu_torch.kernels.mlp_frozen import layernorm_bwd_reference
from dclip_tpu_torch.kernels.vit_block import (
    LAYERNORM_MAX_D,
    _on_cpu,
    _require,
    _sm_count,
    _stream,
    gemm_bias_act_residual_reference,
    launch_gemm,
)

LAUNCHES: Dict[str, int] = {
    "gemm_nt": 0,
    "gemm_tn": 0,
    "colsum": 0,
    "layernorm_bwd_wgrad": 0,
}

# Output tiles of csrc/gemm.cu and the rows of one of its K steps.
_TILE, _KSTEP = 128, 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _blocks_wanted(t: torch.Tensor) -> int:
    """Two blocks per SM: the target of every split below."""
    return 2 * _sm_count(t.device.index if t.device.index is not None
                         else torch.cuda.current_device())


def _splits(units: int, want: int, min_units: int) -> Tuple[int, int]:
    """(splits, units per split) for `units` of work cut into about
    `want` splits of at least `min_units` each (the last one may be short)."""
    splits = max(1, min(want, units // min_units))
    per = -(-units // splits)
    return -(-units // per), per


# -- A @ W^T -----------------------------------------------------------------------


def gemm_nt_reference(a, w, bias=None, residual=None, gelu: bool = False,
                      save_preact: bool = False, out_dtype: Optional[torch.dtype] = None):
    return gemm_bias_act_residual_reference(a, w.t(), bias, residual, gelu, save_preact,
                                            None, out_dtype)


def gemm_nt(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None, gelu: bool = False,
            save_preact: bool = False, out_dtype: Optional[torch.dtype] = None):
    """a [..., K] @ w[N, K]^T (+ bias [N]), then quick-GELU if `gelu`, then
    + residual [..., N]; `save_preact` also returns the pre-activation.
    CUDA: a, w, residual bf16, bias f32, K % 8 == 0, N % 8 == 0."""
    if _on_cpu(a, w, bias, residual):
        return gemm_nt_reference(a, w, bias, residual, gelu, save_preact, out_dtype)
    out = launch_gemm(a, w, bias, residual, gelu, save_preact, None, out_dtype, w_is_nk=True)
    LAUNCHES["gemm_nt"] += 1
    return out


# -- X^T @ Y over the rows --------------------------------------------------------


def _rows(t: torch.Tensor, name: str) -> Tuple[int, int]:
    _require(t, name, torch.bfloat16, t.dim())
    n = t.shape[-1]
    if n % 8 or t.numel() == 0:
        raise ValueError(f"{name}: needs a last dim % 8 == 0 and rows, got {tuple(t.shape)}")
    return t.numel() // n, n


def gemm_tn_reference(x, y):
    return x.reshape(-1, x.shape[-1]).float().t() @ y.reshape(-1, y.shape[-1]).float()


def gemm_tn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x^T y summed over the rows: x [..., P] and y [..., Q] with the same
    leading shape -> [P, Q] f32. CUDA: bf16, contiguous, P % 8 == Q % 8 == 0."""
    if _on_cpu(x, y):
        return gemm_tn_reference(x, y)
    rows, p = _rows(x, "x")
    rows_y, q = _rows(y, "y")
    if rows_y != rows:
        raise ValueError(f"gemm_tn: x {tuple(x.shape)} and y {tuple(y.shape)} differ in rows")
    lib = load_library()
    tiles = -(-p // _TILE) * -(-q // _TILE)
    # At least 4 K steps (256 rows) per split.
    splits, per = _splits(-(-rows // _KSTEP), -(-_blocks_wanted(x) // tiles), 4)
    out = torch.empty((p, q), dtype=torch.float32, device=x.device)
    part = out if splits == 1 else torch.empty((splits, p, q), dtype=torch.float32,
                                               device=x.device)
    with torch.cuda.device(x.device):
        check(lib, lib.dclip_gemm_tn_bf16(x.data_ptr(), y.data_ptr(), part.data_ptr(), p, q,
                                          rows, per, splits, _stream(x)), "gemm_tn")
        if splits > 1:
            check(lib, lib.dclip_reduce_rows_f32(part.data_ptr(), out.data_ptr(), splits, p * q,
                                                 _stream(x)), "gemm_tn (reduce)")
    LAUNCHES["gemm_tn"] += 1
    return out


# -- column sums --------------------------------------------------------------------


def colsum_reference(x):
    return x.reshape(-1, x.shape[-1]).float().sum(0)


def colsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every row of x [..., N] -> [N] f32. CUDA: bf16, contiguous,
    N % 8 == 0."""
    if _on_cpu(x):
        return colsum_reference(x)
    rows, n = _rows(x, "x")
    groups = -(-n // 256)  # csrc/reduce.cu: 256 columns per block
    splits, per = _splits(rows, -(-_blocks_wanted(x) // groups), 64)
    lib = load_library()
    part = torch.empty((splits, n), dtype=torch.float32, device=x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        check(lib, lib.dclip_colsum_partial_bf16(x.data_ptr(), part.data_ptr(), rows, n, per,
                                                 splits, _stream(x)), "colsum")
        check(lib, lib.dclip_reduce_rows_f32(part.data_ptr(), out.data_ptr(), splits, n,
                                             _stream(x)), "colsum (reduce)")
    LAUNCHES["colsum"] += 1
    return out


# -- LayerNorm backward with its weight gradients -------------------------------------


def layernorm_bwd_wgrad_reference(x, g, dh, scale, eps: float = 1e-5, need_dx: bool = True):
    """(dx or None, dscale, dbias): dx as `mlp_frozen.layernorm_bwd_reference`
    (with the residual g), dscale = sum dh * xhat and dbias = sum dh over
    the rows, f32 (mlp_trainable.py:124-131)."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    xhat = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    dhf = dh.float().reshape(-1, d)
    dx = layernorm_bwd_reference(x, g, dh, scale, eps) if need_dx else None
    return dx, (dhf * xhat).sum(0), dhf.sum(0)


def layernorm_bwd_wgrad(x: torch.Tensor, g: Optional[torch.Tensor], dh: torch.Tensor,
                        scale: torch.Tensor, eps: float = 1e-5, need_dx: bool = True):
    """(dx, dscale, dbias) of a LayerNorm with trainable scale and bias: dx
    = g + LN_bwd(dh) when `need_dx` (else None; g may then be None),
    dscale and dbias f32 [D]. CUDA: x, g bf16 [..., D]; dh f32 like x;
    scale f32 [D]; D % 8 == 0, D <= 1280."""
    if _on_cpu(x, g, dh, scale):
        return layernorm_bwd_wgrad_reference(x, g, dh, scale, eps, need_dx)
    d = x.shape[-1]
    rows = x.numel() // max(d, 1)
    _require(x, "x", torch.bfloat16, x.dim())
    _require(dh, "dh", torch.float32, x.dim())
    _require(scale, "scale", torch.float32, 1)
    if need_dx:
        _require(g, "g", torch.bfloat16, x.dim())
    if dh.shape != x.shape or (need_dx and g.shape != x.shape) or scale.shape[0] != d \
            or d % 8 or d > LAYERNORM_MAX_D or rows == 0:
        raise ValueError(f"layernorm_bwd_wgrad: bad shapes x {tuple(x.shape)}, dh "
                         f"{tuple(dh.shape)}, scale {tuple(scale.shape)} (D % 8 == 0, <= 1280)")
    blocks = min(-(-rows // 8), _blocks_wanted(x))  # 8 rows (warps) per block at a time
    lib = load_library()
    dx = torch.empty_like(x) if need_dx else None
    part = torch.empty((blocks, 2, d), dtype=torch.float32, device=x.device)
    out = torch.empty((2, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        check(lib, lib.dclip_layernorm_bwd_wgrad_bf16(
            x.data_ptr(), None if g is None else g.data_ptr(), dh.data_ptr(), scale.data_ptr(),
            None if dx is None else dx.data_ptr(), part.data_ptr(), rows, d, float(eps),
            blocks, _stream(x)), "layernorm_bwd_wgrad")
        check(lib, lib.dclip_reduce_rows_f32(part.data_ptr(), out.data_ptr(), blocks, 2 * d,
                                             _stream(x)), "layernorm_bwd_wgrad (reduce)")
    LAUNCHES["layernorm_bwd_wgrad"] += 1
    return dx, out[0], out[1]
