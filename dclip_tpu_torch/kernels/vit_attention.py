"""Fused multi-head self-attention with masks, forward and backward, on Hopper.

Counterpart of `dclip_tpu/kernels/vit_attention.py`:

  self_attention_fused       K3: softmax(mask(q k^T / sqrt(hd))) v
  self_attention_fwd_stats   K4: the same, plus the per-(row, head) stats
                             m (log2-domain max) and rinv [B, S, H] f32
                             (and, asked for, the output's rounding
                             residual o_lo: o + o_lo is the f32 output)
  self_attention_bwd_stats   K5: dq, dk, dv from q, k, v, g, o, m, rinv
  self_attention_qkv         the differentiable form (torch.autograd
                             Function) over one [B, S, 3D] q|k|v buffer:
                             K4 forward and K5 backward under autograd,
                             K3 when no gradient is wanted (the JAX
                             custom-VJP primal, vit_attention.py:446-451)

K3 and K4 are one CUDA kernel (`csrc/attention.cu`) with the stats write
switched off or on; K5 is `csrc/attention_bwd.cu` (a dq kernel, then a
dk/dv kernel). Masks follow `_mask_logits` (vit_attention.py:68-89):
`causal`, a key-padding mask [B, S] (1 = valid key) and segment ids
[B, S] (attend within the segment; with `causal`, the packed-caption
mask of ops/packing.packed_attention_bias). A masked logit becomes the
finite -1e30 of the TPU's `_NEG`.

q, k, v enter as [B, S, D] views with unit column stride and any row
stride, so the q|k|v thirds of one buffer go in without a copy. Every
wrapper has a plain f32 twin (`*_reference`) with the TPU kernels' algebra;
a wrapper takes its twin only when its tensors lie on the CPU, and for
CUDA tensors launches its kernel or raises. CUDA: bf16, head_dim 64 or 72
(SigLIP so400m's 16 heads of 72; the kernels pad 72 to five k16 steps).
Asked for (`residual`, built at head_dim 72), the differentiable form keeps
o_lo beside o, and the backward's delta = rowsum(g o) takes o + o_lo
(`csrc/attention_bwd.cu`). The model asks: SigLIP's towers do
(`models.siglip`), where a delta from the bf16 o alone swamped the text
tower's dQ / dK; CLIP's head_dim-64 towers keep the parent's kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dclip_tpu_torch.kernels._build import check, load_library
from dclip_tpu_torch.kernels.vit_block import LOG2E, _on_cpu, _stream

NEG = -1e30

LAUNCHES: Dict[str, int] = {
    "self_attention_fused": 0,
    "self_attention_fwd_stats": 0,
    "self_attention_bwd_stats": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain twins ----------------------------------------------------------------


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.float().reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _masked_log2_logits(q, k, num_heads, padding_mask, causal, segment_ids):
    """[B, H, S, S] f32 logits in the log2 domain with the masks applied."""
    hd = q.shape[-1] // num_heads
    l2 = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)) * (hd**-0.5 * LOG2E)
    s = q.shape[1]
    keep = torch.ones((1, 1, s, s), dtype=torch.bool, device=q.device)
    if causal:
        keep = keep & torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    if segment_ids is not None:
        keep = keep & (segment_ids[:, None, :, None] == segment_ids[:, None, None, :])
    if padding_mask is not None:
        keep = keep & (padding_mask[:, None, None, :] > 0)
    return torch.where(keep, l2, torch.full_like(l2, NEG))


def _merge(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, h, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, h * hd).to(dtype)


def attention_reference(q, k, v, num_heads: int, padding_mask=None, causal: bool = False,
                        segment_ids=None, stats: bool = False, residual: bool = False):
    """`_fwd_stats_kernel` in f32: o, and with `stats` also m and rinv
    [B, S, H] f32; with `residual` also o_lo, the f32 output less o, in o's
    dtype."""
    l2 = _masked_log2_logits(q, k, num_heads, padding_mask, causal, segment_ids)
    m = l2.amax(-1, keepdim=True)
    e = torch.exp2(l2 - m)
    rinv = 1.0 / e.sum(-1, keepdim=True)
    exact = _merge((e @ _heads(v, num_heads)) * rinv, torch.float32)
    o = exact.to(q.dtype)
    if not stats:
        return o
    out = (o, m[..., 0].transpose(1, 2).contiguous(), rinv[..., 0].transpose(1, 2).contiguous())
    return out + ((exact - o.float()).to(q.dtype),) if residual else out


def attention_bwd_reference(q, k, v, g, o, m, rinv, num_heads: int, padding_mask=None,
                            causal: bool = False, segment_ids=None, o_lo=None):
    """`_bwd_kernel` in f32: (dq, dk, dv) in the dtypes of q, k, v; delta
    from o + o_lo when the residual is given."""
    hd = q.shape[-1] // num_heads
    scale = hd**-0.5
    l2 = _masked_log2_logits(q, k, num_heads, padding_mask, causal, segment_ids)
    mh = m.float().transpose(1, 2)[..., None]      # [B, H, S, 1]
    rh = rinv.float().transpose(1, 2)[..., None]
    e = torch.exp2(l2 - mh)
    gh, vh = _heads(g, num_heads), _heads(v, num_heads)
    oh = _heads(o, num_heads) if o_lo is None else _heads(o, num_heads) + _heads(o_lo, num_heads)
    delta = (gh * oh).sum(-1, keepdim=True)
    dv = e.transpose(-1, -2) @ (gh * rh)
    ds = e * ((gh @ vh.transpose(-1, -2) - delta) * rh)
    dq = scale * (ds @ _heads(k, num_heads))
    dk = scale * (ds.transpose(-1, -2) @ _heads(q, num_heads))
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


# -- CUDA wrappers --------------------------------------------------------------


def _row_view(t: torch.Tensor, name: str, shape) -> int:
    """Row stride of a bf16 [B, S, D] view the kernels can read."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes torch.bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    b, s, _ = t.shape
    ld = t.stride(1)
    if t.stride(2) != 1 or (b > 1 and t.stride(0) != s * ld) or ld % 8 or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: needs unit column stride, row stride % 8 == 0, batch stride S * row "
            f"stride and 16-byte alignment; got strides {t.stride()}"
        )
    return ld


def _mask_operands(b: int, s: int, padding_mask, segment_ids):
    pad = seg = None
    if padding_mask is not None:
        pad = padding_mask.to(torch.float32).contiguous()
        if pad.shape != (b, s):
            raise ValueError(f"padding_mask: shape {tuple(pad.shape)} != {(b, s)}")
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
        if seg.shape != (b, s):
            raise ValueError(f"segment_ids: shape {tuple(seg.shape)} != {(b, s)}")
    return pad, seg


HEAD_DIMS = (64, 72)


def _check_heads(q: torch.Tensor, num_heads: int) -> Tuple[int, int, int]:
    b, s, d = q.shape
    if d % num_heads or d // num_heads not in HEAD_DIMS or b * s == 0:
        raise ValueError(
            f"attention: the CUDA kernels take head_dim 64 or 72, got D = {d} with "
            f"{num_heads} heads"
        )
    return b, s, d


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd(q, k, v, num_heads, padding_mask, causal, segment_ids, stats: bool,
         residual: bool = False):
    b, s, d = _check_heads(q, num_heads)
    lds = [_row_view(t, n, (b, s, d)) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    pad, seg = _mask_operands(b, s, padding_mask, segment_ids)
    lib = load_library()
    o = torch.empty((b, s, d), dtype=q.dtype, device=q.device)
    m = r = o_lo = None
    if stats:
        m = torch.empty((b, s, num_heads), dtype=torch.float32, device=q.device)
        r = torch.empty_like(m)
    if residual:
        if d // num_heads != 72 or not stats:
            raise ValueError("attention: the kernels write the output residual at head_dim "
                             f"72 with statistics, got head_dim {d // num_heads}")
        o_lo = torch.empty_like(o)
    with torch.cuda.device(q.device):
        code = lib.dclip_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *lds, o.data_ptr(), _ptr(pad),
            _ptr(seg), _ptr(m), _ptr(r), _ptr(o_lo), b, s, num_heads, d // num_heads,
            int(causal), _stream(q))
    name = "self_attention_fwd_stats" if stats else "self_attention_fused"
    check(lib, code, name)
    LAUNCHES[name] += 1
    if not stats:
        return o
    return (o, m, r, o_lo) if residual else (o, m, r)


def self_attention_fused(q, k, v, num_heads: int, padding_mask=None, causal: bool = False,
                         segment_ids=None) -> torch.Tensor:
    """K3: the attention output [B, S, D], no statistics."""
    if _on_cpu(q, k, v, padding_mask, segment_ids):
        return attention_reference(q, k, v, num_heads, padding_mask, causal, segment_ids)
    return _fwd(q, k, v, num_heads, padding_mask, causal, segment_ids, stats=False)


def self_attention_fwd_stats(q, k, v, num_heads: int, padding_mask=None, causal: bool = False,
                             segment_ids=None, residual: bool = False):
    """K4: (o [B, S, D], m [B, S, H] f32 log2-domain max, rinv [B, S, H] f32),
    with `residual` also o_lo like o (the kernel writes it at head_dim 72)."""
    if _on_cpu(q, k, v, padding_mask, segment_ids):
        return attention_reference(q, k, v, num_heads, padding_mask, causal, segment_ids,
                                   stats=True, residual=residual)
    return _fwd(q, k, v, num_heads, padding_mask, causal, segment_ids, stats=True,
                residual=residual)


def self_attention_bwd_stats(q, k, v, g, o, m, rinv, num_heads: int, padding_mask=None,
                             causal: bool = False, segment_ids=None, out=None, o_lo=None):
    """K5: (dq, dk, dv) like q, k, v. `out`, optional: three views to write
    them into (the q|k|v thirds of one gradient buffer); `o_lo`, optional
    (head_dim 72): the forward's output residual, read by delta."""
    if _on_cpu(q, k, v, g, o, m, rinv, padding_mask, segment_ids, o_lo):
        grads = attention_bwd_reference(q, k, v, g, o, m, rinv, num_heads, padding_mask,
                                        causal, segment_ids, o_lo)
        if out is None:
            return grads
        for dst, src in zip(out, grads):
            dst.copy_(src)
        return tuple(out)
    b, s, d = _check_heads(q, num_heads)
    lds = [_row_view(t, n, (b, s, d)) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    g = g.to(q.dtype).contiguous()
    _row_view(g, "g", (b, s, d))
    for t, n in ((o, "o"), (o_lo, "o_lo")):
        if t is not None:
            _row_view(t, n, (b, s, d))
            if not t.is_contiguous():
                raise ValueError(f"{n}: must be contiguous")
    for t, n in ((m, "m"), (rinv, "rinv")):
        if t.dtype != torch.float32 or t.shape != (b, s, num_heads) or not t.is_contiguous():
            raise ValueError(f"{n}: needs a contiguous f32 [B, S, H] tensor")
    pad, seg = _mask_operands(b, s, padding_mask, segment_ids)
    lib = load_library()
    if out is None:
        out = tuple(torch.empty((b, s, d), dtype=q.dtype, device=q.device) for _ in range(3))
    out_lds = [_row_view(t, n, (b, s, d)) for t, n in zip(out, ("dq", "dk", "dv"))]
    delta = torch.empty_like(m)
    with torch.cuda.device(q.device):
        code = lib.dclip_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *lds, g.data_ptr(), o.data_ptr(),
            _ptr(o_lo), m.data_ptr(), rinv.data_ptr(), _ptr(pad), _ptr(seg), delta.data_ptr(),
            *(t.data_ptr() for t in out), *out_lds, b, s, num_heads, d // num_heads,
            int(causal), _stream(q))
    check(lib, code, "self_attention_bwd_stats")
    LAUNCHES["self_attention_bwd_stats"] += 1
    return tuple(out)


# -- the differentiable form ----------------------------------------------------


def _split(qkv: torch.Tensor):
    d = qkv.shape[-1] // 3
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


class _SelfAttentionQKV(torch.autograd.Function):
    """K4 forward saving (qkv, o, m, rinv; with `residual` also o_lo); K5
    backward writing dq|dk|dv into one [B, S, 3D] gradient. The masks are
    not differentiable."""

    @staticmethod
    def forward(ctx, qkv, num_heads, padding_mask, segment_ids, causal, residual):
        o, m, r, *o_lo = self_attention_fwd_stats(*_split(qkv), num_heads, padding_mask,
                                                  causal, segment_ids, residual=residual)
        ctx.save_for_backward(qkv, o, m, r, *o_lo)
        ctx.masks = (padding_mask, segment_ids)
        ctx.num_heads, ctx.causal = num_heads, causal
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, o, m, r, *o_lo = ctx.saved_tensors
        padding_mask, segment_ids = ctx.masks
        dqkv = torch.empty_like(qkv)
        self_attention_bwd_stats(*_split(qkv), g, o, m, r, ctx.num_heads, padding_mask,
                                 ctx.causal, segment_ids, out=_split(dqkv),
                                 o_lo=o_lo[0] if o_lo else None)
        return dqkv, None, None, None, None, None


def self_attention_qkv(qkv: torch.Tensor, num_heads: int, padding_mask=None,
                       causal: bool = False, segment_ids=None,
                       residual: bool = False) -> torch.Tensor:
    """Attention over the q|k|v buffer [B, S, 3D] -> [B, S, D]: K4 + K5
    under autograd, the stats-free K3 when no gradient is wanted;
    `residual`: the backward's delta reads o + o_lo (module docstring)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _SelfAttentionQKV.apply(qkv, num_heads, padding_mask, segment_ids, causal,
                                       residual)
    return self_attention_fused(*_split(qkv), num_heads, padding_mask, causal, segment_ids)


def self_attention_trainable(q, k, v, num_heads: int, padding_mask=None,
                             causal: bool = False, segment_ids=None) -> torch.Tensor:
    """The JAX package's signature (separate q, k, v [B, S, D]): the three
    are concatenated into one buffer for `self_attention_qkv`."""
    return self_attention_qkv(torch.cat([q, k, v], -1), num_heads, padding_mask, causal,
                              segment_ids)
