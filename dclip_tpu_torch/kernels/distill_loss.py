"""The fused distillation loss with its closed-form backward, on Hopper.

Counterpart of `dclip_tpu/kernels/distill_loss.py` (K11):

    L = mean(1 - cos(s_img, t_img)) + mean(1 - cos(s_txt, t_txt))
        + w * InfoNCE(s_img, s_txt; temperature)

`distill_loss_fwd` returns the four parts [li, lt, lc, total] as one f32
tensor on the device (no host sync); `distill_loss_bwd` takes the
cotangent weights (c_li, c_lt, c_lc) as a device tensor and returns the
student gradients (dsi, dst). Teacher targets get no gradient. The CUDA
kernels (`csrc/distill_loss.cu`) compute in f32 from bf16 student rows and
f32 teacher rows; the backward recomputes the log-sum-exps and saves no
[B, B] residual, as the TPU kernel does. The port has no batch bound
(`MAX_FUSED_BATCH` is the TPU's VMEM limit): the kernels stream the rows.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from dclip_tpu_torch.kernels._build import check, load_library
from dclip_tpu_torch.kernels.vit_block import _launch, _on_cpu, _require

EPS = 1e-12
# The widest rows the kernels take: the tile kernel's two bf16 strips of 32
# rows fit a block's shared memory (`csrc/distill_loss.cu`).
MAX_D = 1536
PARTS = ("image_distill_loss", "text_distill_loss", "contrastive_loss", "loss")

LAUNCHES: Dict[str, int] = {"distill_loss_fwd": 0, "distill_loss_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _norm_rows(x: torch.Tensor):
    inv = torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=EPS * EPS))
    return x * inv, inv


def distill_loss_fwd_reference(si, st, ti, tt, temperature: float = 0.05,
                               weight: float = 1.0) -> torch.Tensor:
    """`_fwd_kernel` in f32: [li, lt, lc, total]."""
    si, _ = _norm_rows(si.float())
    st, _ = _norm_rows(st.float())
    ti, _ = _norm_rows(ti.float())
    tt, _ = _norm_rows(tt.float())
    li = 1.0 - (si * ti).sum(-1).mean()
    lt = 1.0 - (st * tt).sum(-1).mean()
    z = (si @ st.T) / temperature
    mean_diag = (si * st).sum(-1).mean() / temperature
    lc = 0.5 * (torch.logsumexp(z, 1).mean() + torch.logsumexp(z, 0).mean()) - mean_diag
    return torch.stack([li, lt, lc, li + lt + weight * lc])


def distill_loss_bwd_reference(si, st, ti, tt, cts, temperature: float = 0.05):
    """`_bwd_kernel` in f32: (dsi, dst) in the dtypes of si, st."""
    si_n, inv_i = _norm_rows(si.float())
    st_n, inv_t = _norm_rows(st.float())
    ti_n, _ = _norm_rows(ti.float())
    tt_n, _ = _norm_rows(tt.float())
    b = si.shape[0]
    c_li, c_lt, c_lc = cts.float()
    g_si = -(c_li / b) * ti_n
    g_st = -(c_lt / b) * tt_n
    z = (si_n @ st_n.T) / temperature
    eye = torch.eye(b, device=z.device)
    g_z = c_lc * ((torch.softmax(z, 1) - eye) + (torch.softmax(z, 0) - eye)) / (
        2.0 * b * temperature)
    g_si = g_si + g_z @ st_n
    g_st = g_st + g_z.T @ si_n
    dsi = (g_si - (g_si * si_n).sum(-1, keepdim=True) * si_n) * inv_i
    dst = (g_st - (g_st * st_n).sum(-1, keepdim=True) * st_n) * inv_t
    return dsi.to(si.dtype), dst.to(st.dtype)


def _check(si, st, ti, tt):
    _require(si, "student_image", torch.bfloat16, 2)
    _require(st, "student_text", torch.bfloat16, 2)
    _require(ti, "teacher_image", torch.float32, 2)
    _require(tt, "teacher_text", torch.float32, 2)
    b, d = si.shape
    if any(t.shape != (b, d) for t in (st, ti, tt)) or d % 8 or d > MAX_D or b == 0:
        raise ValueError(f"distill_loss: four [B, D] inputs with D % 8 == 0 and D <= {MAX_D}, "
                         f"got {[tuple(t.shape) for t in (si, st, ti, tt)]}")
    return b, d


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _tiles(b: int) -> int:
    """nt, the 32 x 32 tiles of Z a side (`kTile` in csrc/distill_loss.cu)."""
    return -(-b // 32)


# Per (device, stream): the completion tickets (1 + 2 nt int32, zeroed
# when allocated and each set back to 0 by its last user in every launch)
# and the scratch (`Scratch` in csrc/distill_loss.cu: 8 nt B + 9 round4(B)
# floats), grown to the largest B seen. Launches on one stream run in
# order, so no two eager calls in flight share them; no launch is spent
# zeroing the tickets, and no host time allocating the scratch. A call
# being captured into a CUDA graph gets a workspace of its own instead:
# the graph may replay on any stream, beside eager calls on the one it
# was captured on.
_WORKSPACES: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tickets, scratch) for a call of batch b on the device's current stream."""
    nt = _tiles(b)
    n_tickets, n_scratch = 1 + 2 * nt, 8 * nt * b + 9 * _round4(b)
    if torch.cuda.is_current_stream_capturing():  # the tickets zeroed by every replay
        return (torch.zeros(n_tickets, dtype=torch.int32, device=device),
                torch.empty(n_scratch, dtype=torch.float32, device=device))
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < n_tickets or ws[1].numel() < n_scratch:
        ws = _WORKSPACES[key] = (torch.zeros(n_tickets, dtype=torch.int32, device=device),
                                 torch.empty(n_scratch, dtype=torch.float32, device=device))
    return ws


def distill_loss_fwd(si, st, ti, tt, temperature: float = 0.05,
                     weight: float = 1.0) -> torch.Tensor:
    """[li, lt, lc, total] f32. CUDA: student rows bf16, teacher rows f32."""
    if _on_cpu(si, st, ti, tt):
        return distill_loss_fwd_reference(si, st, ti, tt, temperature, weight)
    b, d = _check(si, st, ti, tt)
    lib = load_library()
    out = torch.empty(4, dtype=torch.float32, device=si.device)
    tickets, scratch = _workspace(si.device, b)
    code = _launch(si.device, lib.dclip_distill_loss_fwd, si.data_ptr(), st.data_ptr(),
                   ti.data_ptr(), tt.data_ptr(), scratch.data_ptr(), tickets.data_ptr(),
                   out.data_ptr(), b, d, float(temperature), float(weight))
    check(lib, code, "distill_loss_fwd")
    LAUNCHES["distill_loss_fwd"] += 1
    return out


def distill_loss_bwd(si, st, ti, tt, cts, temperature: float = 0.05):
    """(dsi, dst) for cotangent weights cts = [c_li, c_lt, c_lc] (f32)."""
    if _on_cpu(si, st, ti, tt, cts):
        return distill_loss_bwd_reference(si, st, ti, tt, cts, temperature)
    b, d = _check(si, st, ti, tt)
    if cts.dtype != torch.float32 or not cts.is_contiguous():
        cts = cts.to(torch.float32).contiguous()
    if cts.shape != (3,):
        raise ValueError(f"cts: expected [3], got {tuple(cts.shape)}")
    lib = load_library()
    dev = si.device
    z = torch.empty((b, _round4(b)), dtype=torch.float32, device=dev)
    dsi, dst = torch.empty_like(si), torch.empty_like(st)
    tickets, scratch = _workspace(dev, b)
    code = _launch(dev, lib.dclip_distill_loss_bwd, si.data_ptr(), st.data_ptr(), ti.data_ptr(),
                   tt.data_ptr(), scratch.data_ptr(), z.data_ptr(), tickets.data_ptr(),
                   cts.data_ptr(), dsi.data_ptr(), dst.data_ptr(), b, d, float(temperature))
    check(lib, code, "distill_loss_bwd")
    LAUNCHES["distill_loss_bwd"] += 1
    return dsi, dst


class _FusedDistillLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, si, st, ti, tt, temperature, weight):
        ctx.save_for_backward(si, st, ti, tt)
        ctx.temperature, ctx.weight = temperature, weight
        return distill_loss_fwd(si, st, ti, tt, temperature, weight)

    @staticmethod
    def backward(ctx, g):
        si, st, ti, tt = ctx.saved_tensors
        # The cotangent weighting of distill_loss.py:179-186, on the device.
        cts = torch.stack([g[0] + g[3], g[1] + g[3], g[2] + ctx.weight * g[3]])
        dsi, dst = distill_loss_bwd(si, st, ti.contiguous(), tt.contiguous(), cts,
                                    ctx.temperature)
        return dsi, dst, None, None, None, None


def fused_distillation_loss(student_image, student_text, teacher_image, teacher_text,
                            temperature: float = 0.05, contrastive_weight: float = 1.0
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in twin of `ops.losses.distillation_loss`: (total, parts)."""
    out = _FusedDistillLoss.apply(student_image.contiguous(), student_text.contiguous(),
                                  teacher_image.contiguous(), teacher_text.contiguous(),
                                  temperature, contrastive_weight)
    parts = dict(zip(PARTS, out.unbind(0)))
    return parts["loss"], parts
