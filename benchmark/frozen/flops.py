"""Analytic FLOP counts and the card's peaks: the benchmark's frozen copy.

Copied from `dclip_tpu_torch/core/flops.py` at commit 6dc6ebb3c2bb
(`CardPeaks`, `CARD_PEAKS`, `vision_forward_flops`, `text_forward_flops`,
`cross_attention_flops`, `student_step_flops_masked`,
`distill_step_flops`), with the same arithmetic in the same order, so the
counts stay bit-equal to the program's at that commit. The program may
change its own copy; this one is the yardstick and changes only with the
benchmark. The configurations are the namespaces of `manifest.shapes`
(the port's attribute names: `cfg.vision.hidden_size`, `tcfg.embed_dim`).

They count matmul FLOPs only (2*M*N*K per GEMM). `text_tokens_forward_flops`
is the benchmark's own addition: the text tower over captions of their
real lengths, the work the inputs need whatever the packing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable


@dataclass(frozen=True)
class CardPeaks:
    """Dense peaks of one card: tensor-core bf16, f32 on the CUDA cores
    (no TF32), TF32 tensor-core FLOP/s, and HBM bytes/s."""

    name: str
    bf16: float
    f32: float
    tf32: float
    hbm: float


# NVIDIA H100 data sheet, dense rates (the sheet's sparse figures halved),
# at the part's full power limit (700 W for the SXM part).
CARD_PEAKS = {
    p.name: p for p in (
        CardPeaks("NVIDIA H100 80GB HBM3", bf16=989e12, f32=67e12, tf32=495e12, hbm=3.35e12),
        CardPeaks("NVIDIA H100 PCIe", bf16=756e12, f32=51e12, tf32=378e12, hbm=2.0e12),
        CardPeaks("NVIDIA H100 NVL", bf16=835e12, f32=60e12, tf32=418e12, hbm=3.9e12),
    )
}


def card_peaks(device_name: str) -> CardPeaks:
    """The peaks of the card named `device_name` (`torch.cuda.get_device_name()`);
    raises for a card the table does not name: no part stands in for another."""
    if device_name not in CARD_PEAKS:
        raise ValueError(f"no peaks for the card {device_name!r}; the table names "
                         f"{sorted(CARD_PEAKS)}")
    return CARD_PEAKS[device_name]


def vision_forward_flops(cfg, image_size: int | None = None) -> float:
    """One ViT image-encoder forward, per image."""
    v = cfg.vision
    size = image_size or v.image_size
    s = (size // v.patch_size) ** 2 + 1  # patches + CLS
    d, mlp = v.hidden_size, v.mlp_dim
    patch_embed = 2 * (s - 1) * (3 * v.patch_size**2) * d
    per_layer = (
        4 * 2 * s * d * d  # QKV + output projections
        + 2 * 2 * s * s * d  # QK^T and PV
        + 2 * 2 * s * d * mlp  # MLP in + out
    )
    proj = 2 * d * cfg.projection_dim
    return patch_embed + v.num_layers * per_layer + proj


def text_forward_flops(cfg) -> float:
    """One text-encoder forward, per caption."""
    t = cfg.text
    s = t.max_length
    d, mlp = t.hidden_size, t.mlp_dim
    per_layer = 4 * 2 * s * d * d + 2 * 2 * s * s * d + 2 * 2 * s * d * mlp
    proj = 2 * d * cfg.projection_dim
    return t.num_layers * per_layer + proj


def cross_attention_flops(tcfg) -> float:
    """Bidirectional cross-attention, per example (K10)."""
    d, t, p = tcfg.embed_dim, tcfg.max_text_tokens, tcfg.max_patches
    return 2 * (4 * 2 * (t + p) * d * d / 2 + 2 * 2 * t * p * d)


def student_step_flops_masked(cfg, text_scale: float = 1.0) -> float:
    """Per-image student fwd+bwd under the default trainable mask (the
    "model FLOPs" convention): the vision forward, its dX chain down to
    layer 0, dW of the attention projections and the visual projection;
    the text tower at 3x its forward, scaled by `text_scale`."""
    v = cfg.vision
    s = (v.image_size // v.patch_size) ** 2 + 1
    d = v.hidden_size
    patch_embed = 2 * (s - 1) * (3 * v.patch_size**2) * d
    vision_fwd = vision_forward_flops(cfg)
    attn_dw = v.num_layers * 4 * 2 * s * d * d + 2 * d * cfg.projection_dim
    vision = vision_fwd + (vision_fwd - patch_embed) + attn_dw
    return vision + 3.0 * text_forward_flops(cfg) * text_scale


def distill_step_flops(
    student_cfg,
    teacher_cfg,
    tcfg,
    batch: int,
    n_crops: int | None = None,
    teacher_image_size: int | None = None,
    teacher_cached: bool = False,
    reference_mask: bool = False,
    text_rows_fraction: float = 1.0,
) -> float:
    """One distillation training step (batch total): the frozen teacher's
    n_crops region forwards + token-level text forward + cross-attention
    per image (none when `teacher_cached`), and the student's step (with
    `reference_mask` the default mask's model FLOPs)."""
    crops = tcfg.max_patches if n_crops is None else n_crops
    teacher = 0.0
    if not teacher_cached:
        teacher = (
            crops * vision_forward_flops(teacher_cfg, teacher_image_size)
            + text_forward_flops(teacher_cfg)
            + cross_attention_flops(tcfg)
        )
    if reference_mask:
        student = student_step_flops_masked(
            student_cfg, text_scale=text_rows_fraction
        )
    else:
        student = 3.0 * (
            vision_forward_flops(student_cfg)
            + text_forward_flops(student_cfg) * text_rows_fraction
        )
    return batch * (teacher + student)


def text_tokens_forward_flops(cfg, lengths: Iterable[int]) -> float:
    """The text tower's forward over captions of the given token counts
    (the benchmark's own count): per caption of L tokens and per layer the
    projections 4*2*L*d*d, the attention products 2*2*L*L*d and the MLP
    2*2*L*d*mlp, plus the output projection once."""
    t = cfg.text
    d, mlp = t.hidden_size, t.mlp_dim
    total = 0.0
    for n in lengths:
        n = int(n)
        total += t.num_layers * (4 * 2 * n * d * d + 2 * 2 * n * n * d + 2 * 2 * n * d * mlp)
        total += 2 * d * cfg.projection_dim
    return total
