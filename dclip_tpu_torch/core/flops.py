"""Analytic FLOP counts and the card's peaks, for MFU and per-op floors.

Counterpart of `dclip_tpu/core/flops.py`. The five counts are the JAX
package's, with the same arithmetic in the same order over the port's own
`core/config.py`, so they give bit-equal floats. They count matmul FLOPs
only (2*M*N*K per GEMM): elementwise and softmax work is bound by bytes,
not by the tensor cores.

The TPU's peak table (`dclip_tpu/core/flops.py:13-17`) is replaced by the
dense peaks of the H100 parts, keyed by `torch.cuda.get_device_name()`:
an SXM and a PCIe H100 differ by a third in bf16 rate and 1.7x in memory
rate, so no part stands in for another. A card the table does not name
has no peak: `mfu` returns None and `card_peaks` raises, naming it.

A SigLIP configuration (`CLIPConfig.family == "siglip"`) is counted by its
own equations: no class token (the patches alone), the attention-pooling
head in place of the visual projection (the probe's q, k / v over every
token, its scores, out_proj and MLP), the text head in place of the text
projection.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from dclip_tpu_torch.core.config import CLIPConfig, TeacherConfig, model_family


@dataclass(frozen=True)
class CardPeaks:
    """Dense peaks of one card: tensor-core bf16, f32 on the CUDA cores
    (no TF32), TF32 tensor-core FLOP/s, and HBM bytes/s."""

    name: str
    bf16: float
    f32: float
    tf32: float
    hbm: float

    def flops(self, dtype: str) -> float:
        """The peak for a compute dtype name: bfloat16, float32 or tf32."""
        table = {"bfloat16": self.bf16, "float32": self.f32, "tf32": self.tf32}
        if dtype not in table:
            raise ValueError(f"no peak for dtype {dtype!r}; have {sorted(table)}")
        return table[dtype]


# NVIDIA H100 data sheet, dense rates (the sheet's sparse figures halved).
# The rates hold at the part's full power limit (700 W for the SXM part,
# 350-400 W for PCIe and NVL); a card capped below it (nvidia-smi's
# power.limit) runs slower under load, so keep that limit beside a number.
CARD_PEAKS = {
    p.name: p for p in (
        CardPeaks("NVIDIA H100 80GB HBM3", bf16=989e12, f32=67e12, tf32=495e12, hbm=3.35e12),
        CardPeaks("NVIDIA H100 PCIe", bf16=756e12, f32=51e12, tf32=378e12, hbm=2.0e12),
        CardPeaks("NVIDIA H100 NVL", bf16=835e12, f32=60e12, tf32=418e12, hbm=3.9e12),
    )
}


def _known_card(device) -> Optional[CardPeaks]:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return CARD_PEAKS.get(torch.cuda.get_device_name(device))


def card_peaks(device: Union[str, torch.device] = "cuda") -> CardPeaks:
    """The peaks of the card `device` names; raises for the CPU and for a
    card the table does not name (with its name)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no card peaks for device {str(device)!r}: the peaks are a card's")
    peaks = _known_card(device)
    if peaks is None:
        raise ValueError(f"no peaks for the card {torch.cuda.get_device_name(device)!r}; "
                         f"core/flops.py CARD_PEAKS names {sorted(CARD_PEAKS)}")
    return peaks


def _siglip_tokens(cfg: CLIPConfig, image_size: int | None = None) -> int:
    v = cfg.vision
    return ((image_size or v.image_size) // v.patch_size) ** 2


def _siglip_head_flops(cfg: CLIPConfig, image_size: int | None = None) -> float:
    """The attention-pooling head over s tokens: the probe's q and out_proj
    (one row), k and v (s rows), scores and P V, the MLP (one row)."""
    s, d, mlp = _siglip_tokens(cfg, image_size), cfg.vision.hidden_size, cfg.vision.mlp_dim
    return 2 * 2 * d * d + 2 * 2 * s * d * d + 2 * 2 * s * d + 2 * 2 * d * mlp


def _layer_flops(s: int, d: int, mlp: int) -> float:
    return 4 * 2 * s * d * d + 2 * 2 * s * s * d + 2 * 2 * s * d * mlp


def _siglip_vision_forward_flops(cfg: CLIPConfig, image_size: int | None = None) -> float:
    v = cfg.vision
    s = _siglip_tokens(cfg, image_size)
    patch_embed = 2 * s * (3 * v.patch_size**2) * v.hidden_size
    return (patch_embed + v.num_layers * _layer_flops(s, v.hidden_size, v.mlp_dim)
            + _siglip_head_flops(cfg, image_size))


def vision_forward_flops(cfg: CLIPConfig, image_size: int | None = None) -> float:
    """One ViT image-encoder forward, per image."""
    if model_family(cfg) == "siglip":
        return _siglip_vision_forward_flops(cfg, image_size)
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


def text_forward_flops(cfg: CLIPConfig) -> float:
    """One text-encoder forward, per caption."""
    t = cfg.text
    s = t.max_length
    d, mlp = t.hidden_size, t.mlp_dim
    if model_family(cfg) == "siglip":  # the head at the last position, no projection
        return t.num_layers * _layer_flops(s, d, mlp) + 2 * d * d
    per_layer = 4 * 2 * s * d * d + 2 * 2 * s * s * d + 2 * 2 * s * d * mlp
    proj = 2 * d * cfg.projection_dim
    return t.num_layers * per_layer + proj


def cross_attention_flops(tcfg: TeacherConfig) -> float:
    """Bidirectional cross-attention, per example (K10)."""
    d, t, p = tcfg.embed_dim, tcfg.max_text_tokens, tcfg.max_patches
    return 2 * (4 * 2 * (t + p) * d * d / 2 + 2 * 2 * t * p * d)


def student_step_flops_masked(cfg: CLIPConfig, text_scale: float = 1.0) -> float:
    """Per-image student fwd+bwd under the default trainable mask: the
    "model FLOPs" (PaLM-style MFU) convention, only the GEMMs the algorithm
    requires.

    The default mask (`train.optim.student_trainable_mask`) trains the
    vision attention projections + visual_projection and the whole text
    tower; the vision MLP, embeddings and LayerNorms are frozen. So:
      - vision: forward + the full dX chain (gradients reach layer-0
        attention), dW only for the 4 attention projections per layer and
        the final projection; K6 gives the frozen MLP no weight gradient,
        and the patch embedding's dX / dW are dead (no trainable leaf
        below it).
      - text: trainable end to end -> 3x forward (the attention-score
        matmuls have no dW; the ~2% that overcounts is noise against the
        vision tower).
    """
    v = cfg.vision
    d = v.hidden_size
    if model_family(cfg) == "siglip":
        # The pooling head's in_proj / out_proj train ("proj"): their dW as
        # their forward products; its probe, LayerNorm and MLP are frozen.
        s = _siglip_tokens(cfg)
        patch_embed = 2 * s * (3 * v.patch_size**2) * d
        attn_dw = v.num_layers * 4 * 2 * s * d * d + 2 * 2 * d * d + 2 * 2 * s * d * d
    else:
        s = (v.image_size // v.patch_size) ** 2 + 1
        patch_embed = 2 * (s - 1) * (3 * v.patch_size**2) * d
        attn_dw = v.num_layers * 4 * 2 * s * d * d + 2 * d * cfg.projection_dim
    vision_fwd = vision_forward_flops(cfg)
    vision = vision_fwd + (vision_fwd - patch_embed) + attn_dw
    # text_scale < 1: caption packing (ops/packing.py) encodes R < B rows
    # of max_length, so the per-image text GEMM work shrinks to R/B.
    return vision + 3.0 * text_forward_flops(cfg) * text_scale


def distill_step_flops(
    student_cfg: CLIPConfig,
    teacher_cfg: CLIPConfig,
    tcfg: TeacherConfig,
    batch: int,
    n_crops: int | None = None,
    teacher_image_size: int | None = None,
    teacher_cached: bool = False,
    reference_mask: bool = False,
    text_rows_fraction: float = 1.0,
) -> float:
    """One distillation training step (batch total).

    Teacher side (frozen, forward only): n_crops region ViT forwards + one
    token-level text forward + cross-attention per image, all skipped when
    `teacher_cached` (the target cache). Student side: image + text forward
    plus a backward at 2x forward; with `reference_mask=True` the backward
    counts only the GEMMs the default trainable mask requires
    (`student_step_flops_masked`), the MFU denominator of the default
    configuration. `text_rows_fraction` = packed rows / batch with caption
    packing on: the text tower runs that fraction of its padded GEMM work,
    so the denominator shrinks with it.
    """
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


def mfu(flops_per_sec: float, device: Union[str, torch.device], dtype: str) -> Optional[float]:
    """Achieved FLOP/s over the card's dense peak for `dtype`; None on the
    CPU and on a card `CARD_PEAKS` does not name (no stand-in peak)."""
    peaks = _known_card(device)
    return None if peaks is None else flops_per_sec / peaks.flops(dtype)
