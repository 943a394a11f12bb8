"""Contrastive + distillation losses in plain torch (counterpart of
`dclip_tpu/ops/losses.py:26-91`).

- `info_nce`: symmetric InfoNCE, temperature 0.05, diagonal positives,
  mean of the i2t and t2i cross-entropies;
- `cosine_distillation`: mean(1 - cos(student, teacher));
- `distillation_loss`: img-distill + text-distill + w * InfoNCE.

All in f32 whatever the input dtype. This is the path the trainer takes
when the kernels are off; `kernels.distill_loss.fused_distillation_loss`
is the fused one. The multi-device `*_global` variants wait for the
port's data-parallel trainer (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics, with the clamp inside the
    sqrt so the gradient at x == 0 stays finite (as the JAX version)."""
    sq = (x * x).sum(dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def _cross_entropy_with_diagonal(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with labels = arange(B)."""
    return (torch.logsumexp(logits, -1) - torch.diagonal(logits)).mean()


def info_nce(image_embeddings: torch.Tensor, text_embeddings: torch.Tensor,
             temperature: float = 0.05) -> torch.Tensor:
    img = l2_normalize(image_embeddings.float())
    txt = l2_normalize(text_embeddings.float())
    logits = (img @ txt.T) / temperature
    return (_cross_entropy_with_diagonal(logits) + _cross_entropy_with_diagonal(logits.T)) / 2.0


def cosine_distillation(student_embeddings: torch.Tensor,
                        teacher_embeddings: torch.Tensor) -> torch.Tensor:
    s = l2_normalize(student_embeddings.float())
    t = l2_normalize(teacher_embeddings.float())
    return (1.0 - (s * t).sum(-1)).mean()


def distillation_loss(student_image, student_text, teacher_image, teacher_text,
                      temperature: float = 0.05, contrastive_weight: float = 1.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, parts): total = cos_distill(img) + cos_distill(txt)
    + contrastive_weight * InfoNCE(student_img, student_txt)."""
    img_d = cosine_distillation(student_image, teacher_image)
    txt_d = cosine_distillation(student_text, teacher_text)
    con = info_nce(student_image, student_text, temperature)
    total = img_d + txt_d + contrastive_weight * con
    return total, {"image_distill_loss": img_d, "text_distill_loss": txt_d,
                   "contrastive_loss": con, "loss": total}
