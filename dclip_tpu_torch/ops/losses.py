"""Contrastive + distillation losses in plain torch (counterpart of
`dclip_tpu/ops/losses.py:26-91`).

- `info_nce`: symmetric InfoNCE, temperature 0.05, diagonal positives,
  mean of the i2t and t2i cross-entropies;
- `cosine_distillation`: mean(1 - cos(student, teacher));
- `distillation_loss`: img-distill + text-distill + w * InfoNCE.

All in f32 whatever the input dtype. This is the path the trainer takes
when the kernels are off; `kernels.distill_loss.fused_distillation_loss`
is the fused one.

The global-batch variants (`dclip_tpu/ops/losses.py:98-152`) take each
rank's [B_local, D] rows and a `parallel.mesh.Mesh`:
- `info_nce_global`: InfoNCE over the all-gathered [B_g, B_g] matrix;
- `distillation_loss_global`: the distillation terms as a psum-mean of
  the ranks' local means, InfoNCE over the gathered batch.
Every rank gets the same value; each differentiates it with respect to its
own rows (`parallel.mesh`), so the ranks' gradients sum to the global one.
They serve the teacher trainer (its InfoNCE has no kernel) and the
distillation trainer with the kernels off; with the kernels on, that
trainer runs K11 over the gathered batch.
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


def info_nce_global(image_embeddings: torch.Tensor, text_embeddings: torch.Tensor, mesh,
                    temperature: float = 0.05) -> torch.Tensor:
    """InfoNCE over the global batch: both sides all-gathered over `mesh`."""
    from dclip_tpu_torch.parallel.mesh import gather_rows

    return info_nce(gather_rows(image_embeddings, mesh), gather_rows(text_embeddings, mesh),
                    temperature)


def distillation_loss_global(student_image, student_text, teacher_image, teacher_text, mesh,
                             temperature: float = 0.05, contrastive_weight: float = 1.0
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Global-batch `distillation_loss`: the cosine terms are per pair, so
    a psum-mean of the local means; the contrastive term needs the
    gathered similarity matrix. Every rank holds as many rows."""
    from dclip_tpu_torch.parallel.mesh import sum_across_ranks

    bs = float(student_image.shape[0])
    n = bs * mesh.size

    def pmean_of_mean(local_mean):
        return sum_across_ranks(local_mean * bs, mesh) / n

    img_d = pmean_of_mean(cosine_distillation(student_image, teacher_image))
    txt_d = pmean_of_mean(cosine_distillation(student_text, teacher_text))
    con = info_nce_global(student_image, student_text, mesh, temperature)
    total = img_d + txt_d + contrastive_weight * con
    return total, {"image_distill_loss": img_d, "text_distill_loss": txt_d,
                   "contrastive_loss": con, "loss": total}
