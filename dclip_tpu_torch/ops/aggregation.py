"""Teacher aggregation math, masked and fixed-shape (counterpart of
`dclip_tpu/ops/aggregation.py:30-110`).

- `temperature_aggregate`: importance of each token = cosine similarity
  to the sequence mean; softmax(sim / temperature) over the sequence;
  weighted sum -> one global embedding per example.
- `best_text_similarity`: per patch, the max cosine similarity over texts
  and its argmax.
- `patch_weights`: area * confidence * similarity, normalized to sum 1,
  uniform over valid patches when the total is 0.
- `fuse_global`: alpha * text + (1 - alpha) * image.

Every function takes an optional validity mask so padded slots are inert;
with `mask=None` the padded rows take part, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dclip_tpu_torch.ops.losses import l2_normalize

_NEG = torch.finfo(torch.float32).min


def temperature_aggregate(x: torch.Tensor, temperature: float = 2.0,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, D], optional [B, S] mask -> [B, D] f32 global embedding."""
    x = x.float()
    if mask is None:
        mean = x.mean(1, keepdim=True)
        sims = (l2_normalize(x) * l2_normalize(mean)).sum(-1)  # [B, S] cosine to mean
        weights = torch.exp(sims / temperature)
        weights = weights / weights.sum(1, keepdim=True)
    else:
        m = mask.float()
        denom = torch.clamp(m.sum(1, keepdim=True), min=1.0)
        mean = (x * m[..., None]).sum(1, keepdim=True) / denom[..., None]
        sims = (l2_normalize(x) * l2_normalize(mean)).sum(-1)
        logits = torch.where(m > 0, sims / temperature, torch.full_like(sims, _NEG))
        weights = torch.exp(logits - logits.amax(1, keepdim=True)) * m
        weights = weights / torch.clamp(weights.sum(1, keepdim=True), min=1e-12)
    return (x * weights[..., None]).sum(1)


def best_text_similarity(text_embeddings: torch.Tensor, patch_embeddings: torch.Tensor,
                         text_mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """text [B, T, D], patches [B, P, D] -> (max_sim [B, P], best_idx [B, P])."""
    t = l2_normalize(text_embeddings.float())
    p = l2_normalize(patch_embeddings.float())
    sim = torch.einsum("btd,bpd->btp", t, p)
    if text_mask is not None:
        sim = torch.where(text_mask[:, :, None] > 0, sim, torch.full_like(sim, _NEG))
    return sim.amax(1), sim.argmax(1)  # argmax: the first maximum, as jnp.argmax


def patch_weights(boxes: torch.Tensor, confidences: torch.Tensor, similarities: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """boxes [B, P, 4] xyxy; confidences, similarities, mask [B, P]."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    w = (x2 - x1) * (y2 - y1) * confidences.float() * similarities.float()
    if mask is not None:
        m = mask.float()
        w = w * m
        uniform = m / torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    else:
        uniform = torch.full_like(w, 1.0 / w.shape[-1])
    total = w.sum(-1, keepdim=True)
    # Only a total of exactly 0 falls back (a negative total still divides).
    nonzero = total != 0
    return torch.where(nonzero, w / torch.where(nonzero, total, torch.ones_like(total)), uniform)


def fuse_global(text_global: torch.Tensor, image_global: torch.Tensor,
                alpha: float = 0.5) -> torch.Tensor:
    return alpha * text_global + (1.0 - alpha) * image_global
