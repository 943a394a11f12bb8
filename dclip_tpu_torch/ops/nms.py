"""Fixed-shape greedy non-maximum suppression, batched over images
(counterpart of `dclip_tpu/ops/nms.py`).

The JAX op runs exactly `max_outputs` pick / suppress iterations in a
`lax.fori_loop`, one image at a time under `vmap`
(`dclip_tpu/models/detector.py:292`). Here the batch is a leading
dimension written out: each iteration is a handful of [B, N] tensor ops,
with no host sync inside the loop, so the 32 picks of a batch cost 32 x a
few launches and no round trip. The rules are the JAX op's, exactly:

- a box is live only while its score > `score_threshold`;
- each pick is the argmax of the live scores, the first index on ties
  (`torch.argmax`'s documented order, as `jnp.argmax`);
- the pick and every box with IoU > `iou_threshold` (strictly) are
  suppressed;
- past the last live box the results are padded: index -1, score 0,
  zero box, mask 0.

`batched_class_nms` keeps classes apart by shifting each box by
`class * class_offset` (torchvision / ultralytics `batched_nms`). These
are plain PyTorch ops: the JAX NMS is XLA, not a Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # [..., K, 4]
    scores: torch.Tensor  # [..., K]
    indices: torch.Tensor  # [..., K] int32 into the input, -1 for padding
    mask: torch.Tensor  # [..., K] 1.0 = valid


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    a, b = a.float(), b.float()
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    def area(x):
        return torch.clamp(x[..., 2] - x[..., 0], min=0.0) * torch.clamp(x[..., 3] - x[..., 1],
                                                                          min=0.0)

    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def _gather_boxes(boxes: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """boxes [B, N, 4], indices [B, K] (>= 0) -> [B, K, 4]."""
    return torch.gather(boxes, 1, indices.long()[..., None].expand(*indices.shape, 4))


def _nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
         score_threshold: float, max_outputs: int) -> NMSResult:
    """The greedy loop on [B, N, 4] / [B, N]."""
    bsz, n = scores.shape
    scores = scores.float()
    iou = iou_matrix(boxes, boxes)  # [B, N, N]
    live = scores > score_threshold
    arange = torch.arange(n, device=scores.device)
    neg_inf = torch.full_like(scores, float("-inf"))
    out_idx = torch.full((bsz, max_outputs), -1, dtype=torch.int32, device=scores.device)
    out_scores = torch.zeros((bsz, max_outputs), dtype=torch.float32, device=scores.device)
    for k in range(max_outputs):
        masked = torch.where(live, scores, neg_inf)
        best = torch.argmax(masked, dim=1, keepdim=True)  # [B, 1], first on ties
        best_score = torch.gather(masked, 1, best)
        valid = best_score > float("-inf")  # [B, 1]
        out_idx[:, k:k + 1] = torch.where(valid, best, -1).to(torch.int32)
        out_scores[:, k:k + 1] = torch.where(valid, torch.gather(scores, 1, best), 0.0)
        row = torch.gather(iou, 1, best[..., None].expand(bsz, 1, n)).squeeze(1)  # [B, N]
        suppress = (row > iou_threshold) | (arange[None, :] == best)
        live = live & (~suppress | ~valid)
    mask = (out_idx >= 0).float()
    picked = _gather_boxes(boxes, torch.clamp(out_idx, min=0))
    return NMSResult(picked * mask[..., None], out_scores, out_idx, mask)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.45,
        score_threshold: float = 0.0, max_outputs: int = 32) -> NMSResult:
    """Greedy NMS with a static output budget. boxes [N, 4] or [B, N, 4]
    xyxy, scores [N] or [B, N]; every image of a batch independently."""
    if boxes.dim() == 2:
        res = _nms(boxes[None], scores[None], iou_threshold, score_threshold, max_outputs)
        return NMSResult(*(t[0] for t in res))
    return _nms(boxes, scores, iou_threshold, score_threshold, max_outputs)


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                      iou_threshold: float = 0.45, score_threshold: float = 0.0,
                      max_outputs: int = 32, class_offset: float = 4096.0) -> NMSResult:
    """Class-aware NMS by the coordinate-offset trick: boxes of different
    classes are shifted apart so that they never suppress each other. The
    returned boxes are the unshifted ones. [N] or [B, N] inputs, as `nms`."""
    if boxes.dim() == 2:
        res = batched_class_nms(boxes[None], scores[None], classes[None], iou_threshold,
                                score_threshold, max_outputs, class_offset)
        return NMSResult(*(t[0] for t in res))
    shifted = boxes.float() + classes.float()[..., None] * class_offset
    res = _nms(shifted, scores, iou_threshold, score_threshold, max_outputs)
    picked = _gather_boxes(boxes.float(), torch.clamp(res.indices, min=0))
    return NMSResult(picked * res.mask[..., None], res.scores, res.indices, res.mask)
