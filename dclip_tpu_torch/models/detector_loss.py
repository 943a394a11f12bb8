"""The detector's training objective (counterpart of
`dclip_tpu/models/detector_loss.py`): an anchor-free YOLOv8-family loss
over a padded set of ground-truth boxes, plain tensor ops (the JAX module
has no Pallas kernel).

- Assignment (`assign_targets`): the candidates of a GT box are the
  anchors whose cell centre lies inside it; each is scored
  sqrt(class probability) * sqrt(IoU), the top 10 a GT are kept (the k-th
  largest taken from an ascending sort, as `jnp.sort(...)[..., -k]`), and
  an anchor inside two GTs goes to the better-scored one (`argmax`, the
  first GT on ties).
- Loss (`detection_loss`): CIoU at positives (its aspect term's `alpha`
  detached, nothing else), distribution-focal loss over the reg_max bins,
  and sigmoid BCE against IoU-aware class targets. The IoU in that target
  keeps its gradient, as in the JAX module (ultralytics detaches it; the
  port follows JAX).
- Clipping is `torch.maximum` / `torch.minimum` against a constant, as
  `jnp.clip` and `jnp.maximum` are: at an exact tie they split the
  gradient in half, where `torch.clamp` passes it whole.

`detection_step` runs a training step's forward, loss and backward inside
one `models.detector.f32_convolutions` block, so that cuDNN computes the
convolutions' gradients in f32 as well as their forward.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from dclip_tpu_torch.models.detector import STRIDES, DetectorConfig, f32_convolutions
from dclip_tpu_torch.ops.nms import iou_matrix

Outs = List[Tuple[torch.Tensor, torch.Tensor]]


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`: maximum, then minimum, against constants."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def anchor_points(cfg: DetectorConfig, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(centres [A, 2] xy in pixels, strides [A]) over the three scales,
    row-major over each grid."""
    pts, strides = [], []
    for stride in STRIDES:
        g = cfg.image_size // stride
        c = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) * stride
        gy, gx = torch.meshgrid(c, c, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(torch.full((g * g,), float(stride), device=device))
    return torch.cat(pts, 0), torch.cat(strides, 0)


def flatten_predictions(cfg: DetectorConfig, outs: Outs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scale NHWC head outputs -> (box_logits [B, A, 4, reg_max],
    cls_logits [B, A, nc]) in `anchor_points`' order."""
    box_all, cls_all = [], []
    for box, cls in outs:
        b, h, w, _ = box.shape
        box_all.append(box.reshape(b, h * w, 4, cfg.reg_max))
        cls_all.append(cls.reshape(b, h * w, cfg.num_classes))
    return torch.cat(box_all, 1), torch.cat(cls_all, 1)


def decode_boxes(cfg: DetectorConfig, box_logits: torch.Tensor, centers: torch.Tensor,
                 strides: torch.Tensor) -> torch.Tensor:
    """DFL expectation -> xyxy boxes [B, A, 4] in pixels."""
    bins = torch.arange(cfg.reg_max, dtype=torch.float32, device=box_logits.device)
    dist = torch.sum(torch.softmax(box_logits, -1) * bins, -1)  # [B, A, 4] ltrb
    d = dist * strides[None, :, None]
    cx, cy = centers[None, :, 0], centers[None, :, 1]
    return torch.stack([cx - d[..., 0], cy - d[..., 1], cx + d[..., 2], cy + d[..., 3]], -1)


def ciou(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU of xyxy box pairs, elementwise over the leading dims."""
    lt = torch.maximum(pred[..., :2], gt[..., :2])
    rb = torch.minimum(pred[..., 2:], gt[..., 2:])
    wh = _clip(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = _clip(pred[..., 2] - pred[..., 0], 0.0) * _clip(pred[..., 3] - pred[..., 1], 0.0)
    area_g = _clip(gt[..., 2] - gt[..., 0], 0.0) * _clip(gt[..., 3] - gt[..., 1], 0.0)
    iou = inter / (area_p + area_g - inter + eps)
    # The enclosing box's diagonal and the centres' distance.
    ewh = _clip(torch.maximum(pred[..., 2:], gt[..., 2:])
                - torch.minimum(pred[..., :2], gt[..., :2]), 0.0)
    c2 = ewh[..., 0] ** 2 + ewh[..., 1] ** 2 + eps
    pc = (pred[..., :2] + pred[..., 2:]) / 2
    gc = (gt[..., :2] + gt[..., 2:]) / 2
    rho2 = torch.sum((pc - gc) ** 2, -1)
    # The aspect-ratio consistency term.
    wp = _clip(pred[..., 2] - pred[..., 0], eps)
    hp = _clip(pred[..., 3] - pred[..., 1], eps)
    wg = _clip(gt[..., 2] - gt[..., 0], eps)
    hg = _clip(gt[..., 3] - gt[..., 1], eps)
    v = (4 / math.pi ** 2) * (torch.atan(wg / hg) - torch.atan(wp / hp)) ** 2
    alpha = v / (1 - iou + v + eps)
    return iou - rho2 / c2 - alpha.detach() * v


def assign_targets(cfg: DetectorConfig, pred_boxes: torch.Tensor, cls_logits: torch.Tensor,
                   centers: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_mask: torch.Tensor, topk: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Centre-inside-box assignment with the top-k alignment a GT.

    pred_boxes [B, A, 4], cls_logits [B, A, nc], centers [A, 2], gt_boxes
    [B, G, 4], gt_labels [B, G], gt_mask [B, G] -> (fg [B, A] f32,
    assigned GT [B, A] int32, the IoU with it [B, A], with its gradient)."""
    b, a = pred_boxes.shape[:2]
    g = gt_boxes.shape[1]
    cx, cy = centers[None, None, :, 0], centers[None, None, :, 1]
    inside_x = (cx >= gt_boxes[..., None, 0]) & (cx < gt_boxes[..., None, 2])
    inside_y = (cy >= gt_boxes[..., None, 1]) & (cy < gt_boxes[..., None, 3])
    candidate = inside_x & inside_y & (gt_mask[..., None] > 0)  # [B, G, A]

    ious = iou_matrix(gt_boxes, pred_boxes)  # [B, G, A]
    probs = torch.sigmoid(cls_logits)  # [B, A, nc]
    labels = gt_labels.long()[:, None, :].expand(b, a, g)
    cls_for_gt = torch.gather(probs, 2, labels).transpose(1, 2)  # [B, G, A]
    align = torch.sqrt(_clip(cls_for_gt, 1e-9)) * torch.sqrt(_clip(ious, 1e-9))
    zero = align.new_zeros(())
    align = torch.where(candidate, align, zero)

    k = min(topk, a)
    kth = torch.sort(align, dim=-1).values[..., -k][..., None]
    keep = candidate & (align >= _clip(kth, 1e-9))
    align = torch.where(keep, align, zero)

    # Each anchor belongs to its best-aligned GT.
    assigned = torch.argmax(align, dim=1)  # [B, A], the first GT on ties
    best = torch.amax(align, dim=1)
    fg = (best > 0).float()
    iou_t = torch.gather(ious.transpose(1, 2), 2, assigned[..., None])[..., 0]
    return fg, assigned.to(torch.int32), iou_t


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise sigmoid BCE (the JAX module's
    `optax_sigmoid_bce`)."""
    return (_clip(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def detection_loss(cfg: DetectorConfig, outs: Outs, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_mask: torch.Tensor, box_weight: float = 7.5,
                   cls_weight: float = 0.5, dfl_weight: float = 1.5
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The YOLOv8-style composite loss: gt_boxes [B, G, 4] xyxy pixels,
    gt_labels [B, G], gt_mask [B, G] -> (total, {"loss", "box_loss",
    "cls_loss", "dfl_loss", "num_pos"})."""
    dev = outs[0][0].device
    centers, strides = anchor_points(cfg, dev)
    box_logits, cls_logits = flatten_predictions(cfg, outs)
    pred_boxes = decode_boxes(cfg, box_logits, centers, strides)
    fg, assigned, iou_t = assign_targets(cfg, pred_boxes, cls_logits, centers, gt_boxes,
                                         gt_labels, gt_mask)
    n_pos = _clip(torch.sum(fg), 1.0)

    idx = assigned.long()
    tgt_boxes = torch.gather(gt_boxes.float(), 1, idx[..., None].expand(*idx.shape, 4))
    tgt_labels = torch.gather(gt_labels.long(), 1, idx)

    # Classification: BCE against IoU-aware targets at positives.
    onehot = F.one_hot(tgt_labels, cfg.num_classes).float()
    cls_target = onehot * (fg * _clip(iou_t, 0.0, 1.0))[..., None]
    cls_loss = torch.sum(sigmoid_bce(cls_logits, cls_target)) / n_pos

    # Box: CIoU at positives.
    box_loss = torch.sum((1.0 - ciou(pred_boxes, tgt_boxes)) * fg) / n_pos

    # DFL: cross-entropy spread over the two bins around each side's target
    # distance (in stride units), at positives.
    cx, cy = centers[None, :, 0], centers[None, :, 1]
    lt = torch.stack([cx - tgt_boxes[..., 0], cy - tgt_boxes[..., 1],
                      tgt_boxes[..., 2] - cx, tgt_boxes[..., 3] - cy], -1)
    lt = _clip(lt / strides[None, :, None], 0.0, cfg.reg_max - 1 - 1e-3)
    lo = torch.floor(lt)
    w_hi = lt - lo
    w_lo = 1.0 - w_hi
    logp = torch.log_softmax(box_logits, -1)  # [B, A, 4, reg_max]
    lp_lo = torch.gather(logp, -1, lo.long()[..., None])[..., 0]
    lp_hi = torch.gather(logp, -1, lo.long()[..., None] + 1)[..., 0]
    dfl = -(w_lo * lp_lo + w_hi * lp_hi)  # [B, A, 4]
    dfl_loss = torch.sum(torch.mean(dfl, -1) * fg) / n_pos

    total = box_weight * box_loss + cls_weight * cls_loss + dfl_weight * dfl_loss
    return total, {"loss": total, "box_loss": box_loss, "cls_loss": cls_loss,
                   "dfl_loss": dfl_loss, "num_pos": torch.sum(fg)}


def detection_step(model, cfg: DetectorConfig, images: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_mask: torch.Tensor, **weights
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One training step's forward, loss and backward (gradients accumulate
    into the parameters' `.grad`) inside one `f32_convolutions` block.
    `model` is a `models.detector.YOLO` in the mode the caller set (train:
    batch statistics, running statistics updated). Returns the detached
    (total, parts)."""
    with f32_convolutions():
        total, parts = detection_loss(cfg, model(images), gt_boxes, gt_labels, gt_mask,
                                      **weights)
        total.backward()
    return total.detach(), {k: v.detach() for k, v in parts.items()}
