"""The YOLOv8 detector (counterpart of `dclip_tpu/models/detector.py`): the
region-proposal stage of the pipeline (corpus -> detection cache ->
teacher), on the card, and its training mode.

- `YOLO` (JAX `FlaxYOLO`): anchor-free YOLOv8: CSP backbone (C2f blocks +
  SPPF), PAN neck, decoupled heads at strides 8 / 16 / 32 with DFL box
  regression. `DetectorConfig.v8n()..v8x()` are ultralytics' scale table,
  the P5 channel cap and the Detect head's hidden widths included.
- `decode_predictions` + `postprocess`: DFL decode, top-k candidates and
  class-aware NMS (`ops.nms`), all on the device with fixed shapes: a
  padded [B, K] detection set per image.
- `Detector.as_detect_fn()`: the `data.detection_cache` plugin contract,
  (xyxy, conf) in source-image pixels.

The layout contract is the JAX module's: images [B, S, S, 3] in [0, 1]
in, per-scale logits [B, H, W, C] out (NHWC, so that decode flattens the
anchors row-major over (h, w) as JAX does); inside, the convolutions run
in NCHW. Padding is symmetric k // 2 (ultralytics' autopad; torch's
`padding=k // 2`), BatchNorm eps 1e-3 with running statistics in eval
mode. In train mode (`YOLO.train()`) BatchNorm is flax's: it normalizes
with the batch's biased variance and updates the running mean and the
running *biased* variance with momentum 0.97 (`nn.BatchNorm2d` would take
the unbiased one); `models.detector_loss` holds the training objective.

Precision: the JAX module computes in f32 and has no dtype argument. On
the card an f32 convolution goes through cuDNN in TF32 unless told
otherwise (`torch.backends.cudnn.allow_tf32` is True by default), so the
detector's forward pins full f32 convolutions for its own duration
(`f32_convolutions`), whatever the process-wide flag says, and restores
the flag after. The flag is process-wide: detector forwards hold a module
lock while it is pinned, so two of them cannot leave it False, but a
convolution of another thread that overlaps a detector forward runs
without TF32 too. Do not run other convolutions beside the detector in one
process. A training step runs its forward and its backward inside one
`f32_convolutions` block (`models.detector_loss.detection_step`), so that
cuDNN's convolution gradients run in f32 too.

Weights: `Detector.initialize` draws random ones from a seed;
`models.weights.detector_state_dict_from_jax` carries the JAX module's
variables across, batch statistics included; `models.detector_import`
imports an ultralytics checkpoint.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dclip_tpu_torch.core.device import resolve_device
from dclip_tpu_torch.ops.nms import batched_class_nms
from dclip_tpu_torch.ops.retrieval import stable_topk

STRIDES = (8, 16, 32)


@dataclass(frozen=True)
class DetectorConfig:
    num_classes: int = 80
    image_size: int = 640  # must be divisible by 32
    width: int = 16  # base channel count (v8n=16, v8s=32, v8x=80)
    depth: int = 1  # C2f bottleneck count multiplier
    reg_max: int = 16  # DFL bins
    max_detections: int = 32
    iou_threshold: float = 0.45
    score_threshold: float = 0.25
    pre_nms_topk: int = 256
    # P5-stage channels: ultralytics caps the wide variants (`max_channels`
    # in the v8 scale table): n / s keep 16 * width; m=576, l=512, x=640.
    p5_ch: Optional[int] = None

    @property
    def p5(self) -> int:
        return self.p5_ch if self.p5_ch is not None else 16 * self.width

    # The Detect head's hidden widths (ultralytics Detect.__init__): shared
    # across scales, derived from the first scale's channels 4 * width.
    @property
    def head_box_ch(self) -> int:
        return max(16, (4 * self.width) // 4, 4 * self.reg_max)

    @property
    def head_cls_ch(self) -> int:
        return max(4 * self.width, min(self.num_classes, 100))

    @staticmethod
    def v8n() -> "DetectorConfig":
        return DetectorConfig(width=16, depth=1)

    @staticmethod
    def v8s() -> "DetectorConfig":
        return DetectorConfig(width=32, depth=1)

    @staticmethod
    def v8m() -> "DetectorConfig":
        return DetectorConfig(width=48, depth=2, p5_ch=576)

    @staticmethod
    def v8l() -> "DetectorConfig":
        return DetectorConfig(width=64, depth=3, p5_ch=512)

    @staticmethod
    def v8x() -> "DetectorConfig":
        """YOLOv8x, the reference's proposal source."""
        return DetectorConfig(width=80, depth=3, p5_ch=640)


_F32_LOCK = threading.Lock()


@contextlib.contextmanager
def f32_convolutions():
    """Full-f32 cuDNN convolutions (TF32 off) inside the block, one block
    at a time in the process; the process-wide flag is restored on exit."""
    with _F32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


# flax's BatchNorm momentum: running = 0.97 * running + (1 - 0.97) * batch.
FLAX_MOMENTUM = 0.97


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (eps 1e-3, the same state dict) whose train mode is
    flax `BatchNorm(momentum=0.97)`'s: normalize with the batch mean and the
    biased batch variance, then running = 0.97 * running + (1 - 0.97) *
    batch for the mean and that biased variance (`nn.BatchNorm2d` would
    take the unbiased one). The variance is computed in two passes
    (`F.batch_norm`'s training mode, `torch.var_mean`): the function flax
    computes as E[x^2] - E[x]^2, without that form's cancellation in f32,
    whose error grows with the net's width and depth. Eval mode is
    `nn.BatchNorm2d`'s, on the running statistics."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-3, momentum=1.0 - FLAX_MOMENTUM, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.copy_(FLAX_MOMENTUM * self.running_mean
                                    + (1 - FLAX_MOMENTUM) * mean)
            self.running_var.copy_(FLAX_MOMENTUM * self.running_var
                                   + (1 - FLAX_MOMENTUM) * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvBNAct(nn.Module):
    """Conv (no bias, symmetric k // 2 padding) + BatchNorm(eps 1e-3) + SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False, device=device)
        self.bn = FlaxBatchNorm2d(cout, device=device)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, ch: int, shortcut: bool = True, device=None):
        super().__init__()
        self.cv1 = ConvBNAct(ch, ch, 3, device=device)
        self.cv2 = ConvBNAct(ch, ch, 3, device=device)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """CSP bottleneck with two convs and n inner bottlenecks: cv1's output
    splits into halves (a, b) along the channels, the bottlenecks chain on
    b, and cv2 mixes [a, b, m0(b), m1(m0(b)), ...]."""

    def __init__(self, cin: int, ch: int, n: int = 1, shortcut: bool = True, device=None):
        super().__init__()
        hidden = ch // 2
        self.cv1 = ConvBNAct(cin, ch, 1, device=device)
        self.m = nn.ModuleList(Bottleneck(hidden, shortcut, device) for _ in range(n))
        self.cv2 = ConvBNAct((2 + n) * hidden, ch, 1, device=device)

    def forward(self, x):
        outs = list(self.cv1(x).chunk(2, dim=1))
        for m in self.m:
            outs.append(m(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three stacked 5x5 stride-1 max-pools
    (padding 2 behaves as -inf padding, as flax's "SAME" max-pool)."""

    def __init__(self, cin: int, ch: int, device=None):
        super().__init__()
        self.cv1 = ConvBNAct(cin, ch // 2, 1, device=device)
        self.cv2 = ConvBNAct(4 * (ch // 2), ch, 1, device=device)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv2(torch.cat(pools, dim=1))


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLO(nn.Module):
    """Anchor-free detector returning raw per-scale predictions (JAX
    `FlaxYOLO`, the same block names)."""

    def __init__(self, cfg: DetectorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w, d, p5c = cfg.width, cfg.depth, cfg.p5
        dev = device
        self.stem = ConvBNAct(3, w, 3, 2, dev)  # /2
        self.down1 = ConvBNAct(w, 2 * w, 3, 2, dev)  # /4
        self.c2f1 = C2f(2 * w, 2 * w, d, device=dev)
        self.down2 = ConvBNAct(2 * w, 4 * w, 3, 2, dev)  # /8
        self.c2f2 = C2f(4 * w, 4 * w, 2 * d, device=dev)
        self.down3 = ConvBNAct(4 * w, 8 * w, 3, 2, dev)  # /16
        self.c2f3 = C2f(8 * w, 8 * w, 2 * d, device=dev)
        self.down4 = ConvBNAct(8 * w, p5c, 3, 2, dev)  # /32
        self.c2f4 = C2f(p5c, p5c, d, device=dev)
        self.sppf = SPPF(p5c, p5c, dev)
        # PAN neck.
        self.neck1 = C2f(p5c + 8 * w, 8 * w, d, shortcut=False, device=dev)
        self.neck2 = C2f(8 * w + 4 * w, 4 * w, d, shortcut=False, device=dev)
        self.neck_down1 = ConvBNAct(4 * w, 4 * w, 3, 2, dev)
        self.neck3 = C2f(4 * w + 8 * w, 8 * w, d, shortcut=False, device=dev)
        self.neck_down2 = ConvBNAct(8 * w, 8 * w, 3, 2, dev)
        self.neck4 = C2f(8 * w + p5c, p5c, d, shortcut=False, device=dev)
        # Decoupled heads; hidden widths shared across scales, and only the
        # last 1x1 convs carry a bias.
        box_ch, cls_ch = cfg.head_box_ch, cfg.head_cls_ch
        for i, cin in enumerate((4 * w, 8 * w, p5c)):
            setattr(self, f"head_box_a{i}", ConvBNAct(cin, box_ch, 3, device=dev))
            setattr(self, f"head_box_b{i}", ConvBNAct(box_ch, box_ch, 3, device=dev))
            setattr(self, f"head_box_out{i}", nn.Conv2d(box_ch, 4 * cfg.reg_max, 1, device=dev))
            setattr(self, f"head_cls_a{i}", ConvBNAct(cin, cls_ch, 3, device=dev))
            setattr(self, f"head_cls_b{i}", ConvBNAct(cls_ch, cls_ch, 3, device=dev))
            setattr(self, f"head_cls_out{i}", nn.Conv2d(cls_ch, cfg.num_classes, 1, device=dev))

    def forward(self, images: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """images [B, S, S, 3] in [0, 1] -> per scale (box_logits [B, Hs, Ws,
        4 * reg_max], cls_logits [B, Hs, Ws, nc]), strides 8, 16, 32, in the
        weights' dtype (f32; f64 for a reference step)."""
        x = images.to(self.stem.conv.weight.dtype).permute(0, 3, 1, 2)
        x = self.c2f1(self.down1(self.stem(x)))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))
        n4 = self.neck1(torch.cat([_upsample2(p5), p4], dim=1))
        n3 = self.neck2(torch.cat([_upsample2(n4), p3], dim=1))
        n4 = self.neck3(torch.cat([self.neck_down1(n3), n4], dim=1))
        n5 = self.neck4(torch.cat([self.neck_down2(n4), p5], dim=1))
        outs = []
        for i, feat in enumerate((n3, n4, n5)):
            box = getattr(self, f"head_box_b{i}")(getattr(self, f"head_box_a{i}")(feat))
            box = getattr(self, f"head_box_out{i}")(box)
            cls = getattr(self, f"head_cls_b{i}")(getattr(self, f"head_cls_a{i}")(feat))
            cls = getattr(self, f"head_cls_out{i}")(cls)
            outs.append((box.permute(0, 2, 3, 1), cls.permute(0, 2, 3, 1)))
        return outs


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, K, 4] xyxy in input pixels
    scores: torch.Tensor  # [B, K]
    classes: torch.Tensor  # [B, K] int32
    mask: torch.Tensor  # [B, K]


def decode_predictions(cfg: DetectorConfig, outs: List[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scale NHWC logits -> (boxes [B, A, 4] xyxy pixels, scores [B, A,
    nc]). DFL: softmax over the reg_max bins dotted with arange(reg_max)
    gives the l / t / r / b distances in stride units from each grid-cell
    centre (+0.5); the scales concatenate in stride order 8, 16, 32."""
    all_boxes, all_scores = [], []
    for (box_logits, cls_logits), stride in zip(outs, STRIDES):
        b, h, w, _ = box_logits.shape
        dev = box_logits.device
        bins = torch.arange(cfg.reg_max, dtype=torch.float32, device=dev)
        dist = box_logits.float().reshape(b, h, w, 4, cfg.reg_max)
        dist = torch.sum(torch.softmax(dist, dim=-1) * bins, dim=-1)  # [B, H, W, 4]
        cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
        cx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
        x1 = (cx - dist[..., 0]) * stride
        y1 = (cy - dist[..., 1]) * stride
        x2 = (cx + dist[..., 2]) * stride
        y2 = (cy + dist[..., 3]) * stride
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1).reshape(b, h * w, 4))
        all_scores.append(torch.sigmoid(cls_logits.float()).reshape(b, h * w, cfg.num_classes))
    return torch.cat(all_boxes, 1), torch.cat(all_scores, 1)


def postprocess(cfg: DetectorConfig, boxes: torch.Tensor, scores: torch.Tensor) -> Detections:
    """The top `pre_nms_topk` anchors by best class score (ties to the lower
    anchor, `jax.lax.top_k`'s order), clipped to the frame, then class-aware
    NMS per image, batched; classes are zero where the mask is."""
    cls_idx = torch.argmax(scores, dim=-1)  # [B, A], first class on ties
    cls_score = torch.gather(scores, -1, cls_idx[..., None]).squeeze(-1)
    k = min(cfg.pre_nms_topk, boxes.shape[1])
    top_scores, top = stable_topk(cls_score, k)
    top = top.long()
    # Clip to the frame (ultralytics clip_boxes): DFL can place an edge up
    # to reg_max * stride outside the image.
    cand_boxes = torch.clamp(torch.gather(boxes, 1, top[..., None].expand(*top.shape, 4)),
                             0.0, float(cfg.image_size))
    cand_cls = torch.gather(cls_idx, 1, top)
    # The offset must exceed any clipped coordinate, or classes collide.
    res = batched_class_nms(cand_boxes, top_scores, cand_cls, cfg.iou_threshold,
                            cfg.score_threshold, cfg.max_detections,
                            class_offset=float(cfg.image_size) + 512.0)
    safe = torch.clamp(res.indices, min=0).long()
    classes = torch.gather(cand_cls, 1, safe) * res.mask.to(cand_cls.dtype)
    return Detections(res.boxes, res.scores, classes.to(torch.int32), res.mask)


def random_detector_state_dict(cfg: DetectorConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random weights: conv kernels N(0, 1 / fan_in) from a
    `torch.Generator`, BatchNorm at its identity (scale 1, bias 0, mean 0,
    var 1), head biases 0 (flax's initializers' shapes and scales, not
    their draws)."""
    gen = torch.Generator().manual_seed(seed)
    model = YOLO(cfg, device="meta")
    out = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long)
        elif t.dim() == 4:
            fan_in = t.shape[1] * t.shape[2] * t.shape[3]
            out[name] = torch.randn(t.shape, generator=gen) * fan_in ** -0.5
        elif name.endswith(("running_var", "bn.weight")):
            out[name] = torch.ones(t.shape)
        else:
            out[name] = torch.zeros(t.shape)
    return out


class Detector:
    """The detector end to end (forward, decode, NMS) on one device, and
    the `DetectionCache` `detect_fn` adapter."""

    def __init__(self, cfg: DetectorConfig, state_dict: Dict[str, torch.Tensor], device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = YOLO(cfg, device="meta")
        model.load_state_dict({k: v.detach().to(self.device, copy=True)
                               for k, v in state_dict.items()}, strict=True, assign=True)
        self.model = model.eval().requires_grad_(False)

    @classmethod
    def initialize(cls, cfg: DetectorConfig, seed: int = 0, device="cuda") -> "Detector":
        return cls(cfg, random_detector_state_dict(cfg, seed), device)

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor)
                               else images, dtype=torch.float32).to(self.device)

    def logits(self, images) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The network alone: per-scale NHWC logits, full f32."""
        with torch.inference_mode(), f32_convolutions():
            return self.model(self._images(images))

    def detect(self, images) -> Detections:
        """images [B, S, S, 3] in [0, 1], S = cfg.image_size."""
        outs = self.logits(images)
        with torch.inference_mode():
            boxes, scores = decode_predictions(self.cfg, outs)
            return postprocess(self.cfg, boxes, scores)

    def as_detect_fn(self):
        """(image_rgb_uint8 [H, W, 3]) -> (xyxy [N, 4] source pixels, conf
        [N]): a PIL bilinear resize to S x S, / 255, detect, boxes scaled
        back (the `data.detection_cache` plugin contract). Needs PIL
        (`data.pipeline.require_pil`)."""
        from dclip_tpu_torch.data.pipeline import require_pil

        Image = require_pil()
        s = self.cfg.image_size

        def detect_fn(image: np.ndarray):
            h, w = image.shape[:2]
            resized = np.asarray(Image.fromarray(image).resize((s, s), Image.BILINEAR),
                                 np.float32) / 255.0
            det = self.detect(resized[None])
            mask = det.mask[0].cpu().numpy() > 0
            boxes = det.boxes[0].cpu().numpy()[mask]
            conf = det.scores[0].cpu().numpy()[mask]
            boxes = boxes * np.asarray([w / s, h / s, w / s, h / s], np.float32)
            return boxes.astype(np.float32), conf.astype(np.float32)

        return detect_fn
