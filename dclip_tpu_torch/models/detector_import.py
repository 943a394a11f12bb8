"""Ultralytics YOLOv8 checkpoint -> the port's detector (counterpart of
`dclip_tpu/models/detector_import.py`).

The reference's region proposals come from ultralytics YOLOv8x torch
weights (`YOLO("./yolov8x.pt")`). The input is a flat mapping of
ultralytics state-dict names to arrays, e.g. written by
    torch.save(YOLO("yolov8x.pt").model.state_dict(), "yolov8x_sd.pt")
and read here from .pt (`torch.load(weights_only=True)`), .npz or
.safetensors. An ultralytics state dict is already OIHW with torch
BatchNorm names, so the import renames (`_BLOCKS`, the port's own copy of
the JAX layer map) and checks: a missing key or a shape that differs from
`expected_manifest` raises, since a partial import gives a plausibly
wrong detector. `model.22.dfl.conv.weight` (a frozen arange(reg_max)
convolution) has no parameter here: `decode_predictions` computes the DFL
expectation directly.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dclip_tpu_torch.models.detector import YOLO, DetectorConfig

# Ultralytics DetectionModel layer index -> the port's block name
# (yolov8.yaml order; Detect is index 22 for every v8 size).
_BLOCKS = {
    0: ("conv", "stem"),
    1: ("conv", "down1"),
    2: ("c2f", "c2f1"),
    3: ("conv", "down2"),
    4: ("c2f", "c2f2"),
    5: ("conv", "down3"),
    6: ("c2f", "c2f3"),
    7: ("conv", "down4"),
    8: ("c2f", "c2f4"),
    9: ("sppf", "sppf"),
    12: ("c2f", "neck1"),
    15: ("c2f", "neck2"),
    16: ("conv", "neck_down1"),
    18: ("c2f", "neck3"),
    19: ("conv", "neck_down2"),
    21: ("c2f", "neck4"),
    22: ("detect", None),
}
_CONV_BN = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _depths(cfg: DetectorConfig) -> Dict[str, int]:
    """C2f bottleneck counts per block name."""
    d = cfg.depth
    return {"c2f1": d, "c2f2": 2 * d, "c2f3": 2 * d, "c2f4": d,
            "neck1": d, "neck2": d, "neck3": d, "neck4": d}


def _plan(cfg: DetectorConfig):
    """[(ultralytics key, port key)] for this config."""
    rows = []

    def conv_bn(src, dst):
        rows.extend((f"{src}.{leaf}", f"{dst}.{leaf}") for leaf in _CONV_BN)

    depths = _depths(cfg)
    for idx, (kind, name) in _BLOCKS.items():
        src = f"model.{idx}"
        if kind == "conv":
            conv_bn(src, name)
        elif kind in ("sppf", "c2f"):
            conv_bn(f"{src}.cv1", f"{name}.cv1")
            conv_bn(f"{src}.cv2", f"{name}.cv2")
            for j in range(depths.get(name, 0)):
                conv_bn(f"{src}.m.{j}.cv1", f"{name}.m.{j}.cv1")
                conv_bn(f"{src}.m.{j}.cv2", f"{name}.m.{j}.cv2")
        else:  # Detect: cv2 = box branch, cv3 = class branch, per scale
            for s in range(3):
                for branch, head in (("cv2", "box"), ("cv3", "cls")):
                    conv_bn(f"{src}.{branch}.{s}.0", f"head_{head}_a{s}")
                    conv_bn(f"{src}.{branch}.{s}.1", f"head_{head}_b{s}")
                    for leaf in ("weight", "bias"):
                        rows.append((f"{src}.{branch}.{s}.2.{leaf}", f"head_{head}_out{s}.{leaf}"))
    return rows


def expected_manifest(cfg: DetectorConfig) -> Dict[str, Tuple[int, ...]]:
    """{ultralytics key: expected torch shape} for this config, from the
    port's module built on the meta device."""
    shapes = {k: tuple(v.shape) for k, v in YOLO(cfg, device="meta").state_dict().items()}
    return {src: shapes[dst] for src, dst in _plan(cfg)}


def _normalize_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in state_dict.items():
        if k.startswith("model.model."):  # the YOLO wrapper vs DetectionModel
            k = k[len("model."):]
        if k.endswith("num_batches_tracked") or ".dfl." in k:
            continue
        out[k] = v
    return out


def infer_config(state_dict: Mapping[str, Any], **overrides) -> DetectorConfig:
    """width / depth / p5_ch / num_classes / reg_max from checkpoint shapes."""
    sd = _normalize_keys(state_dict)
    width = int(_to_np(sd["model.0.conv.weight"]).shape[0])
    # "model.2.m.{j}.cv1.conv.weight" -> the distinct bottleneck indices j.
    depth = len({k.split(".")[3] for k in sd if k.startswith("model.2.m.")})
    p5 = int(_to_np(sd["model.9.cv2.conv.weight"]).shape[0])
    reg_max = int(_to_np(sd["model.22.cv2.0.2.weight"]).shape[0]) // 4
    num_classes = int(_to_np(sd["model.22.cv3.0.2.weight"]).shape[0])
    kw = dict(width=width, depth=depth, p5_ch=p5, reg_max=reg_max, num_classes=num_classes)
    kw.update(overrides)
    return DetectorConfig(**kw)


def convert_ultralytics_state_dict(cfg: DetectorConfig, state_dict: Mapping[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """Flat ultralytics state dict -> the port's `YOLO` state dict (f32 CPU
    tensors, zero `num_batches_tracked`). Raises with the lists of missing
    and mismatched keys."""
    sd = _normalize_keys(state_dict)
    manifest = expected_manifest(cfg)
    missing = [k for k in manifest if k not in sd]
    if missing:
        raise ValueError(
            f"checkpoint is missing {len(missing)} keys for this config (width={cfg.width}, "
            f"depth={cfg.depth}, p5={cfg.p5}); first few: {missing[:8]}")
    mismatched = [(k, tuple(_to_np(sd[k]).shape), want) for k, want in manifest.items()
                  if tuple(_to_np(sd[k]).shape) != want]
    if mismatched:
        raise ValueError(f"shape mismatches (key, got, want): {mismatched[:8]}")
    out: Dict[str, torch.Tensor] = {}
    for src, dst in _plan(cfg):
        out[dst] = torch.from_numpy(np.array(_to_np(sd[src]), np.float32))
        if dst.endswith("bn.running_var"):
            out[dst[:-len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    unused = sorted(set(sd) - set(manifest))
    if unused:
        print(f"detector import: {len(unused)} unused checkpoint keys (e.g. {unused[:4]})")
    return out


def load_ultralytics_checkpoint(path: str, cfg: Optional[DetectorConfig] = None,
                                **cfg_overrides) -> Tuple[DetectorConfig, Dict[str, torch.Tensor]]:
    """Read a state-dict file (.pt through `torch.load(weights_only=True)`,
    .npz, or .safetensors) and convert. cfg=None infers the architecture
    from the shapes (image_size and the rest through cfg_overrides)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    elif path.endswith(".safetensors"):
        from dclip_tpu_torch.models.hf_export import load_safetensors

        sd = load_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if cfg is None:
        cfg = infer_config(sd, **cfg_overrides)
    return cfg, convert_ultralytics_state_dict(cfg, sd)
