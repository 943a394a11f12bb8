"""Serving-side image geometry (copy of `dclip_tpu/data/pipeline.py:77-97`).

Only `resize_crop_uint8` is ported: the serving path ships its uint8
output to the device and normalizes there (`ops.image_ops.normalize`).
"""
from __future__ import annotations

import numpy as np


def resize_crop_uint8(image, size: int = 224) -> np.ndarray:
    """HF CLIPProcessor resize/crop geometry WITHOUT normalization:
    bicubic shortest-side resize + center crop, uint8 [size, size, 3]."""
    from PIL import Image

    w, h = image.size
    # HF get_resize_output_image_size: shortest edge -> size, long side
    # truncated (int()), not rounded.
    if w <= h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    image = image.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    image = image.crop((left, top, left + size, top + size))
    return np.asarray(image, np.uint8)
