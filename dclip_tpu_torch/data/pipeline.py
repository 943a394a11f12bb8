"""Host image preprocessing (copy of `dclip_tpu/data/pipeline.py:77-107`).

`resize_crop_uint8` serves the serving path, which ships its uint8 output
to the device and normalizes there (`ops.image_ops.normalize`);
`preprocess_image` the eval path, which normalizes on the host. Both need
PIL, imported when called; without it they raise (the native JPEG decoder
that replaces it is ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import numpy as np

from dclip_tpu_torch.ops.image_ops import CLIP_MEAN, CLIP_STD


def require_pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "image preprocessing needs PIL, which this installation lacks; the native "
            "JPEG decoder that replaces it is ROADMAP Queue 1 item 5") from e
    return Image


def resize_crop_uint8(image, size: int = 224) -> np.ndarray:
    """HF CLIPProcessor resize/crop geometry WITHOUT normalization:
    bicubic shortest-side resize + center crop, uint8 [size, size, 3]."""
    Image = require_pil()
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


def preprocess_image(image, size: int = 224) -> np.ndarray:
    """HF CLIPProcessor-parity preprocessing: bicubic shortest-side resize,
    center crop, rescale 1/255, CLIP mean/std normalize. NHWC float32."""
    arr = resize_crop_uint8(image, size).astype(np.float32) / 255.0
    return (arr - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
