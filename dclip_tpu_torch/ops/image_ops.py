"""CLIP pixel normalization (counterpart of `dclip_tpu/ops/image_ops.py:17-26`)."""
from __future__ import annotations

import torch

# OpenAI CLIP normalization constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] in [0, 1] -> CLIP-normalized, same dtype and device."""
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std
