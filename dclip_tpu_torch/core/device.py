"""Device and compute-dtype resolution.

Counterpart of `dclip_tpu/core/platform.py` and the "auto" dtype rule of
`dclip_tpu/cli/common.py` (bf16 on the accelerator, f32 elsewhere). The
default device is CUDA and asking for it without a card raises: nothing
in this package silently runs on the CPU. The CPU is used only when a
caller names it.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device, None] = "cuda") -> torch.device:
    """`"cuda"` (default), `"cuda:N"` or `"cpu"` -> torch.device.

    Raises RuntimeError for a CUDA device when torch sees no card."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return device


def resolve_dtype(name: str, device: torch.device) -> torch.dtype:
    """"auto" -> bfloat16 on CUDA, float32 on the CPU; else the named dtype."""
    if name == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"compute dtype must be auto|float32|bfloat16, got {name!r}")
    return dtypes[name]
