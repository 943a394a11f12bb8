"""Fast-path resolution for the port (counterpart of
`dclip_tpu/core/config.py:376-409` `resolve_fast_paths`).

On a CUDA device the "auto" fields resolve as they do on the TPU: bf16
compute, the hand-written kernels on (`use_pallas`, the field name the
JAX config shares), crop compaction of the teacher's region encode on,
packed text on. On the CPU they resolve as the JAX
package resolves them off the TPU: f32 and the plain paths. Explicit
settings always win; `fused_attn_block` (K9, measured slower on the TPU)
stays off.
"""
from __future__ import annotations

import dataclasses

import torch


def resolve_fast_paths(cfg, device: torch.device):
    on_cuda = torch.device(device).type == "cuda"
    updates: dict = {}
    if getattr(cfg, "compute_dtype", None) == "auto":
        updates["compute_dtype"] = "bfloat16" if on_cuda else "float32"
    for name in ("use_pallas", "compact_patches", "packed_text"):
        if hasattr(cfg, name) and getattr(cfg, name) is None:
            updates[name] = on_cuda
    if getattr(cfg, "fused_attn_block", False) is None:
        updates["fused_attn_block"] = False
    return dataclasses.replace(cfg, **updates) if updates else cfg
