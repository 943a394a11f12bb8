"""Shared configuration: the CLIP presets and the distillation settings
(`core/config.py`, the port's copy of the JAX package's dataclasses)."""
from dclip_tpu_torch.core.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    DistillConfig,
    TeacherConfig,
)

from_name = CLIPConfig.from_name

__all__ = ["CLIPConfig", "CLIPTextConfig", "CLIPVisionConfig", "DistillConfig",
           "TeacherConfig", "from_name"]
