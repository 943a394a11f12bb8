"""Shared configuration: the CLIP presets and the distillation settings live
in `dclip_tpu.core.config` (JAX-free), so both packages read one source of
truth."""
from dclip_tpu.core.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    DistillConfig,
    TeacherConfig,
)

from_name = CLIPConfig.from_name

__all__ = ["CLIPConfig", "CLIPTextConfig", "CLIPVisionConfig", "DistillConfig",
           "TeacherConfig", "from_name"]
