"""dclip_tpu_torch — the PyTorch / CUDA port of dclip_tpu for NVIDIA Hopper.

The JAX package `dclip_tpu` stays the reference; this package mirrors its
module layout so each counterpart is found under the same path:

  core/      device resolution; re-exports the shared CLIP presets
  kernels/   hand-written CUDA kernels (csrc/*.cu, built with nvcc at
             first use) behind Python wrappers with plain PyTorch twins
  models/    CLIP dual encoder with HF `CLIPModel` parameter names, and
             the weight bridge from Flax params / random init
  ops/       CLIP pixel normalization, exact k-NN search, losses,
             caption packing
  data/      tokenizers, embedding store, serving image resize/crop
  serve/     dynamic request batcher, bucket-padded ClipService
  train/     the cache-warm distillation step: DistillTrainer (student
             half), masked AdamW, teacher-target caches, epoch loop
  cli/       `python -m dclip_tpu_torch.cli.serve`

This package imports `torch` and never `jax`; the only `dclip_tpu`
modules it uses are the JAX-free `dclip_tpu.core.config` (presets) and
`dclip_tpu.native` (the `.dcs` store).
"""
from dclip_tpu_torch.core import CLIPConfig, from_name

__all__ = ["CLIPConfig", "from_name"]
__version__ = "0.1.0"
