"""dclip_tpu_torch — the PyTorch / CUDA port of dclip_tpu for NVIDIA Hopper.

The JAX package `dclip_tpu` stays the reference; this package mirrors its
module layout so each counterpart is found under the same path:

  core/      the config dataclasses (the port's copy), device and
             fast-path resolution, the metrics logger and profiler ranges
  kernels/   hand-written CUDA kernels (csrc/*.cu, built with nvcc at
             first use) behind Python wrappers with plain PyTorch twins
  models/    CLIP dual encoder with HF `CLIPModel` parameter names, the
             meta-teacher (cross-modal attention, region and token
             encoders), the YOLOv8 detector and its ultralytics import,
             the projection heads, the RegionTokenizer, and the weight
             bridge from Flax params / random init
  ops/       CLIP pixel normalization and region crop-resize, teacher
             aggregation, exact k-NN search (sharded over ranks too) and
             its gate, losses and their global-batch forms, caption
             packing, fixed-shape NMS
  parallel/  data parallelism: one process per card in a
             torch.distributed process group (the JAX mesh's counterpart)
  data/      tokenizers, embedding store, detection cache, the corpus
             builders, the input pipeline (MultiModalPipeline), image
             preprocessing, the patch-index builder
  serve/     dynamic request batcher, bucket-padded ClipService
  train/     DistillTrainer (teacher targets with their caches, student
             step), TeacherTrainer (the meta-teacher), masked Adam /
             AdamW, epoch loop, checkpoints, SIGTERM preemption
  native/    the `.dcs` KV store and host top-k, and the libjpeg decoder
             of the input pipeline (C++, built with g++)
  cli/       serve, build_corpus, train_teacher, train_distill,
             flickr30k_eval, zero_shot_eval, karpathy, export_hf, precache,
             build_index, tune_gate, doctor (`python -m
             dclip_tpu_torch.cli.<name>`)

This package imports `torch` and never `jax`, and nothing of the JAX
package `dclip_tpu`: what it needs of it (the config dataclasses, the
native sources) it keeps as its own copies.
"""
from dclip_tpu_torch.core import CLIPConfig, from_name

__all__ = ["CLIPConfig", "from_name"]
__version__ = "0.1.0"
