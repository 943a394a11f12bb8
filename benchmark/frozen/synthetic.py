"""The traffic generator: the benchmark's frozen copy of the synthetic
distillation batch.

Copied from `dclip_tpu_torch/cli/common.py` `synthetic_distill_batch` at
commit 6dc6ebb3c2bb (itself the JAX package's generator, the same draws
from the same RandomState): caption spans of 8-24 tokens (a fixed 6 for
max_length < 26), pixels, teacher pixels, boxes, confidences and the box
mask, as host numpy. The configurations are `manifest.shapes` namespaces.
"""
from __future__ import annotations

import numpy as np


def synthetic_distill_batch(clip_cfg, teacher_cfg, batch: int, rng=None):
    """Host-numpy distillation batch with the pipeline's field set and
    shapes."""
    rng = rng or np.random.RandomState(0)
    t = clip_cfg.text.max_length
    s = clip_cfg.vision.image_size
    p = teacher_cfg.max_patches
    ids = rng.randint(1, clip_cfg.text.vocab_size - 2, size=(batch, t)).astype(np.int32)
    mask = np.zeros((batch, t), np.int32)
    lengths = rng.randint(8, 25, size=batch) if t >= 26 else np.full(batch, 6)
    for b in range(batch):
        n = int(lengths[b])
        ids[b, n - 1] = clip_cfg.text.eos_token_id
        ids[b, n:] = 0
        mask[b, :n] = 1
    boxes = rng.rand(batch, p, 4).astype(np.float32) * (s / 2)
    boxes[..., 2:] += boxes[..., :2] + 2
    return {
        "pixel_values": rng.randn(batch, s, s, 3).astype(np.float32) * 0.1,
        "input_ids": ids,
        "attention_mask": mask,
        "teacher_pixels": rng.rand(batch, s, s, 3).astype(np.float32),
        "boxes": boxes,
        "conf": rng.rand(batch, p).astype(np.float32),
        "box_mask": np.ones((batch, p), np.float32),
    }
