"""Shared CLI plumbing (counterpart of `dclip_tpu/cli/common.py`).

Every entry point takes the same flags as the JAX package's:
  --model_preset   vit-b-32 | vit-b-16 | vit-l-14 | tiny
  --clip_weights   local HF snapshot dir / .bin / .safetensors, or 'random'
                   (seeded N(0, 0.02) weights; there is no download path)
  --tokenizer_dir  dir containing vocab.json + merges.txt, or 'hash'
plus `--device` (default `cuda`; `cpu` only when asked for).
`restore_student_params` reads the port's own checkpoints.
"""
from __future__ import annotations

import argparse
from typing import Dict, Mapping, Tuple, Union

import torch

from dclip_tpu_torch.core.config import CLIPConfig
from dclip_tpu_torch.core.device import resolve_device, resolve_dtype
from dclip_tpu_torch.models.clip import CLIPModule


def add_model_args(p: argparse.ArgumentParser, default_preset: str = "vit-b-16") -> None:
    p.add_argument("--model_preset", default=default_preset,
                   help="CLIP preset: vit-b-32|vit-b-16|vit-l-14|tiny or HF id alias")
    p.add_argument("--clip_weights", default="random",
                   help="local HF snapshot dir / weight file, or 'random'")
    p.add_argument("--tokenizer_dir", default="hash",
                   help="dir with vocab.json+merges.txt, or 'hash' (test tokenizer)")
    p.add_argument("--seed", type=int, default=42)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")


def load_clip(
    preset: str, weights: str, seed: int = 0, compute_dtype: str = "float32",
    device: Union[str, torch.device] = "cuda",
) -> Tuple[CLIPConfig, CLIPModule]:
    """Build a CLIPModule on `device` from a preset and a weights source.

    compute_dtype: "auto" = bfloat16 on CUDA, float32 on the CPU. Params
    are stored float32; the dtype sets the activations (and the image
    tower's packed kernel weights)."""
    from dclip_tpu_torch.models.weights import load_state_dict_file, random_state_dict

    device = resolve_device(device)
    cfg = CLIPConfig.from_name(preset)
    sd = random_state_dict(cfg, seed) if weights == "random" else load_state_dict_file(weights)
    model = CLIPModule(cfg, dtype=resolve_dtype(compute_dtype, device), device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return cfg, model.to(device).eval()


def synthetic_distill_batch(clip_cfg, teacher_cfg, batch: int, rng=None):
    """Host-numpy distillation batch with the pipeline's field set and
    shapes, copied from `dclip_tpu/cli/common.py:35-74` (same draws from
    the same RandomState): caption spans of 8-24 tokens (a fixed 6 for
    max_length < 26), pixels, teacher pixels, boxes, conf, box_mask."""
    import numpy as np

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


def load_tokenizer(tokenizer_dir: str, max_length: int = 77):
    if tokenizer_dir == "hash":
        from dclip_tpu_torch.data.tokenizer import HashTokenizer

        return HashTokenizer(vocab_size=1000, max_length=max_length)
    from dclip_tpu_torch.data.tokenizer import CLIPTokenizer

    return CLIPTokenizer.from_pretrained_dir(tokenizer_dir, max_length=max_length)


def restore_student_params(checkpoint: str, template: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """The student CLIP's state dict from a checkpoint of the port's
    `train.checkpoint.CheckpointManager` (counterpart of
    `dclip_tpu/cli/common.py:172-182`, which reads flax msgpack).

    `checkpoint`: a trainer checkpoint file (`checkpoint_state()`, the
    parameters under "params"), a file holding a plain state dict, or a
    checkpoint directory (its latest regular checkpoint). Every tensor of
    `template` (the model's `state_dict()`) must be present with its shape;
    the result has the template's names, dtypes and devices."""
    import os

    from dclip_tpu_torch.train.checkpoint import CheckpointManager, restore_state

    if os.path.isdir(checkpoint):
        state = CheckpointManager(checkpoint).restore()
    else:
        state = restore_state(checkpoint)
    if isinstance(state, dict) and isinstance(state.get("params"), dict):
        state = state["params"]
    missing = sorted(set(template) - set(state))
    extra = sorted(set(state) - set(template))
    if missing or extra:
        raise ValueError(f"{checkpoint}: not a checkpoint of this model: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    out = {}
    for name, t in template.items():
        v = state[name]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{checkpoint}: {name} has shape {tuple(v.shape)}, the model "
                             f"{tuple(t.shape)}")
        out[name] = v.to(dtype=t.dtype, device=t.device)
    return out
