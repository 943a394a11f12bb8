"""Seeded random weights, made on the device: the student CLIP, the
teacher's CLIP and the teacher's cross-attention, by HF's parameter names.

Each group is one `normal_(0, 0.02)` draw from a `torch.Generator` on the
device into one flat float32 buffer, sliced into the leaves; LayerNorm
scales are 1, biases 0 and the logit scale its published initial value.
The same seed gives the same weights on the same kind of device, so the
reference makes them again after the program has run instead of keeping a
copy.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str]  # name, shape, "normal" | "ones" | "zeros" | "logit"
GROUPS = ("student", "teacher_clip", "teacher_xattn")


def _layers(prefix: str, tower) -> List[Spec]:
    d, m = tower.hidden_size, tower.mlp_dim
    out: List[Spec] = []
    for i in range(tower.num_layers):
        lp = f"{prefix}.encoder.layers.{i}"
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out += [(f"{lp}.self_attn.{proj}.weight", (d, d), "normal"),
                    (f"{lp}.self_attn.{proj}.bias", (d,), "zeros")]
        out += [(f"{lp}.layer_norm1.weight", (d,), "ones"),
                (f"{lp}.layer_norm1.bias", (d,), "zeros"),
                (f"{lp}.mlp.fc1.weight", (m, d), "normal"), (f"{lp}.mlp.fc1.bias", (m,), "zeros"),
                (f"{lp}.mlp.fc2.weight", (d, m), "normal"), (f"{lp}.mlp.fc2.bias", (d,), "zeros"),
                (f"{lp}.layer_norm2.weight", (d,), "ones"),
                (f"{lp}.layer_norm2.bias", (d,), "zeros")]
    return out


def clip_specs(shapes) -> List[Spec]:
    """HF `CLIPModel`'s state dict at these shapes."""
    t, v, p = shapes.text, shapes.vision, shapes.projection_dim
    n_pos = (v.image_size // v.patch_size) ** 2 + 1
    specs: List[Spec] = [
        ("text_model.embeddings.token_embedding.weight", (t.vocab_size, t.hidden_size), "normal"),
        ("text_model.embeddings.position_embedding.weight", (t.max_length, t.hidden_size),
         "normal")]
    specs += _layers("text_model", t)
    specs += [("text_model.final_layer_norm.weight", (t.hidden_size,), "ones"),
              ("text_model.final_layer_norm.bias", (t.hidden_size,), "zeros"),
              ("vision_model.embeddings.class_embedding", (v.hidden_size,), "normal"),
              ("vision_model.embeddings.patch_embedding.weight",
               (v.hidden_size, 3, v.patch_size, v.patch_size), "normal"),
              ("vision_model.embeddings.position_embedding.weight", (n_pos, v.hidden_size),
               "normal"),
              ("vision_model.pre_layrnorm.weight", (v.hidden_size,), "ones"),
              ("vision_model.pre_layrnorm.bias", (v.hidden_size,), "zeros")]
    specs += _layers("vision_model", v)
    specs += [("vision_model.post_layernorm.weight", (v.hidden_size,), "ones"),
              ("vision_model.post_layernorm.bias", (v.hidden_size,), "zeros"),
              ("visual_projection.weight", (p, v.hidden_size), "normal"),
              ("text_projection.weight", (p, t.hidden_size), "normal"),
              ("logit_scale", (), "logit")]
    return specs


def xattn_specs(shapes) -> List[Spec]:
    """The teacher's `cross_modal_attention.*` state dict (torch
    `nn.MultiheadAttention` names, one per direction, and two LayerNorms)."""
    d = shapes.teacher.embed_dim
    specs: List[Spec] = []
    for direction in ("text_to_image", "image_to_text"):
        pre = f"cross_modal_attention.{direction}"
        specs += [(f"{pre}.in_proj_weight", (3 * d, d), "normal"),
                  (f"{pre}.in_proj_bias", (3 * d,), "zeros"),
                  (f"{pre}.out_proj.weight", (d, d), "normal"),
                  (f"{pre}.out_proj.bias", (d,), "zeros")]
    for norm in ("norm_text", "norm_image"):
        specs += [(f"cross_modal_attention.{norm}.weight", (d,), "ones"),
                  (f"cross_modal_attention.{norm}.bias", (d,), "zeros")]
    return specs


def group_seed(seed: int, group: str) -> int:
    """A generator seed per (run seed, group): the seed may exceed 32 bits."""
    return (int(seed) * 1_000_003 + GROUPS.index(group) + 1) % (1 << 63)


def make(specs: List[Spec], seed: int, group: str, device, logit_init: float = 2.6592,
         host: bool = False) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor}: views of one normal draw and of one ones and
    one zeros buffer, made on `device`; with `host` the buffers are copied
    to the host first, one transfer each, as a run loads its weights."""
    def numel(shape):
        n = 1
        for s in shape:
            n *= s
        return n

    sizes = {kind: sum(numel(s) for _, s, k in specs if k == kind)
             for kind in ("normal", "ones", "zeros", "logit")}
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    bufs = {"normal": torch.empty(sizes["normal"], device=device),
            "ones": torch.ones(sizes["ones"], device=device),
            "zeros": torch.zeros(sizes["zeros"], device=device),
            "logit": torch.full((sizes["logit"],), logit_init, device=device)}
    bufs["normal"].normal_(0.0, 0.02, generator=gen)
    if host:
        bufs = {k: b.cpu() for k, b in bufs.items()}
    offsets = dict.fromkeys(bufs, 0)
    out: Dict[str, torch.Tensor] = {}
    for name, shape, kind in specs:
        n = numel(shape)
        out[name] = bufs[kind][offsets[kind]:offsets[kind] + n].view(shape)
        offsets[kind] += n
    return out


def all_groups(shapes, seed: int, device, host: bool = False
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"student": make(clip_specs(shapes), seed, "student", device, shapes.logit_init, host),
            "teacher_clip": make(clip_specs(shapes), seed, "teacher_clip", device,
                                 shapes.logit_init, host),
            "teacher_xattn": make(xattn_specs(shapes), seed, "teacher_xattn", device, host=host)}
