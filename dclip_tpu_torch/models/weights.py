"""The weight bridge: Flax params or random init -> the port's state dict.

The port's `CLIPModule` names its parameters the way HF `CLIPModel`'s
state dict does, so three sources meet in one layout:

- `state_dict_from_jax`: the JAX package's `variables["params"]` (nested
  dict of arrays) -> HF names and torch layouts. The mapping is the one
  `dclip_tpu/models/hf_export.py` `export_state_dict` writes: Flax Dense
  kernel [in, out] -> Linear weight [out, in]; patch conv HWIO
  [ph, pw, 3, D] -> OIHW (the inverse of `hf_import.py:88-91`); LayerNorm
  `scale` -> `weight`; `logit_scale` comes across.
- `random_state_dict`: the value rule of `dclip_tpu/cli/common.py`
  `host_random_variables` (LayerNorm scale 1, biases 0, every other float
  N(0, 0.02)) drawn from `np.random.RandomState(seed)`. The draw order is
  the port's parameter order, not JAX's tree order.
- `load_state_dict_file`: a local HF snapshot dir, `pytorch_model.bin` or
  `model.safetensors`.

The meta-teacher's weights (`models.teacher.PatchTextAggregation`, torch
`nn.MultiheadAttention` names under `cross_modal_attention.`) come from
`teacher_state_dict_from_jax` (the inverse of the JAX package's
`import_torch_cross_modal`) or `random_teacher_state_dict`, which draws
them by the same value rule in the JAX tree's order, so it equals the
bridge of the JAX package's random teacher of the same seed.

The detector's (`models.detector.YOLO`), the k-NN gate's projection
head's (`models.projections.ImageProjectionModule`) and BERT's
(`models.bert.BertEncoder`, HF `BertModel` names) come across from the JAX
modules' variables by `detector_state_dict_from_jax`,
`projection_state_dict_from_jax` and `bert_state_dict_from_jax`.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def layer_state_dict_from_jax(layer: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """One Flax `EncoderLayer` param dict -> HF names under `prefix`."""
    sd: Dict[str, torch.Tensor] = {}

    def dense(name, p):
        sd[f"{prefix}{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{prefix}{name}.bias"] = _t(p["bias"])

    def ln(name, p):
        sd[f"{prefix}{name}.weight"] = _t(p["scale"])
        sd[f"{prefix}{name}.bias"] = _t(p["bias"])

    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        dense(f"self_attn.{proj}", layer["self_attn"][proj])
    ln("layer_norm1", layer["layer_norm1"])
    dense("mlp.fc1", layer["mlp"]["fc1"])
    dense("mlp.fc2", layer["mlp"]["fc2"])
    ln("layer_norm2", layer["layer_norm2"])
    return sd


def state_dict_from_jax(flax_params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX `CLIPModule` params -> the port's (HF `CLIPModel`) state dict,
    f32 CPU tensors."""
    sd: Dict[str, torch.Tensor] = {}
    t = flax_params["text_model"]
    sd["text_model.embeddings.token_embedding.weight"] = _t(t["token_embedding"]["embedding"])
    sd["text_model.embeddings.position_embedding.weight"] = _t(t["position_embedding"])
    for i in range(cfg.text.num_layers):
        sd.update(layer_state_dict_from_jax(
            t["encoder"][f"layers_{i}"], f"text_model.encoder.layers.{i}."))
    sd["text_model.final_layer_norm.weight"] = _t(t["final_layer_norm"]["scale"])
    sd["text_model.final_layer_norm.bias"] = _t(t["final_layer_norm"]["bias"])

    v = flax_params["vision_model"]
    sd["vision_model.embeddings.class_embedding"] = _t(v["class_embedding"])
    sd["vision_model.embeddings.patch_embedding.weight"] = _t(
        np.asarray(v["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    sd["vision_model.embeddings.position_embedding.weight"] = _t(v["position_embedding"])
    # HF's checkpoint key keeps the "pre_layrnorm" spelling.
    sd["vision_model.pre_layrnorm.weight"] = _t(v["pre_layernorm"]["scale"])
    sd["vision_model.pre_layrnorm.bias"] = _t(v["pre_layernorm"]["bias"])
    for i in range(cfg.vision.num_layers):
        sd.update(layer_state_dict_from_jax(
            v["encoder"][f"layers_{i}"], f"vision_model.encoder.layers.{i}."))
    sd["vision_model.post_layernorm.weight"] = _t(v["post_layernorm"]["scale"])
    sd["vision_model.post_layernorm.bias"] = _t(v["post_layernorm"]["bias"])

    sd["text_projection.weight"] = _t(np.asarray(flax_params["text_projection"]["kernel"]).T)
    sd["visual_projection.weight"] = _t(np.asarray(flax_params["visual_projection"]["kernel"]).T)
    sd["logit_scale"] = _t(flax_params["logit_scale"]).reshape(())
    return sd


def random_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights by the JAX CLI's `--clip_weights random` rule:
    LayerNorm scales 1, biases 0, everything else N(0, 0.02), f32."""
    from dclip_tpu_torch.models.siglip import dual_encoder_class

    shapes = dual_encoder_class(cfg)(cfg, device="meta")  # names and shapes, no memory
    ln_scales = {
        f"{name}.weight" for name, m in shapes.named_modules()
        if isinstance(m, torch.nn.LayerNorm)
    }
    rng = np.random.RandomState(seed)
    sd: Dict[str, torch.Tensor] = {}
    for name, p in shapes.state_dict().items():
        if name in ln_scales:
            sd[name] = torch.ones(p.shape)
        elif name.endswith("bias"):
            sd[name] = torch.zeros(p.shape)
        else:
            sd[name] = torch.from_numpy(
                np.asarray(rng.standard_normal(tuple(p.shape)) * 0.02, np.float32))
    return sd


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A local HF snapshot dir / `pytorch_model.bin` / `model.safetensors`
    -> state dict (CPU tensors). No network path exists."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {path}")
    if path.endswith(".safetensors"):
        from dclip_tpu_torch.models.hf_export import load_safetensors

        sd = {k: torch.from_numpy(v) for k, v in load_safetensors(path).items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    # Older HF checkpoints carry the `position_ids` buffers; they are not
    # parameters of the model.
    return {k: v for k, v in sd.items() if not k.endswith("position_ids")}


_TEACHER_DIRECTIONS = ("image_to_text", "text_to_image")  # JAX tree (sorted) order
_TEACHER_NORMS = ("norm_image", "norm_text")


def teacher_state_dict_from_jax(teacher_params: Mapping[str, Any],
                                prefix: str = "cross_modal_attention.") -> Dict[str, torch.Tensor]:
    """The JAX teacher's params `{"cross_modal_attention": {...}}` (Flax
    Dense kernels [in, out]) -> the port's teacher state dict: per
    direction `in_proj_weight` [3D, D] (q, k, v rows), `in_proj_bias`,
    `out_proj.weight` / `.bias`, and `norm_*.weight` / `.bias`."""
    cm = teacher_params["cross_modal_attention"]
    sd: Dict[str, torch.Tensor] = {}
    for direction in _TEACHER_DIRECTIONS:
        p = cm[direction]
        qkv = ("q_proj", "k_proj", "v_proj")
        sd[f"{prefix}{direction}.in_proj_weight"] = _t(
            np.concatenate([np.asarray(p[n]["kernel"]).T for n in qkv]))
        sd[f"{prefix}{direction}.in_proj_bias"] = _t(
            np.concatenate([np.asarray(p[n]["bias"]) for n in qkv]))
        sd[f"{prefix}{direction}.out_proj.weight"] = _t(np.asarray(p["out_proj"]["kernel"]).T)
        sd[f"{prefix}{direction}.out_proj.bias"] = _t(p["out_proj"]["bias"])
    for norm in _TEACHER_NORMS:
        sd[f"{prefix}{norm}.weight"] = _t(cm[norm]["scale"])
        sd[f"{prefix}{norm}.bias"] = _t(cm[norm]["bias"])
    return sd


def random_teacher_state_dict(teacher_cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random teacher weights by the `host_random_variables` rule (LayerNorm
    scale 1, biases 0, kernels N(0, 0.02)), drawn from
    `np.random.RandomState(seed)` in the JAX tree's order: per direction
    (image_to_text, then text_to_image) the k, out, q, v kernels, [in, out]."""
    d = teacher_cfg.embed_dim
    rng = np.random.RandomState(seed)
    cm: Dict[str, Any] = {}
    for direction in _TEACHER_DIRECTIONS:
        cm[direction] = {
            name: {"kernel": np.asarray(rng.standard_normal((d, d)) * 0.02, np.float32),
                   "bias": np.zeros(d, np.float32)}
            for name in ("k_proj", "out_proj", "q_proj", "v_proj")
        }
    for norm in _TEACHER_NORMS:
        cm[norm] = {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}
    return teacher_state_dict_from_jax({"cross_modal_attention": cm})


def detector_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX `FlaxYOLO`'s variables `{"params": ..., "batch_stats": ...}`
    -> the port's `models.detector.YOLO` state dict: conv kernels HWIO ->
    OIHW, BatchNorm `scale` / `bias` -> `bn.weight` / `bn.bias`, the
    `batch_stats` `mean` / `var` -> `bn.running_mean` / `bn.running_var`
    (with a zero `num_batches_tracked`), flax's `m{j}` bottlenecks ->
    `m.{j}`."""
    sd: Dict[str, torch.Tensor] = {}

    def put(path, value, collection):
        prefix = ".".join(re.sub(r"^m(\d+)$", r"m.\1", p) for p in path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(value), (3, 2, 0, 1)))
        elif collection == "batch_stats":
            sd[f"{prefix}.running_{leaf}"] = _t(value)
            sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        else:
            sd[f"{prefix}.{'weight' if leaf == 'scale' else leaf}"] = _t(value)

    def walk(tree, path, collection):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,), collection)
            else:
                put(path + (key,), value, collection)

    for collection in ("params", "batch_stats"):
        walk(variables[collection], (), collection)
    return sd


def projection_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX projection module's params (`{"fc1": {"kernel", "bias"}, ...}`,
    Dense kernels [in, out]) -> `fc*.weight` [out, in] / `fc*.bias`."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def bert_state_dict_from_jax(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX `BertEncoder`'s params -> the port's `models.bert.BertEncoder`
    state dict (HF `BertModel` names): Dense kernels [in, out] -> weights
    [out, in], `embedding` tables and the bare `position_embeddings` array
    as they are, LayerNorm `scale` -> `weight`."""
    sd: Dict[str, torch.Tensor] = {}

    def dense(name, p):
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = _t(p["bias"])

    def ln(name, p):
        sd[f"{name}.weight"] = _t(p["scale"])
        sd[f"{name}.bias"] = _t(p["bias"])

    sd["embeddings.word_embeddings.weight"] = _t(params["word_embeddings"]["embedding"])
    sd["embeddings.position_embeddings.weight"] = _t(params["position_embeddings"])
    sd["embeddings.token_type_embeddings.weight"] = _t(
        params["token_type_embeddings"]["embedding"])
    ln("embeddings.LayerNorm", params["embeddings_norm"])
    for i in range(cfg.num_layers):
        layer, pre = params[f"layers_{i}"], f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            dense(f"{pre}attention.self.{name}", layer["attention"][name])
        dense(f"{pre}attention.output.dense", layer["attention_output"])
        ln(f"{pre}attention.output.LayerNorm", layer["attention_norm"])
        dense(f"{pre}intermediate.dense", layer["intermediate"])
        dense(f"{pre}output.dense", layer["output"])
        ln(f"{pre}output.LayerNorm", layer["output_norm"])
    dense("pooler.dense", params["pooler"])
    return sd
