"""Shared inputs for the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

Weights and inputs are drawn with numpy from a seed and handed to both
packages, so the two sides compute on identical values; the port's weights
come across through `dclip_tpu_torch.models.weights.state_dict_from_jax`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule
from dclip_tpu_torch.models.clip import CLIPModule
from dclip_tpu_torch.models.weights import state_dict_from_jax


def _normal(rng, shape, scale):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def layer_params(rng, d: int, mlp: int):
    """One Flax `EncoderLayer` param dict with 1/sqrt(fan_in) matrices (so
    attention is far from uniform), non-zero biases and LN affines."""
    def dense(i, o):
        return {"kernel": _normal(rng, (i, o), i**-0.5), "bias": _normal(rng, (o,), 0.1)}

    def ln():
        return {"scale": 1.0 + _normal(rng, (d,), 0.1), "bias": _normal(rng, (d,), 0.1)}

    return {
        "self_attn": {p: dense(d, d) for p in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "layer_norm1": ln(),
        "layer_norm2": ln(),
        "mlp": {"fc1": dense(d, mlp), "fc2": dense(mlp, d)},
    }


def jax_clip(cfg, seed: int = 0):
    """(JAX CLIPModule, params): the module's param tree filled from numpy —
    LN scales 1 + N(0, 0.1), biases N(0, 0.02), other floats N(0, 0.02)."""
    model = JaxCLIPModule(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.text.max_length), jnp.int32),
        jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3)),
    ))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if name == "logit_scale":
            return np.asarray(cfg.logit_scale_init, np.float32)
        if name == "scale":
            return 1.0 + _normal(rng, s.shape, 0.1)
        return _normal(rng, s.shape, 0.02)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def jax_clip_fan_in(cfg, seed: int = 1):
    """`jax_clip`'s weights with every kernel redrawn at N(0, 1/fan_in). At
    N(0, 0.02) the tiny towers give nearly the same features for every
    crop, caption and image (the signal fades under the LayerNorms), so
    attention is near uniform and, in training, the text-to-image
    attention's q / k gradients sit at the f32 noise floor, where Adam
    turns rounding into steps of about lr."""
    _, params = jax_clip(cfg, seed=seed)
    rng = np.random.RandomState(seed + 100)

    def fill(path, a):
        if str(path[-1].key) != "kernel":
            return a
        return (rng.standard_normal(a.shape) * np.prod(a.shape[:-1]) ** -0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


def port_clip(cfg, params, dtype=torch.float32) -> CLIPModule:
    """The port's CLIPModule on the CPU holding the same weights."""
    model = CLIPModule(cfg, dtype=dtype, device="meta")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True, assign=True)
    return model.eval()


def text_batch(cfg, seed: int = 0):
    """[5, T] ids + mask: padded captions of several lengths (EOS closes
    each) and a last row of full length that holds no EOS id, which pools
    at the last position."""
    rng = np.random.RandomState(seed)
    t, eos = cfg.text.max_length, cfg.text.eos_token_id
    ids = rng.randint(1, eos - 2, size=(5, t)).astype(np.int32)
    mask = np.ones((5, t), np.int32)
    for row, n in enumerate((3, 6, t // 2, t)):
        ids[row, n - 1] = eos
        ids[row, n:] = 0
        mask[row, n:] = 0
    return ids, mask


def pixels(cfg, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    s = cfg.vision.image_size
    return rng.standard_normal((n, s, s, 3)).astype(np.float32)


def jax_teacher_params(d: int, seed: int = 0):
    """A JAX `PatchTextAggregation` param tree ({"cross_modal_attention":
    ...}) filled from numpy: 1/sqrt(D) kernels (attention far from
    uniform), biases N(0, 0.1), LN scales 1 + N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def mha():
        return {n: {"kernel": _normal(rng, (d, d), d**-0.5), "bias": _normal(rng, (d,), 0.1)}
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def ln():
        return {"scale": 1.0 + _normal(rng, (d,), 0.1), "bias": _normal(rng, (d,), 0.1)}

    return {"cross_modal_attention": {"text_to_image": mha(), "image_to_text": mha(),
                                      "norm_text": ln(), "norm_image": ln()}}


def jax_projection_params(d: int, seed: int = 0, hidden: int = 1024):
    """A JAX `ImageProjectionModule` param tree (fc1: d + 4 -> hidden, fc2,
    fc3: hidden -> d) filled from numpy: 1/sqrt(fan_in) kernels, biases
    N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def dense(i, o):
        return {"kernel": _normal(rng, (i, o), i**-0.5), "bias": _normal(rng, (o,), 0.1)}

    return {"fc1": dense(d + 4, hidden), "fc2": dense(hidden, hidden), "fc3": dense(hidden, d)}
