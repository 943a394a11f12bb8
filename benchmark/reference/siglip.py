"""The plain SigLIP towers and the student step around them: the
benchmark's reference of the `siglip-so400m-14-384` cells.

Written from HF `SiglipModel` (`modeling_siglip.py`) and the published
config of google/siglip-so400m-patch14-384, with HF's parameter names, in
plain PyTorch, importing nothing of the program:

- Image tower: a stride-p patch convolution with its bias over the first
  (H // p) p pixels of each side (729 patches at 384 px), learned
  positions, no class token and no pre-LayerNorm; pre-norm encoder layers
  (bidirectional multi-head attention at scale head_dim^-0.5, a
  tanh-GELU MLP); the post-LayerNorm of every token; the multihead
  attention-pooling head: one learned probe attends to the tokens through
  torch's packed `in_proj` and `out_proj`, then y = h + MLP(LN(h)), row 0.
- Text tower: token and position embeddings, the same layers without a
  mask (SigLIP's processor pads captions to 64 with the pad id and gives
  none), the final LayerNorm, the last position through the linear head.
- No projections: the pooled outputs are the features. The student
  trains on DCLIP's objective (`reference.step.loss_parts`), not SigLIP's
  sigmoid loss; `logit_scale` and `logit_bias` are held and unused.

Products go through `reference.clip.Precision` (float32 with TF32 off, or
the float8 control); LayerNorm, softmax and every sum in float32. The step
is `reference.step`'s, its embeddings taken in blocks of `BLOCK` images.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.clip import Precision, layer_norm
from benchmark.reference.step import ReferenceStudent
from benchmark.weights import Spec

# Images a block: a block's graph at 729 tokens x 27 layers fits beside the
# state; the float8 control keeps a rounded copy of every product's operands,
# so it takes half the rows.
BLOCK = 16


def shapes(config: dict) -> SimpleNamespace:
    """A SigLIP configuration file's sizes."""
    t, v, tc = config["text_config"], config["vision_config"], config["teacher"]

    def tower(c):
        return dict(hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
                    num_heads=c["num_attention_heads"], mlp_dim=c["intermediate_size"],
                    layer_norm_eps=c["layer_norm_eps"])

    text = SimpleNamespace(vocab_size=t["vocab_size"], max_length=t["max_position_embeddings"],
                           eos_token_id=t["eos_token_id"], pad_token_id=t["pad_token_id"],
                           **tower(t))
    vision = SimpleNamespace(image_size=v["image_size"], patch_size=v["patch_size"],
                             **tower(v))
    return SimpleNamespace(text=text, vision=vision, projection_dim=config["projection_dim"],
                           logit_init=config["logit_scale_init_value"],
                           teacher=SimpleNamespace(**tc))


def num_patches(v) -> int:
    return (v.image_size // v.patch_size) ** 2


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


def siglip_specs(sh) -> List[Spec]:
    """HF `SiglipModel`'s state dict at these shapes, for `benchmark.weights.make`."""
    t, v = sh.text, sh.vision
    d, p = v.hidden_size, v.patch_size
    specs: List[Spec] = [("logit_scale", (1,), "logit"), ("logit_bias", (1,), "zeros"),
                         ("text_model.embeddings.token_embedding.weight",
                          (t.vocab_size, t.hidden_size), "normal"),
                         ("text_model.embeddings.position_embedding.weight",
                          (t.max_length, t.hidden_size), "normal")]
    specs += _layers("text_model", t)
    specs += [("text_model.final_layer_norm.weight", (t.hidden_size,), "ones"),
              ("text_model.final_layer_norm.bias", (t.hidden_size,), "zeros"),
              ("text_model.head.weight", (t.hidden_size, t.hidden_size), "normal"),
              ("text_model.head.bias", (t.hidden_size,), "zeros"),
              ("vision_model.embeddings.patch_embedding.weight", (d, 3, p, p), "normal"),
              ("vision_model.embeddings.patch_embedding.bias", (d,), "zeros"),
              ("vision_model.embeddings.position_embedding.weight", (num_patches(v), d),
               "normal")]
    specs += _layers("vision_model", v)
    h = "vision_model.head"
    specs += [("vision_model.post_layernorm.weight", (d,), "ones"),
              ("vision_model.post_layernorm.bias", (d,), "zeros"),
              (f"{h}.probe", (1, 1, d), "normal"),
              (f"{h}.attention.in_proj_weight", (3 * d, d), "normal"),
              (f"{h}.attention.in_proj_bias", (3 * d,), "zeros"),
              (f"{h}.attention.out_proj.weight", (d, d), "normal"),
              (f"{h}.attention.out_proj.bias", (d,), "zeros"),
              (f"{h}.layernorm.weight", (d,), "ones"), (f"{h}.layernorm.bias", (d,), "zeros"),
              (f"{h}.mlp.fc1.weight", (v.mlp_dim, d), "normal"),
              (f"{h}.mlp.fc1.bias", (v.mlp_dim,), "zeros"),
              (f"{h}.mlp.fc2.weight", (d, v.mlp_dim), "normal"),
              (f"{h}.mlp.fc2.bias", (d,), "zeros")]
    return specs


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), as torch's one
    elementwise kernel (`approximate="tanh"`): written out, the formula's
    eight float32 temporaries of every [rows, 4304] product, kept for the
    backward, took a third of a block's memory and much of its time."""
    return F.gelu(x, approximate="tanh")


def _lin(p, name, x, prec: Precision):
    return prec.linear(x, p[name + ".weight"], p[name + ".bias"])


def _attend(q, k, v, heads: int, prec: Precision) -> torch.Tensor:
    """Bidirectional multi-head attention, q [B, Sq, D] over k, v [B, S, D]."""
    b, sq, d = q.shape
    hd = d // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)

    # The scale on q, not on the [Sq, S] logits: one pass less over them.
    logits = prec.matmul(split(q * hd ** -0.5), split(k).transpose(-1, -2))
    out = prec.matmul(torch.softmax(logits, dim=-1), split(v))
    return out.transpose(1, 2).reshape(b, sq, d)


def _encoder(p, prefix: str, tower, x, prec: Precision) -> torch.Tensor:
    eps = tower.layer_norm_eps
    for i in range(tower.num_layers):
        lp = f"{prefix}.encoder.layers.{i}"
        h = layer_norm(x, p, lp + ".layer_norm1", eps)
        a = _attend(_lin(p, lp + ".self_attn.q_proj", h, prec),
                    _lin(p, lp + ".self_attn.k_proj", h, prec),
                    _lin(p, lp + ".self_attn.v_proj", h, prec), tower.num_heads, prec)
        x = x + _lin(p, lp + ".self_attn.out_proj", a, prec)
        h = layer_norm(x, p, lp + ".layer_norm2", eps)
        x = x + _lin(p, lp + ".mlp.fc2", gelu_tanh(_lin(p, lp + ".mlp.fc1", h, prec)), prec)
    return x


def image_features(p: Mapping[str, torch.Tensor], sh, pixels: torch.Tensor,
                   prec: Precision) -> torch.Tensor:
    """NHWC pixels [B, H, W, 3] -> the pooling head's embedding [B, D]."""
    v = sh.vision
    ps, g = v.patch_size, v.image_size // v.patch_size
    x = pixels[:, :g * ps, :g * ps].float()
    b = x.shape[0]
    patches = x.reshape(b, g, ps, g, ps, 3).permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, -1)
    w = p["vision_model.embeddings.patch_embedding.weight"].reshape(v.hidden_size, -1)
    x = prec.linear(patches, w, p["vision_model.embeddings.patch_embedding.bias"])
    x = x + p["vision_model.embeddings.position_embedding.weight"].float()
    x = _encoder(p, "vision_model", v, x, prec)
    x = layer_norm(x, p, "vision_model.post_layernorm", v.layer_norm_eps)
    h = "vision_model.head"
    d = v.hidden_size
    w, bias = p[f"{h}.attention.in_proj_weight"], p[f"{h}.attention.in_proj_bias"]
    probe = p[f"{h}.probe"].float().expand(b, 1, d)
    y = _attend(prec.linear(probe, w[:d], bias[:d]), prec.linear(x, w[d:2 * d], bias[d:2 * d]),
                prec.linear(x, w[2 * d:], bias[2 * d:]), v.num_heads, prec)
    y = _lin(p, f"{h}.attention.out_proj", y, prec)
    m = layer_norm(y, p, f"{h}.layernorm", v.layer_norm_eps)
    y = y + _lin(p, f"{h}.mlp.fc2", gelu_tanh(_lin(p, f"{h}.mlp.fc1", m, prec)), prec)
    return y[:, 0]


def text_features(p: Mapping[str, torch.Tensor], sh, ids: torch.Tensor,
                  prec: Precision) -> torch.Tensor:
    """[B, S] ids -> the text head's output at the last position [B, D]."""
    t = sh.text
    x = p["text_model.embeddings.token_embedding.weight"].float()[ids.long()] \
        + p["text_model.embeddings.position_embedding.weight"].float()[:ids.shape[1]]
    x = _encoder(p, "text_model", t, x, prec)
    x = layer_norm(x, p, "text_model.final_layer_norm", t.layer_norm_eps)
    return _lin(p, "text_model.head", x[:, -1], prec)


class SiglipReferenceStudent(ReferenceStudent):
    """`reference.step`'s student (the default mask, accumulation, AdamW)
    on the SigLIP towers; the captions' mask is not read."""

    def __init__(self, params, sh, train, prec: Precision):
        super().__init__(params, sh, train, prec, BLOCK if prec.name == "float32" else BLOCK // 2)

    def _embed(self, pixels, ids, mask, rows: slice):
        return (image_features(self.p, self.shapes, pixels[rows], self.prec),
                text_features(self.p, self.shapes, ids[rows], self.prec))


def reference_run(params0: Mapping[str, torch.Tensor], sh, train: Mapping,
                  batches: Sequence[Mapping[str, np.ndarray]],
                  targets: Sequence[Tuple[torch.Tensor, torch.Tensor]], device,
                  prec: Precision, rows: Optional[int] = None) -> dict:
    """`reference.step.reference_run` on the SigLIP towers."""
    student = SiglipReferenceStudent(params0, sh, train, prec)
    losses: List[Dict[str, float]] = []
    grad_norms: Dict[str, float] = {}
    for batch, (t_img, t_txt) in zip(batches, targets):
        parts, grads = student.step(batch, t_img, t_txt, device, rows)
        losses.append(parts)
        if grads is not None and not grad_norms:
            grad_norms = {n: float(g.double().norm()) for n, g in grads.items()}
    change = {n: float((student.p[n].detach().double() - params0[n].double()).norm())
              for n in student.names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
