"""A plain float32 SigLIP so400m-style dual encoder and DCLIP's student
objective: the reference the port's SigLIP student is held to on the CPU.

Written from HF `SiglipModel` (`modeling_siglip.py`) and the published
config, over a state dict with HF's parameter names, in plain `torch`
functions: no kernel of the port, no module of it and no JAX. TF32 is off
for the products (`tf32_off`), which matters only on a card.

- Image tower: the stride-p patch convolution with its bias over the first
  (H // p) p pixels of each side, learned positions, no class token and no
  pre-LayerNorm; pre-norm encoder layers (bidirectional multi-head
  attention at scale head_dim^-0.5, tanh-GELU MLP); the post-LayerNorm of
  every token; the attention-pooling head (one probe through torch's
  packed `in_proj`, `out_proj`, then y = h + MLP(LN(h)), row 0).
- Text tower: token and position embeddings, the same layers without a
  mask (SigLIP's processor gives none), the final LayerNorm, the last
  position through the linear head.
- DCLIP's objective in place of SigLIP's sigmoid loss: mean (1 - cos) of
  each tower against its teacher target, plus the weighted symmetric
  InfoNCE between the towers; `logit_scale` / `logit_bias` unused.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def _lin(x, p, name):
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def _attend(q, k, v, heads, mask=None):
    """q [B, Sq, D], k, v [B, S, D] -> [B, Sq, D]; mask [B, S] 1 = key kept."""
    b, sq, d = q.shape
    hd = d // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)

    logits = split(q) @ split(k).transpose(-1, -2) * hd ** -0.5
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    return (logits.softmax(-1) @ split(v)).transpose(1, 2).reshape(b, sq, d)


def encoder(x, p, prefix, layers, heads, eps, mask=None):
    for i in range(layers):
        lp = f"{prefix}.encoder.layers.{i}"
        h = _ln(x, p, lp + ".layer_norm1", eps)
        a = _attend(_lin(h, p, lp + ".self_attn.q_proj"), _lin(h, p, lp + ".self_attn.k_proj"),
                    _lin(h, p, lp + ".self_attn.v_proj"), heads, mask)
        x = x + _lin(a, p, lp + ".self_attn.out_proj")
        h = _ln(x, p, lp + ".layer_norm2", eps)
        x = x + _lin(gelu_tanh(_lin(h, p, lp + ".mlp.fc1")), p, lp + ".mlp.fc2")
    return x


def image_features(p: Mapping[str, torch.Tensor], cfg, pixels: torch.Tensor) -> torch.Tensor:
    """NHWC pixels -> the pooling head's embedding [B, D], f32."""
    v = cfg.vision
    conv = F.conv2d(pixels.float().permute(0, 3, 1, 2),
                    p["vision_model.embeddings.patch_embedding.weight"],
                    p["vision_model.embeddings.patch_embedding.bias"], stride=v.patch_size)
    x = conv.flatten(2).transpose(1, 2) + p["vision_model.embeddings.position_embedding.weight"]
    x = encoder(x, p, "vision_model", v.num_layers, v.num_heads, v.layer_norm_eps)
    x = _ln(x, p, "vision_model.post_layernorm", v.layer_norm_eps)
    hp = "vision_model.head"
    d = x.shape[-1]
    w, bias = p[hp + ".attention.in_proj_weight"], p[hp + ".attention.in_proj_bias"]
    probe = p[hp + ".probe"].expand(x.shape[0], 1, d)
    h = _attend(probe @ w[:d].t() + bias[:d], x @ w[d:2 * d].t() + bias[d:2 * d],
                x @ w[2 * d:].t() + bias[2 * d:], v.num_heads)
    h = _lin(h, p, hp + ".attention.out_proj")
    m = _ln(h, p, hp + ".layernorm", v.layer_norm_eps)
    h = h + _lin(gelu_tanh(_lin(m, p, hp + ".mlp.fc1")), p, hp + ".mlp.fc2")
    return h[:, 0]


def text_features(p: Mapping[str, torch.Tensor], cfg, ids: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] ids -> the text head's output at the last position [B, D], f32."""
    t = cfg.text
    x = p["text_model.embeddings.token_embedding.weight"][ids.long()] \
        + p["text_model.embeddings.position_embedding.weight"][:ids.shape[1]]
    x = encoder(x, p, "text_model", t.num_layers, t.num_heads, t.layer_norm_eps, mask)
    x = _ln(x, p, "text_model.final_layer_norm", t.layer_norm_eps)
    return _lin(x[:, -1], p, "text_model.head")


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def dclip_loss(img, txt, t_img, t_txt, temperature: float = 0.05,
               weight: float = 1.0) -> Dict[str, torch.Tensor]:
    image = (1.0 - (_unit(img) * _unit(t_img)).sum(-1)).mean()
    text = (1.0 - (_unit(txt) * _unit(t_txt)).sum(-1)).mean()
    logits = _unit(img) @ _unit(txt).t() / temperature
    labels = torch.arange(logits.shape[0])
    con = (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2.0
    return {"image_distill_loss": image, "text_distill_loss": text, "contrastive_loss": con,
            "loss": image + text + weight * con}


def trainable(name: str) -> bool:
    """The default distillation mask: image-tower leaves named *proj*."""
    return ("proj" in name) if name.startswith("vision_model.") else True


def loss_and_grads(sd: Mapping[str, torch.Tensor], cfg, pixels, ids, t_img, t_txt,
                   temperature: float = 0.05, weight: float = 1.0):
    """(loss parts, {trainable leaf: gradient}) of one batch, f32."""
    with tf32_off():
        p = {n: t.detach().float().clone().requires_grad_(trainable(n)) for n, t in sd.items()}
        parts = dclip_loss(image_features(p, cfg, pixels), text_features(p, cfg, ids),
                           t_img.float(), t_txt.float(), temperature, weight)
        names = [n for n in p if trainable(n)]
        grads = torch.autograd.grad(parts["loss"], [p[n] for n in names], allow_unused=True)
    return ({k: v.detach() for k, v in parts.items()},
            {n: torch.zeros_like(p[n]) if g is None else g for n, g in zip(names, grads)})
