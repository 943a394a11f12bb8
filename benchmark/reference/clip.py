"""The plain CLIP towers: the benchmark's reference of the student and of
the teacher's CLIP.

Written from the published architecture (OpenAI CLIP as HF `CLIPModel`
computes it, with HF's parameter names) in plain PyTorch, with no kernel,
cache, packing or batching of the program. It imports nothing of the
program and takes its weights from `benchmark.weights`.

- Image tower: a stride-p patch convolution (bias-free), the class token,
  learned positions, pre-LayerNorm, pre-norm encoder layers (multi-head
  self-attention, quick-GELU MLP), post-LayerNorm of the class token and
  the visual projection.
- Text tower: token and position embeddings, the same layers under a
  causal mask and a key-padding mask, the final LayerNorm, the state at
  the first EOS id (the last position when a row holds none) and the text
  projection.

Every product goes through a `Precision`: `Precision("float32")` is the
reference (float32 with TF32 off: the caller turns TF32 off on the card);
`Precision("float8")` is the control, which rounds both operands of every
matrix product to float8 e4m3 with a per-tensor scale (amax to 448), the
step below the bfloat16 the configurations state. LayerNorm, softmax and
every sum stay in float32 in both. The rounding passes the gradient
straight through.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

_NEG = torch.finfo(torch.float32).min
_E4M3_MAX = 448.0


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().clamp(min=1e-30)
        scale = _E4M3_MAX / amax
        return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """Where the reference rounds: `float32` nowhere, `float8` the operands
    of every matrix product."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"precision must be float32 or float8, got {name!r}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return _RoundFp8.apply(t) if self.name == "float8" else t

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.operand(a), self.operand(b))

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x @ w.T + b, w [out, in]."""
        y = torch.matmul(self.operand(x), self.operand(w).t())
        return y if b is None else y + b.float()


def layer_norm(x: torch.Tensor, p: Mapping[str, torch.Tensor], prefix: str,
               eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p[prefix + ".weight"].float(),
                        p[prefix + ".bias"].float(), eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def attention(x: torch.Tensor, p: Mapping[str, torch.Tensor], prefix: str, heads: int,
              allowed: Optional[torch.Tensor], prec: Precision) -> torch.Tensor:
    """Multi-head self-attention; allowed [B, S, S] bool (query, key) or None."""
    b, s, d = x.shape
    hd = d // heads

    def proj(name):
        return prec.linear(x, p[f"{prefix}.{name}.weight"], p[f"{prefix}.{name}.bias"])

    def split(t):
        return t.reshape(b, s, heads, hd).transpose(1, 2)

    q, k, v = split(proj("q_proj")), split(proj("k_proj")), split(proj("v_proj"))
    logits = prec.matmul(q * hd ** -0.5, k.transpose(-1, -2))
    if allowed is not None:
        logits = logits.masked_fill(~allowed[:, None], _NEG)
    probs = torch.softmax(logits, dim=-1)
    out = prec.matmul(probs, v).transpose(1, 2).reshape(b, s, d)
    return prec.linear(out, p[f"{prefix}.out_proj.weight"], p[f"{prefix}.out_proj.bias"])


def encoder(x: torch.Tensor, p: Mapping[str, torch.Tensor], prefix: str, tower,
            allowed: Optional[torch.Tensor], prec: Precision) -> torch.Tensor:
    eps = tower.layer_norm_eps
    for i in range(tower.num_layers):
        lp = f"{prefix}.encoder.layers.{i}"
        x = x + attention(layer_norm(x, p, f"{lp}.layer_norm1", eps), p, f"{lp}.self_attn",
                          tower.num_heads, allowed, prec)
        h = layer_norm(x, p, f"{lp}.layer_norm2", eps)
        h = quick_gelu(prec.linear(h, p[f"{lp}.mlp.fc1.weight"], p[f"{lp}.mlp.fc1.bias"]))
        x = x + prec.linear(h, p[f"{lp}.mlp.fc2.weight"], p[f"{lp}.mlp.fc2.bias"])
    return x


def image_features(p: Mapping[str, torch.Tensor], shapes, pixels: torch.Tensor,
                   prec: Precision) -> torch.Tensor:
    """pixels NHWC [B, H, W, 3] (CLIP-normalized) -> [B, projection_dim]."""
    v = shapes.vision
    b, h, w, c = pixels.shape
    ps = v.patch_size
    # The stride-p convolution as a product over (row, column, channel)
    # patches; the HF kernel is [D, C, p, p].
    patches = pixels.float().reshape(b, h // ps, ps, w // ps, ps, c)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // ps) * (w // ps), ps * ps * c)
    kernel = p["vision_model.embeddings.patch_embedding.weight"].permute(0, 2, 3, 1)
    x = prec.linear(patches, kernel.reshape(v.hidden_size, -1))
    cls = p["vision_model.embeddings.class_embedding"].float().expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + p["vision_model.embeddings.position_embedding.weight"]
    x = layer_norm(x, p, "vision_model.pre_layrnorm", v.layer_norm_eps)
    x = encoder(x, p, "vision_model", v, None, prec)
    pooled = layer_norm(x[:, 0], p, "vision_model.post_layernorm", v.layer_norm_eps)
    return prec.linear(pooled, p["visual_projection.weight"])


def text_states(p: Mapping[str, torch.Tensor], shapes, ids: torch.Tensor,
                mask: torch.Tensor, prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids, mask [B, S] -> (final-LN'd states [B, S, D], index of the
    pooled position [B])."""
    t = shapes.text
    b, s = ids.shape
    x = p["text_model.embeddings.token_embedding.weight"][ids.long()].float()
    x = x + p["text_model.embeddings.position_embedding.weight"][:s]
    causal = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
    allowed = causal[None] & (mask[:, None, :] > 0)
    x = encoder(x, p, "text_model", t, allowed, prec)
    x = layer_norm(x, p, "text_model.final_layer_norm", t.layer_norm_eps)
    is_eos = ids == t.eos_token_id
    first = torch.where(is_eos.any(-1), is_eos.int().argmax(-1),
                        torch.full_like(ids[:, 0], s - 1, dtype=torch.long))
    return x, first


def text_features(p: Mapping[str, torch.Tensor], shapes, ids: torch.Tensor,
                  mask: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ids, mask [B, S] -> [B, projection_dim]: the EOS state, projected."""
    x, first = text_states(p, shapes, ids, mask, prec)
    pooled = x[torch.arange(ids.shape[0], device=ids.device), first]
    return prec.linear(pooled, p["text_projection.weight"])


def token_features(p: Mapping[str, torch.Tensor], shapes, ids: torch.Tensor,
                   mask: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Every token's final-LN'd state, projected: [B, S, projection_dim]."""
    x, _ = text_states(p, shapes, ids, mask, prec)
    return prec.linear(x, p["text_projection.weight"])
