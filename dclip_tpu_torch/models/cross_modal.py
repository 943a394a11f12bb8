"""Bidirectional cross-modal attention, the meta-teacher's core block
(counterpart of `dclip_tpu/models/cross_modal.py`):

    attended_text  = LN(text  + MHA(q=text,  kv=image))
    attended_image = LN(image + MHA(q=image, kv=text))

The parameters are named as torch `nn.MultiheadAttention` names them, as
the reference teacher's `CrossModalAttention` does
(`text_to_image.in_proj_weight` [3D, D], `in_proj_bias`,
`out_proj.weight` / `bias`, `norm_text.weight` / `bias`, ...), so a
reference `cross_modal_attention.*` state dict loads as is. Unlike
`nn.MultiheadAttention`, a masked key takes finfo(f32).min instead of
-inf: a row whose every key is masked averages its values, as the Flax
module does, instead of turning NaN.

This is the differentiable module and the plain reference of the fused
kernel (`kernels.cross_attention`, K10).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_NEG = torch.finfo(torch.float32).min


class MultiheadCrossAttention(nn.Module):
    """One direction: queries from one stream, keys and values from the
    other; the Flax module's numerics (biased q/k/v/out projections,
    q scaled by head_dim**-0.5, f32 logits and softmax)."""

    def __init__(self, embed_dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim, device=device))
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query [B, Q, D], key_value [B, K, D], key_padding_mask [B, K]
        (1 = valid key) -> [B, Q, D] in the query's dtype."""
        d = query.shape[-1]
        hd = d // self.num_heads
        w = self.in_proj_weight.to(query.dtype)
        bias = self.in_proj_bias.to(query.dtype)
        q = F.linear(query, w[:d], bias[:d])
        k = F.linear(key_value, w[d:2 * d], bias[d:2 * d])
        v = F.linear(key_value, w[2 * d:], bias[2 * d:])

        def split(t):
            b, s, _ = t.shape
            return t.reshape(b, s, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        logits = (q * hd**-0.5).float() @ k.float().transpose(-1, -2)
        if key_padding_mask is not None:
            keep = key_padding_mask[:, None, None, :] > 0
            logits = torch.where(keep, logits, torch.full_like(logits, _NEG))
        probs = torch.softmax(logits, dim=-1).to(query.dtype)
        b, h, s, _ = q.shape
        out = (probs @ v).transpose(1, 2).reshape(b, s, h * hd)
        return F.linear(out, self.out_proj.weight.to(out.dtype), self.out_proj.bias.to(out.dtype))


class CrossModalAttention(nn.Module):
    """Both directions, each with its residual and LayerNorm (eps 1e-5,
    torch's default; the Flax module sets it to match)."""

    def __init__(self, embed_dim: int = 512, num_heads: int = 8, device=None):
        super().__init__()
        self.text_to_image = MultiheadCrossAttention(embed_dim, num_heads, device)
        self.image_to_text = MultiheadCrossAttention(embed_dim, num_heads, device)
        self.norm_text = nn.LayerNorm(embed_dim, eps=1e-5, device=device)
        self.norm_image = nn.LayerNorm(embed_dim, eps=1e-5, device=device)

    @staticmethod
    def _norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                            ln.eps).to(x.dtype)

    def forward(self, text: torch.Tensor, image: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None,
                image_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """text [B, T, D], image [B, P, D]; masks [B, T] / [B, P], 1 = valid.
        Returns (attended_text, attended_image)."""
        t2i = self.text_to_image(text, image, image_mask)
        attended_text = self._norm(text + t2i, self.norm_text)
        i2t = self.image_to_text(image, text, text_mask)
        attended_image = self._norm(image + i2t, self.norm_image)
        return attended_text, attended_image
