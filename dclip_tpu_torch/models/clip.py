"""CLIP dual encoder in PyTorch, with HF `CLIPModel` parameter names.

Counterpart of `dclip_tpu/models/clip.py`. Parameters are named as in HF
`CLIPModel`'s state dict (`text_model.encoder.layers.{i}.self_attn.q_proj
.weight`, `vision_model.pre_layrnorm.weight`, ...), so a local
`pytorch_model.bin` loads with `load_state_dict(strict=True)` and the JAX
params come across through `models.weights.state_dict_from_jax`.

Parameters are stored f32; `dtype` is the compute dtype (bf16 on CUDA),
as in the Flax module: activations run in it, LayerNorm statistics and
attention logits / softmax run in f32.

- Text tower: plain torch attention with the causal and key-padding masks
  (additive f32 min, `clip.py:88-123`), EOS pooling with the fall-back to
  the last position when a row holds no EOS id (`clip.py:381-386`).
- Image tower: `get_image_features` runs `kernels.vit_block
  .fused_image_features` over the weights packed once by
  `pack_image_weights` — the hand-written CUDA block kernels for CUDA
  tensors, their plain twins for CPU tensors. The vision modules here hold
  the parameters; the patch embedding is a patch reshape plus a matmul in
  the (ph, pw, c) order of the JAX HWIO kernel, never `F.conv2d`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dclip_tpu.core.config import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
from dclip_tpu_torch.kernels import vit_block
from dclip_tpu_torch.kernels.vit_block import quick_gelu


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """Flax `Dense(dtype=x.dtype)`: f32 params cast to the compute dtype."""
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """Flax `LayerNorm(dtype=x.dtype)`: statistics and affine in f32."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim, device=device)
        self.fc2 = nn.Linear(mlp_dim, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(quick_gelu(_linear(x, self.fc1)), self.fc2)


class Attention(nn.Module):
    """Multi-head self-attention with HF CLIP parameterization."""

    def __init__(self, hidden: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden, device=device)
        self.k_proj = nn.Linear(hidden, hidden, device=device)
        self.v_proj = nn.Linear(hidden, hidden, device=device)
        self.out_proj = nn.Linear(hidden, hidden, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, S, D]; mask: additive f32 [B or 1, 1, S, S] or None."""
        b, s, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2)

        q = split(_linear(x, self.q_proj))
        k = split(_linear(x, self.k_proj))
        v = split(_linear(x, self.v_proj))
        # Logits accumulate and stay in f32 (JAX: preferred_element_type).
        logits = (q * hd**-0.5).float() @ k.float().transpose(-1, -2)
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, s, d)
        return _linear(out, self.out_proj)


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, eps: float, device=None):
        super().__init__()
        self.self_attn = Attention(hidden, heads, device)
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps, device=device)
        self.mlp = MLP(hidden, mlp_dim, device)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=eps, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(_layer_norm(x, self.layer_norm1), mask)
        return x + self.mlp(_layer_norm(x, self.layer_norm2))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, hidden: int, heads: int, mlp_dim: int,
                 eps: float, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(hidden, heads, mlp_dim, eps, device) for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size, device=device)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = CLIPTextEmbeddings(cfg, device)
        self.encoder = Encoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                               cfg.mlp_dim, cfg.layer_norm_eps, device)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                             device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids, attention_mask: [B, S] int. Returns (hidden [B, S, D],
        EOS-pooled [B, D]) in the compute dtype."""
        b, s = input_ids.shape
        emb = self.embeddings
        x = (emb.token_embedding.weight.to(self.dtype)[input_ids]
             + emb.position_embedding.weight[:s].to(self.dtype)[None])
        neg = torch.finfo(torch.float32).min
        mask = torch.triu(torch.full((s, s), neg, device=x.device), diagonal=1)[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg)
            mask = mask + pad
        x = _layer_norm(self.encoder(x, mask), self.final_layer_norm)
        # Pool at the first EOS id; rows without one pool the last position.
        is_eos = (input_ids == self.cfg.eos_token_id).to(torch.int32)
        eos_idx = torch.where(is_eos.sum(-1) > 0, is_eos.argmax(-1),
                              torch.full_like(is_eos[:, 0], s - 1, dtype=torch.int64))
        return x, x[torch.arange(b, device=x.device), eos_idx]


class PatchEmbedding(nn.Module):
    """Holds the HF patch conv weight [D, 3, p, p] (OIHW, bias-free); the
    forward is `vit_block.patchify(pixels) @ W` over the packed weights."""

    def __init__(self, hidden: int, patch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hidden, 3, patch, patch, device=device))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size, device=device))
        self.patch_embedding = PatchEmbedding(cfg.hidden_size, cfg.patch_size, device)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.hidden_size,
                                               device=device)


class CLIPVisionEncoder(nn.Module):
    """The image tower's parameters. Its forward is
    `kernels.vit_block.fused_image_features` (see `CLIPModule
    .get_image_features`), which reads them packed for the kernels."""

    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg, device)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.encoder = Encoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                               cfg.mlp_dim, cfg.layer_norm_eps, device)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                           device=device)


class CLIPModule(nn.Module):
    """Dual-encoder CLIP with projection heads and a logit scale.

    Build with `device="meta"` and `load_state_dict(sd, assign=True)` to
    take a state dict without a throw-away init."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.text_model = CLIPTextEncoder(cfg.text, dtype, device)
        self.vision_model = CLIPVisionEncoder(cfg.vision, device)
        self.text_projection = nn.Linear(cfg.text.hidden_size, cfg.projection_dim,
                                         bias=False, device=device)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size, cfg.projection_dim,
                                           bias=False, device=device)
        self.logit_scale = nn.Parameter(
            torch.full((), cfg.logit_scale_init, device=device))

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        _, pooled = self.text_model(input_ids, attention_mask)
        return _linear(pooled, self.text_projection)

    def pack_image_weights(self) -> dict:
        """The image tower's weights in the block kernels' layouts and the
        compute dtype, on the parameters' device. Pack once and pass the
        result to `get_image_features` when calling it repeatedly."""
        return vit_block.pack_vision_weights(self.cfg, self.state_dict(), self.dtype)

    def get_image_features(self, pixel_values: torch.Tensor,
                           weights: Optional[dict] = None) -> torch.Tensor:
        """pixel_values: NHWC [B, H, W, 3], CLIP-normalized -> [B, P]."""
        if weights is None:
            weights = self.pack_image_weights()
        return vit_block.fused_image_features(self.cfg, weights, pixel_values)
