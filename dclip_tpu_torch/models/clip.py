"""CLIP dual encoder in PyTorch, with HF `CLIPModel` parameter names.

Counterpart of `dclip_tpu/models/clip.py`. Parameters are named as in HF
`CLIPModel`'s state dict (`text_model.encoder.layers.{i}.self_attn.q_proj
.weight`, `vision_model.pre_layrnorm.weight`, ...), so a local
`pytorch_model.bin` loads with `load_state_dict(strict=True)` and the JAX
params come across through `models.weights.state_dict_from_jax`.

Parameters are stored f32; `dtype` is the compute dtype (bf16 on CUDA),
as in the Flax module: activations run in it, LayerNorm statistics and
attention logits / softmax run in f32.

- Text tower: causal attention with the key-padding mask, EOS pooling
  with the fall-back to the last position when a row holds no EOS id
  (`clip.py:381-386`); packed mode (`segment_ids` + `positions`,
  ops/packing.py) with `get_packed_text_features`.
- Image tower, two forwards: `get_image_features` (serving, frozen) runs
  `kernels.vit_block.fused_image_features` over the weights packed once by
  `pack_image_weights`; `image_features` is the differentiable module path
  the trainer uses. The patch embedding is a patch reshape plus a matmul
  in the (ph, pw, c) order of the JAX HWIO kernel, never `F.conv2d`.
- `fused_attention=True` (both towers) runs attention through
  `kernels.vit_attention` (K3/K4/K5, masks in-kernel); otherwise plain
  torch attention with additive f32 masks built from the same causal /
  padding / segment-id arguments (`clip.py:88-123`).
  `fused_frozen_mlp=True` (vision only) runs LN2 + MLP through
  `kernels.mlp_frozen` (K6), valid only while those weights are frozen
  (`pack_frozen_vision_mlp` casts them once).
  `fused_trainable_text_mlp=True` runs the text tower's LN2 + MLP through
  `kernels.mlp_trainable` (K8) and `fused_trainable_attn_block=True` the
  vision tower's LN1 + attention + out_proj + residual through
  `kernels.attn_block_trainable` (K9), both with gradients for every
  weight (`clip.py:466-484`); a layer whose call carries a causal, padding
  or segment mask keeps the per-op attention. Parameter names do not
  change with any flag.
On CPU tensors every kernel wrapper runs its plain f32 twin.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dclip_tpu_torch.core.config import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
from dclip_tpu_torch.kernels import (
    attn_block_trainable,
    mlp_frozen,
    mlp_trainable,
    vit_attention,
    vit_block,
)
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

    def __init__(self, hidden: int, heads: int, device=None, fused: bool = False,
                 causal: bool = False):
        super().__init__()
        self.heads = heads
        self.fused = fused
        self.causal = causal
        self.q_proj = nn.Linear(hidden, hidden, device=device)
        self.k_proj = nn.Linear(hidden, hidden, device=device)
        self.v_proj = nn.Linear(hidden, hidden, device=device)
        self.out_proj = nn.Linear(hidden, hidden, device=device)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, S, D]; padding_mask [B, S] (1 = valid key); segment_ids
        [B, S] int (packed captions: attention within a segment)."""
        b, s, d = x.shape
        if self.fused:
            qkv = F.linear(
                x,
                torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]).to(x.dtype),
                torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]).to(x.dtype),
            )
            out = vit_attention.self_attention_qkv(qkv, self.heads, padding_mask,
                                                   self.causal, segment_ids)
            return _linear(out, self.out_proj)

        hd = d // self.heads
        neg = torch.finfo(torch.float32).min
        mask = None
        if self.causal:
            mask = torch.triu(torch.full((s, s), neg, device=x.device), diagonal=1)[None, None]
        if padding_mask is not None:
            pad = torch.where(padding_mask[:, None, None, :] > 0, 0.0, neg)
            mask = pad if mask is None else mask + pad
        if segment_ids is not None:
            same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
            seg = torch.where(same, 0.0, neg)
            mask = seg if mask is None else mask + seg

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
    def __init__(self, hidden: int, heads: int, mlp_dim: int, eps: float, device=None,
                 fused: bool = False, causal: bool = False, fused_frozen_mlp: bool = False,
                 fused_trainable_mlp: bool = False, fused_trainable_attn_block: bool = False):
        super().__init__()
        self.self_attn = Attention(hidden, heads, device, fused, causal)
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps, device=device)
        self.mlp = MLP(hidden, mlp_dim, device)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=eps, device=device)
        self.fused_frozen_mlp = fused_frozen_mlp
        self.fused_trainable_mlp = fused_trainable_mlp
        self.fused_trainable_attn_block = fused_trainable_attn_block
        self.frozen_mlp_weights: Optional[dict] = None  # set by pack_frozen_mlp

    def pack_frozen_mlp(self, dtype: torch.dtype) -> None:
        """Cast LN2 + MLP once into `kernels.mlp_frozen`'s operands."""
        ln, mlp = self.layer_norm2, self.mlp
        self.frozen_mlp_weights = mlp_frozen.pack_frozen_mlp(
            ln.weight, ln.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias,
            dtype)

    def forward(self, x: torch.Tensor, padding_mask=None, segment_ids=None) -> torch.Tensor:
        attn = self.self_attn
        if self.fused_trainable_attn_block and not attn.causal and padding_mask is None \
                and segment_ids is None:
            ln = self.layer_norm1
            x = attn_block_trainable.attention_block_trainable(
                x, ln.weight, ln.bias, attn.q_proj.weight, attn.q_proj.bias,
                attn.k_proj.weight, attn.k_proj.bias, attn.v_proj.weight, attn.v_proj.bias,
                attn.out_proj.weight, attn.out_proj.bias, attn.heads, ln.eps)
        else:
            x = x + attn(_layer_norm(x, self.layer_norm1), padding_mask, segment_ids)
        ln, mlp = self.layer_norm2, self.mlp
        if self.fused_trainable_mlp:
            return mlp_trainable.mlp_block_trainable(
                x, ln.weight, ln.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                mlp.fc2.bias, ln.eps)
        if self.fused_frozen_mlp:
            if self.frozen_mlp_weights is None:
                raise RuntimeError("fused_frozen_mlp: call pack_frozen_mlp(dtype) first")
            return mlp_frozen.mlp_block_frozen(
                x, ln.weight, ln.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                mlp.fc2.bias, ln.eps, packed=self.frozen_mlp_weights)
        return x + self.mlp(_layer_norm(x, self.layer_norm2))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, hidden: int, heads: int, mlp_dim: int,
                 eps: float, device=None, fused: bool = False, causal: bool = False,
                 fused_frozen_mlp: bool = False, fused_trainable_mlp: bool = False,
                 fused_trainable_attn_block: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(hidden, heads, mlp_dim, eps, device, fused, causal, fused_frozen_mlp,
                         fused_trainable_mlp, fused_trainable_attn_block)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, padding_mask=None, segment_ids=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, padding_mask, segment_ids)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size, device=device)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype = torch.float32, device=None,
                 fused_attention: bool = False, fused_trainable_mlp: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.fused_attention = fused_attention
        self.embeddings = CLIPTextEmbeddings(cfg, device)
        self.encoder = Encoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                               cfg.mlp_dim, cfg.layer_norm_eps, device,
                               fused=fused_attention, causal=True,
                               fused_trainable_mlp=fused_trainable_mlp)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                             device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids, attention_mask: [B, S] int. Returns (hidden [B, S, D],
        EOS-pooled [B, D]) in the compute dtype.

        Packed mode (`segment_ids` + `positions`, ops/packing.py): several
        captions share a row, attention is within-segment causal, position
        embeddings index per-caption positions, and pooling is the
        caller's job: the returned `pooled` is the row head."""
        b, s = input_ids.shape
        emb = self.embeddings
        tok = emb.token_embedding.weight.to(self.dtype)[input_ids.long()]
        pos = emb.position_embedding.weight.to(self.dtype)
        if segment_ids is not None:
            x = tok + pos[positions.long()]
            attention_mask = None  # the segment ids mask padding (segment 0)
        else:
            x = tok + pos[:s][None]
        x = self.encoder(x, attention_mask, segment_ids)
        x = _layer_norm(x, self.final_layer_norm)
        if segment_ids is not None:
            return x, x[:, 0]
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
    """The image tower. Its module forward (`forward`, differentiable) runs
    the encoder layers; the serving path instead reads the parameters
    packed for `kernels.vit_block.fused_image_features`."""

    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, fused_frozen_mlp: bool = False,
                 fused_trainable_attn_block: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = CLIPVisionEmbeddings(cfg, device)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.encoder = Encoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                               cfg.mlp_dim, cfg.layer_norm_eps, device,
                               fused=fused_attention, fused_frozen_mlp=fused_frozen_mlp,
                               fused_trainable_attn_block=fused_trainable_attn_block)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                           device=device)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel_values NHWC [B, H, W, 3] -> (hidden [B, S, D], pooled [B, D])."""
        c, dt = self.cfg, self.dtype
        emb = self.embeddings
        patch_w = emb.patch_embedding.weight.permute(2, 3, 1, 0).reshape(-1, c.hidden_size)
        x = vit_block.patchify(pixel_values.to(dt), c.patch_size) @ patch_w.to(dt)
        cls = emb.class_embedding.to(dt).reshape(1, 1, -1).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight.to(dt)[None]
        x = self.encoder(_layer_norm(x, self.pre_layrnorm))
        return x, _layer_norm(x[:, 0], self.post_layernorm)


class CLIPModule(nn.Module):
    """Dual-encoder CLIP with projection heads and a logit scale.

    Build with `device="meta"` and `load_state_dict(sd, assign=True)` to
    take a state dict without a throw-away init."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32, device=None,
                 fused_attention: bool = False, fused_frozen_mlp: bool = False,
                 fused_trainable_text_mlp: bool = False,
                 fused_trainable_attn_block: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.text_model = CLIPTextEncoder(cfg.text, dtype, device, fused_attention,
                                          fused_trainable_text_mlp)
        self.vision_model = CLIPVisionEncoder(cfg.vision, device, dtype, fused_attention,
                                              fused_frozen_mlp, fused_trainable_attn_block)
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

    def get_token_features(self, input_ids: torch.Tensor,
                           attention_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token-level text features: `text_projection` of every final-LN'd
        token [B, S, P], and of the pooled token [B, P] (`clip.py:517-521`)."""
        hidden, pooled = self.text_model(input_ids, attention_mask)
        return _linear(hidden, self.text_projection), _linear(pooled, self.text_projection)

    def get_patch_features(self, pixel_values: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`visual_projection` of every patch state (before the post-LN)
        [B, S, P], and of the pooled CLS state [B, P] (`clip.py:527-530`)."""
        hidden, pooled = self.vision_model(pixel_values)
        return _linear(hidden, self.visual_projection), _linear(pooled, self.visual_projection)

    def get_packed_text_features(self, packed_ids, packed_segments, packed_positions,
                                 packed_eos_rows, packed_eos_cols) -> torch.Tensor:
        """get_text_features over a packed batch (ops.packing.pack_captions):
        encode R dense rows, then gather each caption's EOS state, in the
        original caption order."""
        hidden, _ = self.text_model(packed_ids, None, segment_ids=packed_segments,
                                    positions=packed_positions)
        pooled = hidden[packed_eos_rows.long(), packed_eos_cols.long()]
        return _linear(pooled, self.text_projection)

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The differentiable image tower (module forward): NHWC -> [B, P]."""
        _, pooled = self.vision_model(pixel_values)
        return _linear(pooled, self.visual_projection)

    def pack_frozen_vision_mlp(self) -> None:
        """Cast every vision layer's LN2 + MLP once for `fused_frozen_mlp`."""
        for layer in self.vision_model.encoder.layers:
            layer.pack_frozen_mlp(self.dtype)

    def pack_image_weights(self) -> dict:
        """The image tower's weights in the block kernels' layouts and the
        compute dtype, on the parameters' device. Pack once and pass the
        result to `get_image_features` when calling it repeatedly."""
        return vit_block.pack_vision_weights(self.cfg, self.state_dict(), self.dtype)

    def get_image_features(self, pixel_values: torch.Tensor,
                           weights: Optional[dict] = None) -> torch.Tensor:
        """The frozen serving path: pixel_values NHWC [B, H, W, 3],
        CLIP-normalized -> [B, P] through the fused block kernels."""
        if weights is None:
            weights = self.pack_image_weights()
        return vit_block.fused_image_features(self.cfg, weights, pixel_values)
