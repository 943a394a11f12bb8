"""SigLIP dual encoder in PyTorch, with HF `SiglipModel` parameter names.

The DCLIP student of `core.config.CLIPConfig.siglip_so400m_14_384`
(google/siglip-so400m-patch14-384). It reuses `models.clip`'s encoder
layers (the same `self_attn.{q,k,v,out}_proj`, `layer_norm1/2`,
`mlp.fc1/2` names, the same kernels) with SigLIP's tanh-GELU and its
equations around them (HF `modeling_siglip.py`):

- Image tower: a stride-p patch convolution with a bias over the first
  (H / p) p pixels of each side (27 x 14 = 378 of 384: 729 tokens), plus
  a learned position embedding; no class token and no pre-LayerNorm; the
  encoder; a post-LayerNorm over every token; then the multihead
  attention-pooling head: one learned probe attends to the tokens
  (`head.attention`, torch `nn.MultiheadAttention`'s packed `in_proj` and
  `out_proj`), then `y = h + MLP(LN(h))`, and the image embedding is
  `y[:, 0]`, hidden_size wide. The head is one query against the tokens,
  under 0.1% of a step: it runs as plain tensor ops under the
  `dclip.map_head` range.
- Text tower: token and position embeddings, a bidirectional encoder, the
  final LayerNorm, then the last position through the linear `head`.
  SigLIP's processor pads captions to 64 with the pad id and gives no
  mask, so `get_text_features` attends over every position and reads no
  mask (`text_model` takes one, as HF's key-padding mask). Packing would
  change what the pooled last position sees: `packed_text_refusal` says
  so to `train.DistillTrainer`.
- There is no projection: the towers' pooled outputs are the features,
  `cfg.projection_dim` wide. `logit_scale` and `logit_bias` are held under
  their HF names (shape [1]); DCLIP's loss (cosine distillation and
  InfoNCE) reads neither, in place of SigLIP's sigmoid loss.

Compute as in `models.clip`: parameters f32, activations in `dtype`,
LayerNorm statistics and attention softmax in f32. The attention kernels
keep o's rounding residual for the backward's delta (`attn_residual`,
`kernels.vit_attention`): without it the text tower's q / k gradients
stray ~10x further from the float32 reference. `fused_attention`,
`fused_frozen_mlp` and `remat` as there; the fused trainable blocks (K8,
K9), packed captions, the serving path and tensor parallelism are not
brought for SigLIP and raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from dclip_tpu_torch.core.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    model_family,
)
from dclip_tpu_torch.kernels import vit_block
from dclip_tpu_torch.models.clip import (
    MLP,
    CLIPTextEmbeddings,
    Encoder,
    PatchEmbedding,
    _layer_norm,
    _linear,
)
from dclip_tpu_torch.parallel.tp import model_axis


ACT = "gelu_pytorch_tanh"  # HF's name for SigLIP's MLP activation


def _refuse(what: str):
    raise ValueError(f"{what} is not brought for SigLIP")


class SiglipTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype = torch.float32, device=None,
                 fused_attention: bool = False, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = CLIPTextEmbeddings(cfg, device)
        self.encoder = Encoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.mlp_dim,
                               cfg.layer_norm_eps, device, fused=fused_attention,
                               remat=remat, act=ACT, attn_residual=True)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                             device=device)
        self.head = nn.Linear(cfg.hidden_size, cfg.hidden_size, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids [B, S] -> (final-LN'd hidden [B, S, D], head(last position)
        [B, D]) in the compute dtype; `attention_mask` [B, S] (1 = valid
        key) or None (SigLIP's processor gives none)."""
        emb = self.embeddings
        s = input_ids.shape[1]
        # Rows gathered from the f32 tables, then cast: the backward then sums
        # a row's gradient in f32. Every caption attends to and pools at its
        # pad ids, so the pad row gathers ~40 gradients a caption, which a
        # gather from a bf16 copy would add up in bf16.
        x = emb.token_embedding.weight[input_ids.long()].to(self.dtype) \
            + emb.position_embedding.weight[:s].to(self.dtype)[None]
        x = self.encoder(x, attention_mask)
        x = _layer_norm(x, self.final_layer_norm)
        return x, _linear(x[:, -1], self.head)


class SiglipVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.patch_embedding = PatchEmbedding(cfg.hidden_size, cfg.patch_size, device, bias=True)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.hidden_size, device=device)


class SiglipMultiheadAttentionPoolingHead(nn.Module):
    """One learned probe attends to the tokens; then y = h + MLP(LN(h))."""

    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.probe = nn.Parameter(torch.empty(1, 1, cfg.hidden_size, device=device))
        self.attention = nn.MultiheadAttention(cfg.hidden_size, cfg.num_heads, batch_first=True,
                                               device=device)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.mlp = MLP(cfg.hidden_size, cfg.mlp_dim, device, act=ACT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, D] (post-LN tokens) -> [B, D] in x's dtype."""
        b, s, d = x.shape
        heads, hd = self.num_heads, d // self.num_heads
        attn = self.attention
        w, bias = attn.in_proj_weight.to(x.dtype), attn.in_proj_bias.to(x.dtype)
        q = F.linear(self.probe.to(x.dtype), w[:d], bias[:d])             # [1, 1, D]
        kv = F.linear(x, w[d:], bias[d:])                                 # [B, S, 2D]
        k = kv[..., :d].reshape(b, s, heads, hd).transpose(1, 2)
        v = kv[..., d:].reshape(b, s, heads, hd).transpose(1, 2)
        q = (q * hd**-0.5).reshape(1, 1, heads, hd).transpose(1, 2)
        # Logits and softmax in f32, P V in the compute dtype.
        probs = torch.softmax(q.float() @ k.float().transpose(-1, -2), dim=-1).to(v.dtype)
        h = (probs @ v).transpose(1, 2).reshape(b, 1, d)
        h = _linear(h, attn.out_proj)
        h = h + self.mlp(_layer_norm(h, self.layernorm))
        return h[:, 0]


class SiglipVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, fused_frozen_mlp: bool = False,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = SiglipVisionEmbeddings(cfg, device)
        self.encoder = Encoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.mlp_dim,
                               cfg.layer_norm_eps, device, fused=fused_attention,
                               fused_frozen_mlp=fused_frozen_mlp, remat=remat, act=ACT,
                               attn_residual=True)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                           device=device)
        self.head = SiglipMultiheadAttentionPoolingHead(cfg, device)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel_values NHWC [B, H, W, 3] -> (post-LN tokens [B, S, D], the
        pooling head's embedding [B, D]). The patches cover the first
        (H // p) * p rows and columns, as the stride-p VALID convolution."""
        c, dt = self.cfg, self.dtype
        emb = self.embeddings
        side = (c.image_size // c.patch_size) * c.patch_size
        pixels = pixel_values[:, :side, :side].to(dt)
        x = vit_block.patchify(pixels, c.patch_size) @ emb.patch_embedding.matrix(dt)
        x = x + emb.patch_embedding.bias.to(dt) + emb.position_embedding.weight.to(dt)[None]
        x = _layer_norm(self.encoder(x), self.post_layernorm)
        with record_function("dclip.map_head"):
            pooled = self.head(x)
        return x, pooled


class SiglipModule(nn.Module):
    """SigLIP's two towers with the interface `train.DistillTrainer` calls
    on a student (`image_features`, `get_text_features`,
    `pack_frozen_vision_mlp`). Build with `device="meta"` and
    `load_state_dict(sd, assign=True)`, as `CLIPModule`."""

    packed_text_refusal = ("packed text with a bidirectional text tower is not brought: "
                           "packing changes what the pooled last position sees; set "
                           "packed_text=False")

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32, device=None,
                 fused_attention: bool = False, fused_frozen_mlp: bool = False,
                 fused_trainable_text_mlp: bool = False,
                 fused_trainable_attn_block: bool = False, remat: bool = False, mesh=None):
        super().__init__()
        if model_family(cfg) != "siglip":
            raise ValueError(
                f"SiglipModule takes a SigLIP config, got family {model_family(cfg)!r}")
        if fused_trainable_text_mlp or fused_trainable_attn_block:
            _refuse("the fused trainable blocks (K8, K9)")
        if model_axis(mesh) is not None:
            _refuse("tensor parallelism")
        self.cfg = cfg
        self.dtype = dtype
        self.text_model = SiglipTextTransformer(cfg.text, dtype, device, fused_attention, remat)
        self.vision_model = SiglipVisionTransformer(cfg.vision, device, dtype, fused_attention,
                                                    fused_frozen_mlp, remat)
        self.logit_scale = nn.Parameter(torch.full((1,), cfg.logit_scale_init, device=device))
        self.logit_bias = nn.Parameter(torch.full((1,), -10.0, device=device))

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, S] ids -> the text head's output [B, D]. The captions run
        unmasked, as SigLIP's processor gives them: `attention_mask` is not
        read."""
        return self.text_model(input_ids)[1]

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NHWC pixels -> the pooling head's embedding [B, D]."""
        return self.vision_model(pixel_values)[1]

    def get_packed_text_features(self, *args, **kwargs):
        raise ValueError(self.packed_text_refusal)

    def get_image_features(self, *args, **kwargs):
        _refuse("the serving path (K1 / K2 through the pooling head)")

    def pack_frozen_vision_mlp(self) -> None:
        """Cast every vision layer's LN2 + MLP once for `fused_frozen_mlp`."""
        for layer in self.vision_model.encoder.layers:
            layer.pack_frozen_mlp(self.dtype)


def dual_encoder_class(cfg: CLIPConfig):
    """`CLIPModule` or `SiglipModule`, by the config's family."""
    from dclip_tpu_torch.models.clip import CLIPModule

    table = {"clip": CLIPModule, "siglip": SiglipModule}
    family = model_family(cfg)
    if family not in table:
        raise ValueError(f"unknown model family {family!r}; have {sorted(table)}")
    return table[family]
