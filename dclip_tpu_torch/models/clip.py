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
- `remat=True` (both towers) runs each encoder layer under
  `torch.utils.checkpoint` (non-reentrant), JAX's per-layer `nn.remat`
  (`clip.py:279-280`): a layer keeps only its input for the backward,
  which runs its forward again, so every forward kernel of a layer
  launches twice per training step and every backward kernel once. The
  weights K8 / K9 cast for the step are cast once before the layer and
  handed to both forwards (`EncoderLayer.step_packs`).
- `mesh` with a model axis (`parallel.tp`, `model_size > 1`): every
  encoder layer of both towers holds this rank's `heads / mp` heads and
  `mlp_dim / mp` hidden units (q / k / v and fc1 by output rows, out_proj
  and fc2 by input columns) and runs LN1 -> copy -> qkv -> the attention
  core on its heads (K3 / K4 / K5 with `fused_attention`) -> out_proj
  without bias -> the f32 all-reduce -> + bias, and LN2 -> copy -> fc1 +
  quick-GELU -> fc2 without bias -> the f32 all-reduce -> + bias. The
  whole-block kernels (K6, K8, K9) need whole weights and are refused.
  Parameter names are the same; their shapes are the shards'.
On CPU tensors every kernel wrapper runs its plain f32 twin.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dclip_tpu_torch.core.config import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
from dclip_tpu_torch.kernels import (
    attn_block_trainable,
    mlp_frozen,
    mlp_trainable,
    vit_attention,
    vit_block,
)
from dclip_tpu_torch.kernels.vit_block import activation
from dclip_tpu_torch.parallel.tp import (
    clip_divisibility_check,
    copy_to_model,
    model_axis,
    reduce_from_model,
)


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """Flax `Dense(dtype=x.dtype)`: f32 params cast to the compute dtype."""
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """Flax `LayerNorm(dtype=x.dtype)`: statistics and affine in f32."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def _row_sharded(x: torch.Tensor, lin: nn.Linear, mesh) -> torch.Tensor:
    """A row-sharded Linear: the partial product, its f32 sum over the
    model group, the whole bias once; cast to x's dtype."""
    partial = F.linear(x, lin.weight.to(x.dtype))
    return (reduce_from_model(partial, mesh) + lin.bias.float()).to(x.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    causal: bool = False, padding_mask: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention of projected q, k, v [B, S, D] (one dtype) ->
    [B, S, D] in that dtype; masks as in `Attention.forward`. Logits and
    softmax in f32, P V in the input dtype."""
    b, s, d = q.shape
    hd = d // heads
    neg = torch.finfo(torch.float32).min
    mask = None
    if causal:
        mask = torch.triu(torch.full((s, s), neg, device=q.device), diagonal=1)[None, None]
    if padding_mask is not None:
        pad = torch.where(padding_mask[:, None, None, :] > 0, 0.0, neg)
        mask = pad if mask is None else mask + pad
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        seg = torch.where(same, 0.0, neg)
        mask = seg if mask is None else mask + seg

    def split(t):
        return t.reshape(b, s, heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    # Logits accumulate and stay in f32 (JAX: preferred_element_type).
    logits = (q * hd**-0.5).float() @ k.float().transpose(-1, -2)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return (probs @ v).transpose(1, 2).reshape(b, s, d)


class MLP(nn.Module):
    """fc1, the activation (HF's `hidden_act`: quick-GELU, or SigLIP's
    "gelu_pytorch_tanh"), fc2."""

    def __init__(self, hidden: int, mlp_dim: int, device=None, mesh=None,
                 act: str = "quick_gelu"):
        super().__init__()
        self.tp = model_axis(mesh)
        self.act = activation(act)[0]
        local = mlp_dim // (self.tp.model_size if self.tp else 1)
        self.fc1 = nn.Linear(hidden, local, device=device)
        self.fc2 = nn.Linear(local, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            h = self.act(_linear(copy_to_model(x, self.tp), self.fc1))
            return _row_sharded(h, self.fc2, self.tp)
        return _linear(self.act(_linear(x, self.fc1)), self.fc2)


class Attention(nn.Module):
    """Multi-head self-attention with HF CLIP parameterization; under a
    model axis, this rank's `heads` of `heads * mp` (module docstring)."""

    def __init__(self, hidden: int, heads: int, device=None, fused: bool = False,
                 causal: bool = False, mesh=None, residual: bool = False):
        super().__init__()
        self.tp = model_axis(mesh)
        mp = self.tp.model_size if self.tp else 1
        self.heads = heads // mp
        self.fused = fused
        self.causal = causal
        self.residual = residual  # K5's delta from o + o_lo (`kernels.vit_attention`)
        local = hidden // mp
        self.q_proj = nn.Linear(hidden, local, device=device)
        self.k_proj = nn.Linear(hidden, local, device=device)
        self.v_proj = nn.Linear(hidden, local, device=device)
        self.out_proj = nn.Linear(local, hidden, device=device)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, S, D]; padding_mask [B, S] (1 = valid key); segment_ids
        [B, S] int (packed captions: attention within a segment)."""
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
        if self.fused:
            qkv = F.linear(
                x,
                torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]).to(x.dtype),
                torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]).to(x.dtype),
            )
            out = vit_attention.self_attention_qkv(qkv, self.heads, padding_mask,
                                                   self.causal, segment_ids, self.residual)
        else:
            out = plain_attention(_linear(x, self.q_proj), _linear(x, self.k_proj),
                                  _linear(x, self.v_proj), self.heads, self.causal,
                                  padding_mask, segment_ids)
        if self.tp is not None:
            return _row_sharded(out, self.out_proj, self.tp)
        return _linear(out, self.out_proj)


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, eps: float, device=None,
                 fused: bool = False, causal: bool = False, fused_frozen_mlp: bool = False,
                 fused_trainable_mlp: bool = False, fused_trainable_attn_block: bool = False,
                 mesh=None, act: str = "quick_gelu", attn_residual: bool = False):
        super().__init__()
        if model_axis(mesh) is not None and (fused_frozen_mlp or fused_trainable_mlp
                                      or fused_trainable_attn_block):
            raise ValueError("the whole-block kernels (K6, K8, K9) need whole weights: under "
                             "tensor parallelism the layer runs its sharded composition")
        self.act = act
        self.self_attn = Attention(hidden, heads, device, fused, causal, mesh, attn_residual)
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps, device=device)
        self.mlp = MLP(hidden, mlp_dim, device, mesh, act)
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

    def _attn_block_fused(self, padding_mask, segment_ids) -> bool:
        return self.fused_trainable_attn_block and not self.self_attn.causal \
            and padding_mask is None and segment_ids is None

    @torch.no_grad()
    def step_packs(self, x: torch.Tensor, padding_mask=None, segment_ids=None) -> dict:
        """The weights K9 and K8 cast for one call, made once for a layer
        run under remat, so that its second forward does not cast them
        again; empty on the CPU (the twins read the weights as they are)."""
        if x.device.type == "cpu":
            return {}
        packs = {}
        if self._attn_block_fused(padding_mask, segment_ids):
            attn, ln = self.self_attn, self.layer_norm1
            packs["attn"] = attn_block_trainable.pack_trainable_attn(
                ln.weight, ln.bias, attn.q_proj.weight, attn.q_proj.bias, attn.k_proj.weight,
                attn.k_proj.bias, attn.v_proj.weight, attn.v_proj.bias, attn.out_proj.weight,
                attn.out_proj.bias, dtype=x.dtype)
        if self.fused_trainable_mlp:
            ln, mlp = self.layer_norm2, self.mlp
            packs["mlp"] = mlp_trainable.pack_trainable_mlp(
                ln.weight, ln.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias,
                dtype=x.dtype)
        return packs

    def forward(self, x: torch.Tensor, padding_mask=None, segment_ids=None,
                packs: Optional[dict] = None) -> torch.Tensor:
        """`packs`: from `step_packs`, or None to cast the weights here."""
        packs = packs or {}
        attn = self.self_attn
        if self._attn_block_fused(padding_mask, segment_ids):
            ln = self.layer_norm1
            x = attn_block_trainable.attention_block_trainable(
                x, ln.weight, ln.bias, attn.q_proj.weight, attn.q_proj.bias,
                attn.k_proj.weight, attn.k_proj.bias, attn.v_proj.weight, attn.v_proj.bias,
                attn.out_proj.weight, attn.out_proj.bias, attn.heads, ln.eps,
                packed=packs.get("attn"))
        else:
            x = x + attn(_layer_norm(x, self.layer_norm1), padding_mask, segment_ids)
        ln, mlp = self.layer_norm2, self.mlp
        if self.fused_trainable_mlp:
            return mlp_trainable.mlp_block_trainable(
                x, ln.weight, ln.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                mlp.fc2.bias, ln.eps, packed=packs.get("mlp"))
        if self.fused_frozen_mlp:
            if self.frozen_mlp_weights is None:
                raise RuntimeError("fused_frozen_mlp: call pack_frozen_mlp(dtype) first")
            return mlp_frozen.mlp_block_frozen(
                x, ln.weight, ln.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                mlp.fc2.bias, ln.eps, packed=self.frozen_mlp_weights, act=self.act)
        return x + self.mlp(_layer_norm(x, self.layer_norm2))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, hidden: int, heads: int, mlp_dim: int,
                 eps: float, device=None, fused: bool = False, causal: bool = False,
                 fused_frozen_mlp: bool = False, fused_trainable_mlp: bool = False,
                 fused_trainable_attn_block: bool = False, remat: bool = False, mesh=None,
                 act: str = "quick_gelu", attn_residual: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            EncoderLayer(hidden, heads, mlp_dim, eps, device, fused, causal, fused_frozen_mlp,
                         fused_trainable_mlp, fused_trainable_attn_block, mesh, act,
                         attn_residual)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, padding_mask=None, segment_ids=None) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                # The layers draw no random numbers: no RNG state to replay.
                x = checkpoint(layer, x, padding_mask, segment_ids,
                               layer.step_packs(x, padding_mask, segment_ids),
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, padding_mask, segment_ids)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size, device=device)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype = torch.float32, device=None,
                 fused_attention: bool = False, fused_trainable_mlp: bool = False,
                 remat: bool = False, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.fused_attention = fused_attention
        self.embeddings = CLIPTextEmbeddings(cfg, device)
        self.encoder = Encoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                               cfg.mlp_dim, cfg.layer_norm_eps, device,
                               fused=fused_attention, causal=True,
                               fused_trainable_mlp=fused_trainable_mlp, remat=remat, mesh=mesh)
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
    """Holds the HF patch conv weight [D, 3, p, p] (OIHW; CLIP's is
    bias-free, SigLIP's has a bias); the forward is `vit_block.patchify(
    pixels) @ W` over the packed weights."""

    def __init__(self, hidden: int, patch: int, device=None, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hidden, 3, patch, patch, device=device))
        if bias:
            self.bias = nn.Parameter(torch.empty(hidden, device=device))

    def matrix(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight as the [p * p * 3, D] matrix `patchify(x) @ W` takes."""
        return self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0]).to(dtype)


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
                 fused_trainable_attn_block: bool = False, remat: bool = False, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = CLIPVisionEmbeddings(cfg, device)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.encoder = Encoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                               cfg.mlp_dim, cfg.layer_norm_eps, device,
                               fused=fused_attention, fused_frozen_mlp=fused_frozen_mlp,
                               fused_trainable_attn_block=fused_trainable_attn_block,
                               remat=remat, mesh=mesh)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                           device=device)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel_values NHWC [B, H, W, 3] -> (hidden [B, S, D], pooled [B, D])."""
        c, dt = self.cfg, self.dtype
        emb = self.embeddings
        x = vit_block.patchify(pixel_values.to(dt), c.patch_size) @ emb.patch_embedding.matrix(dt)
        cls = emb.class_embedding.to(dt).reshape(1, 1, -1).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight.to(dt)[None]
        x = self.encoder(_layer_norm(x, self.pre_layrnorm))
        return x, _layer_norm(x[:, 0], self.post_layernorm)


class CLIPModule(nn.Module):
    """Dual-encoder CLIP with projection heads and a logit scale.

    Build with `device="meta"` and `load_state_dict(sd, assign=True)` to
    take a state dict without a throw-away init; under a `mesh` with a
    model axis, `parallel.tp.shard_clip_params`'s."""

    packed_text_refusal = None  # packed captions are brought (`get_packed_text_features`)

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32, device=None,
                 fused_attention: bool = False, fused_frozen_mlp: bool = False,
                 fused_trainable_text_mlp: bool = False,
                 fused_trainable_attn_block: bool = False, remat: bool = False, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.mesh = model_axis(mesh)
        if self.mesh is not None:
            clip_divisibility_check(cfg, self.mesh)
        self.text_model = CLIPTextEncoder(cfg.text, dtype, device, fused_attention,
                                          fused_trainable_text_mlp, remat, self.mesh)
        self.vision_model = CLIPVisionEncoder(cfg.vision, device, dtype, fused_attention,
                                              fused_frozen_mlp, fused_trainable_attn_block,
                                              remat, self.mesh)
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
        return vit_block.pack_vision_weights(self.cfg, self.state_dict(), self.dtype, self.mesh)

    def get_image_features(self, pixel_values: torch.Tensor,
                           weights: Optional[dict] = None) -> torch.Tensor:
        """The frozen serving path: pixel_values NHWC [B, H, W, 3],
        CLIP-normalized -> [B, P] through the fused block kernels."""
        if weights is None:
            weights = self.pack_image_weights()
        return vit_block.fused_image_features(self.cfg, weights, pixel_values)
