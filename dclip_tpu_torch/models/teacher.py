"""The meta-teacher, PatchTextAggregation (counterpart of
`dclip_tpu/models/teacher.py:47-256`). Its forward is three fixed-shape
stages:

  1. `encode_patches`: every region crop of the batch (B x P boxes) ->
     one crop-resize-normalize (`ops.image_ops`) -> one batched forward of
     the frozen teacher ViT (on CUDA the block kernels K1 / K2 through
     `kernels.vit_block.fused_image_features`) -> [B, P, D], invalid slots
     zeroed. `encode_patches_compact` encodes only a budget of slots,
     valid ones first.
  2. `encode_tokens`: `text_projection` of every token of the teacher text
     tower (K3 with causal + key-padding masks on CUDA), keeping content
     tokens only (not BOS, EOS or padding).
  3. `PatchTextAggregation` / `aggregate_attended`: the bidirectional
     cross-attention (`models.cross_modal`, or the fused kernel K10), the
     temperature aggregation of both streams and the 0.5 / 0.5 fusion.

`encode_patches_with_context` adds the context view of each box: the
whole frame with the box blacked out (`ops.image_ops.black_out_boxes`),
squash-resized to the tower's size and encoded by the same image features
function, so on CUDA through K1 / K2 too.

With `mask_padding` (the default) padded slots are inert; without it they
take part, as in the reference. The stages run under `torch.profiler`
ranges (`dclip.crop`, `dclip.region_encode`, `dclip.context_encode`,
`dclip.teacher_text`) that a profile reads for its breakdown of a step.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from dclip_tpu_torch.models.cross_modal import CrossModalAttention
from dclip_tpu_torch.ops.aggregation import fuse_global, temperature_aggregate
from dclip_tpu_torch.ops.image_ops import (batch_crop_resize_normalize, black_out_boxes,
                                           crop_resize_many, normalize, resize_frames)


class TeacherOutput(NamedTuple):
    global_embedding: torch.Tensor  # [B, D] fused teacher target
    text_global: torch.Tensor  # [B, D]
    image_global: torch.Tensor  # [B, D]
    attended_text: torch.Tensor  # [B, T, D]
    attended_image: torch.Tensor  # [B, P, D]


def aggregate_attended(cfg, attended_text: torch.Tensor, attended_image: torch.Tensor,
                       text_mask: Optional[torch.Tensor],
                       patch_mask: Optional[torch.Tensor]) -> TeacherOutput:
    """Aggregation and fusion of the attended streams, shared by the module
    path and the fused-kernel path."""
    tm = text_mask if cfg.mask_padding else None
    pm = patch_mask if cfg.mask_padding else None
    text_global = temperature_aggregate(attended_text, cfg.aggregation_temperature, mask=tm)
    image_global = temperature_aggregate(attended_image, cfg.aggregation_temperature, mask=pm)
    return TeacherOutput(fuse_global(text_global, image_global, cfg.fusion_alpha),
                         text_global, image_global, attended_text, attended_image)


class PatchTextAggregation(nn.Module):
    """Cross-attention fusion head over patch and token embeddings; its
    state dict is `cross_modal_attention.*`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.cross_modal_attention = CrossModalAttention(cfg.embed_dim, cfg.num_heads, device)

    def forward(self, text_embeddings: torch.Tensor, patch_embeddings: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None,
                patch_mask: Optional[torch.Tensor] = None) -> TeacherOutput:
        use = self.cfg.mask_padding
        at, ai = self.cross_modal_attention(
            text_embeddings, patch_embeddings, text_mask=text_mask if use else None,
            image_mask=patch_mask if use else None)
        return aggregate_attended(self.cfg, at, ai, text_mask, patch_mask)


FeaturesFn = Callable[[torch.Tensor], torch.Tensor]


def encode_patches(clip_model, images: torch.Tensor, boxes: torch.Tensor,
                   patch_mask: torch.Tensor, patch_size: int = 224,
                   image_features_fn: Optional[FeaturesFn] = None) -> torch.Tensor:
    """All region crops -> CLIP patch embeddings in one batched forward.

    images [B, H, W, 3] in [0, 1], boxes [B, P, 4] xyxy pixels, patch_mask
    [B, P] (1 = valid box) -> [B, P, D], invalid slots zero (in the
    promoted dtype of the embeddings and the mask, f32 for an f32 mask).
    `image_features_fn(pixels) -> [N, D]` replaces the module forward
    (`clip_model.image_features`), e.g. the frozen block-kernel path."""
    b, p = boxes.shape[:2]
    with record_function("dclip.crop"):
        patches = batch_crop_resize_normalize(images, boxes, patch_size)
    fn = image_features_fn or clip_model.image_features
    with record_function("dclip.region_encode"):
        emb = fn(patches.reshape(b * p, patch_size, patch_size, 3)).reshape(b, p, -1)
    return emb * patch_mask[..., None]


def encode_patches_with_context(clip_model, images: torch.Tensor, boxes: torch.Tensor,
                                patch_mask: torch.Tensor, patch_size: int = 224,
                                image_features_fn: Optional[FeaturesFn] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(patch_embeddings, context_embeddings), both [B, P, D], invalid slots
    zero in both. The context view of box p is image b with the box
    blacked out, resized to patch_size x patch_size (antialiased bilinear,
    `jax.image.resize`'s rule), normalized and encoded in one batched
    forward of B x P frames by `image_features_fn` (default: the module
    forward), as the patch view is."""
    b, p = boxes.shape[:2]
    patch_emb = encode_patches(clip_model, images, boxes, patch_mask, patch_size,
                               image_features_fn)
    fn = image_features_fn or clip_model.image_features
    with record_function("dclip.context_encode"):
        context = black_out_boxes(images, boxes)  # [B, P, H, W, 3]
        flat = resize_frames(context.reshape((b * p,) + context.shape[2:]), patch_size,
                             patch_size)
        ctx_emb = fn(normalize(flat)).reshape(b, p, -1)
    return patch_emb, ctx_emb * patch_mask[..., None]


def encode_patches_compact(clip_model, images: torch.Tensor, boxes: torch.Tensor,
                           patch_mask: torch.Tensor, patch_size: int = 224, budget: int = 0,
                           image_features_fn: Optional[FeaturesFn] = None) -> torch.Tensor:
    """`encode_patches` over only `budget` slots: valid slots are gathered
    first (stable argsort on the mask), exactly `budget` crops run through
    the ViT, and the results scatter back into the zero-padded [B, P, D]
    layout. Equal to `encode_patches` whenever budget >= the valid count."""
    b, p = boxes.shape[:2]
    if budget <= 0 or budget >= b * p:
        return encode_patches(clip_model, images, boxes, patch_mask, patch_size,
                              image_features_fn)
    flat_mask = patch_mask.reshape(-1)
    sel = torch.argsort(-flat_mask, stable=True)[:budget]
    with record_function("dclip.crop"):
        crops = normalize(crop_resize_many(images, sel // p, boxes.reshape(-1, 4)[sel],
                                           patch_size))
    fn = image_features_fn or clip_model.image_features
    with record_function("dclip.region_encode"):
        emb = fn(crops)
    emb = emb * flat_mask[sel][:, None]
    out = torch.zeros((b * p, emb.shape[-1]), dtype=emb.dtype, device=emb.device)
    return out.index_copy(0, sel, emb).reshape(b, p, -1)


def patch_budget(valid_count: int, total_slots: int, n_buckets: int = 4) -> int:
    """Smallest bucket (multiples of total / n_buckets) covering valid_count;
    total_slots when the batch is full (the dense path)."""
    step = max(total_slots // n_buckets, 1)
    bucket = ((max(valid_count, 1) + step - 1) // step) * step
    return min(bucket, total_slots)


def encode_tokens(clip_model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                  eos_token_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token_features [B, S, D] with non-content tokens zeroed, token_mask
    [B, S] f32): content tokens are those under the attention mask that are
    neither the BOS position nor an EOS id."""
    with record_function("dclip.teacher_text"):
        token_feats, _ = clip_model.get_token_features(input_ids, attention_mask)
    t = input_ids.shape[1]
    is_bos = torch.arange(t, device=input_ids.device)[None, :] == 0
    is_eos = input_ids == eos_token_id
    token_mask = ((attention_mask > 0) & ~is_bos & ~is_eos).float()
    return token_feats * token_mask[..., None], token_mask
