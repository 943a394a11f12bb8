"""The plain teacher: the benchmark's reference of the teacher targets.

From the published description of the distillation's meta-teacher, in
plain PyTorch, importing nothing of the program:

1. Every box of every image is cropped and squash-resized to the tower's
   size by `jax.image.scale_and_translate`'s antialiased linear rule (the
   JAX package's crop): one [out, in] triangle-weight matrix per axis and
   box; the crops are CLIP-normalized and run through the teacher's CLIP
   image tower; invalid boxes give zero rows. [B, P, D]
2. The teacher's CLIP text tower gives every token's projected state;
   content tokens (under the mask, not position 0, not an EOS id) are
   kept, the rest zeroed. [B, T, D]
3. Bidirectional cross-attention, each direction with its residual and
   LayerNorm (eps 1e-5): text attends to the boxes, boxes to the text,
   masked keys at float32's lowest value.
4. Temperature aggregation of each attended stream (softmax of the cosine
   to the masked mean over the temperature), fused 0.5 / 0.5 into the
   image target; the text target is the mean of the content tokens.

Computed in blocks of images so that it fits beside nothing at L/14.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from benchmark.reference.clip import Precision, image_features, layer_norm, token_features

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_NEG = torch.finfo(torch.float32).min
_EPS32 = float(np.finfo(np.float32).eps)


def resize_weights(in_size: int, out_size: int, scale: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """[n, out, in] weights of `scale_and_translate(method="linear",
    antialias=True)` along one axis, for n (scale, translation) pairs."""
    inv = 1.0 / scale.double()
    widen = torch.clamp(inv, min=1.0)
    j = torch.arange(out_size, dtype=torch.float64, device=scale.device)
    sample = (j[None] + 0.5) * inv[:, None] - translation.double()[:, None] * inv[:, None] - 0.5
    i = torch.arange(in_size, dtype=torch.float64, device=scale.device)
    w = torch.clamp(1.0 - (sample[:, :, None] - i).abs() / widen[:, None, None], min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], w, torch.zeros_like(w)).float()


def crops(images: torch.Tensor, boxes: torch.Tensor, out: int) -> torch.Tensor:
    """images [b, H, W, C] in [0, 1], boxes [b, P, 4] xyxy pixels ->
    CLIP-normalized crops [b * P, out, out, C], box (i, k) at row i * P + k."""
    b, h, w, c = images.shape
    p = boxes.shape[1]
    x1, y1, x2, y2 = boxes.reshape(b * p, 4).double().unbind(-1)
    sy = out / torch.clamp(y2 - y1, min=1.0)
    sx = out / torch.clamp(x2 - x1, min=1.0)
    wy = resize_weights(h, out, sy, -y1 * sy)  # [n, out, H]
    wx = resize_weights(w, out, sx, -x1 * sx)  # [n, out, W]
    src = images.float().repeat_interleave(p, dim=0)  # [n, H, W, C]
    y = torch.einsum("nqh,nhwc->nqwc", wy, src)
    y = torch.einsum("npw,nqwc->nqpc", wx, y)
    mean = torch.tensor(CLIP_MEAN, device=images.device)
    std = torch.tensor(CLIP_STD, device=images.device)
    return (y - mean) / std


def _mha(q_in: torch.Tensor, kv_in: torch.Tensor, p: Mapping[str, torch.Tensor],
         prefix: str, heads: int, key_mask: torch.Tensor, prec: Precision) -> torch.Tensor:
    b, sq, d = q_in.shape
    sk = kv_in.shape[1]
    hd = d // heads
    w, bias = p[prefix + ".in_proj_weight"], p[prefix + ".in_proj_bias"]
    q = prec.linear(q_in, w[:d], bias[:d]).reshape(b, sq, heads, hd).transpose(1, 2)
    k = prec.linear(kv_in, w[d:2 * d], bias[d:2 * d]).reshape(b, sk, heads, hd).transpose(1, 2)
    v = prec.linear(kv_in, w[2 * d:], bias[2 * d:]).reshape(b, sk, heads, hd).transpose(1, 2)
    logits = prec.matmul(q * hd ** -0.5, k.transpose(-1, -2))
    logits = logits.masked_fill(~(key_mask[:, None, None, :] > 0), _NEG)
    out = prec.matmul(torch.softmax(logits, -1), v).transpose(1, 2).reshape(b, sq, d)
    return prec.linear(out, p[prefix + ".out_proj.weight"], p[prefix + ".out_proj.bias"])


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))


def temperature_aggregate(x: torch.Tensor, mask: torch.Tensor, temperature: float):
    """[B, S, D], mask [B, S] -> [B, D]."""
    m = mask.float()
    mean = (x * m[..., None]).sum(1, keepdim=True) / torch.clamp(m.sum(1), min=1.0)[:, None,
                                                                                      None]
    sims = (_normalized(x) * _normalized(mean)).sum(-1)
    logits = torch.where(m > 0, sims / temperature, torch.full_like(sims, _NEG))
    weights = torch.exp(logits - logits.amax(1, keepdim=True)) * m
    weights = weights / torch.clamp(weights.sum(1, keepdim=True), min=1e-12)
    return (x * weights[..., None]).sum(1)


def teacher_targets(clip_p: Mapping[str, torch.Tensor], xattn_p: Mapping[str, torch.Tensor],
                    shapes, batch: Mapping[str, np.ndarray], device, prec: Precision,
                    block: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch's (image target, text target), each [B, D] float32."""
    tc = shapes.teacher
    size = shapes.vision.image_size
    box_mask = torch.from_numpy(batch["box_mask"]).to(device).float()
    n = box_mask.shape[0]
    rows = []
    with torch.no_grad():
        for i in range(0, n, block):
            imgs = torch.from_numpy(batch["teacher_pixels"][i:i + block]).to(device)
            bx = torch.from_numpy(batch["boxes"][i:i + block]).to(device)
            feats = image_features(clip_p, shapes, crops(imgs, bx, size), prec)
            rows.append(feats.reshape(imgs.shape[0], bx.shape[1], -1))
        pe = torch.cat(rows) * box_mask[..., None]

        ids = torch.from_numpy(batch["input_ids"]).to(device)
        mask = torch.from_numpy(batch["attention_mask"]).to(device)
        te = token_features(clip_p, shapes, ids, mask, prec)
        positions = torch.arange(ids.shape[1], device=device)[None]
        tmask = ((mask > 0) & (positions != 0) & (ids != shapes.text.eos_token_id)).float()
        te = te * tmask[..., None]

        pre = "cross_modal_attention."
        attended_text = layer_norm(
            te + _mha(te, pe, xattn_p, pre + "text_to_image", tc.num_heads, box_mask, prec),
            xattn_p, pre + "norm_text", 1e-5)
        attended_image = layer_norm(
            pe + _mha(pe, te, xattn_p, pre + "image_to_text", tc.num_heads, tmask, prec),
            xattn_p, pre + "norm_image", 1e-5)
        text_global = temperature_aggregate(attended_text, tmask, tc.aggregation_temperature)
        image_global = temperature_aggregate(attended_image, box_mask, tc.aggregation_temperature)
        target_img = tc.fusion_alpha * text_global + (1.0 - tc.fusion_alpha) * image_global
        target_txt = te.sum(1) / torch.clamp(tmask.sum(1, keepdim=True), min=1.0)
    return target_img, target_txt

