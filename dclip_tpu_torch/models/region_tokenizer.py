"""RegionTokenizer: detected regions -> gated CLIP patch tokens (counterpart
of `dclip_tpu/models/region_tokenizer.py`, the reference's
`TokenizerWithKNN`).

A batch runs as fixed-shape device ops: one crop-resize of every box, one
batched forward of the CLIP image tower over the crops
(`models.teacher.encode_patches`; on the card a bf16 model takes the
block kernels K1 / K2 by `models.encoding.image_route`), one k-NN gate
(`ops.knn.knn_or_projection`, K12 on the card) with the boxes normalized
to the frame as the projection head's positions. The store's keys and
values are copied to the model's device once, at construction.
`evaluate_threshold` encodes the regions once and runs only the gate per
threshold.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dclip_tpu_torch.models.encoding import image_forward, model_device
from dclip_tpu_torch.models.projections import ImageProjectionModule, projection_apply_fn
from dclip_tpu_torch.models.teacher import encode_patches
from dclip_tpu_torch.ops.knn import SOURCE_KNN, knn_or_projection
from dclip_tpu_torch.ops.losses import l2_normalize


class RegionTokens(NamedTuple):
    embeddings: torch.Tensor  # [B, P, D]
    source: torch.Tensor  # [B, P] int32 (0 knn / 1 projection / 2 clip)
    similarity: torch.Tensor  # [B, P]
    positions: torch.Tensor  # [B, P, 4] normalized xyxy
    mask: torch.Tensor  # [B, P]


class RegionTokenizer:
    def __init__(self, clip_model, store=None, projection_params=None,
                 similarity_threshold: float = 0.85, top_k: int = 3, patch_size: int = 224):
        """`clip_model`: the port's `CLIPModule` on its device (its dtype
        picks the route); `store`: an `EmbeddingStore`; `projection_params`:
        an `ImageProjectionModule` state dict of the CLIP projection
        width."""
        self.clip_model = clip_model
        self.device = model_device(clip_model)
        self.similarity_threshold = similarity_threshold
        self.top_k = top_k
        self.patch_size = patch_size
        self._image_features = image_forward(clip_model)
        self._store_keys = self._store_values = None
        if store is not None and len(store):
            self._store_keys, self._store_values = store.device_arrays(self.device)
        self._projection_fn = None
        if projection_params is not None:
            module = ImageProjectionModule(clip_model.cfg.projection_dim, device="meta")
            self._projection_fn = projection_apply_fn(module, projection_params, self.device)

    def _queries(self, images, boxes, mask):
        """(normalized queries [B*P, D] f32, positions [B, P, 4], boxes, mask)
        on the device: the one region encode of a batch."""
        dev = self.device
        images = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor)
                                 else images, dtype=torch.float32).to(dev)
        boxes = torch.as_tensor(boxes, dtype=torch.float32).to(dev)
        mask = torch.as_tensor(mask, dtype=torch.float32).to(dev)
        b, p = boxes.shape[:2]
        h, w = images.shape[1:3]
        with torch.inference_mode():
            raw = encode_patches(self.clip_model, images, boxes, mask, self.patch_size,
                                 self._image_features)
            queries = l2_normalize(raw.reshape(b * p, -1).float())
        positions = boxes / torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
        return queries, positions, mask

    def _gate(self, queries, positions, threshold: float):
        with torch.inference_mode():
            return knn_or_projection(queries, positions.reshape(-1, 4), self._store_keys,
                                     self._store_values, self._projection_fn, threshold,
                                     k=self.top_k)

    def batch_tokenize(self, images, boxes, mask, threshold: Optional[float] = None
                       ) -> RegionTokens:
        """images [B, H, W, 3] in [0, 1], boxes [B, P, 4] xyxy pixels, mask
        [B, P] -> every region through crop-encode and the gate."""
        queries, positions, mask = self._queries(images, boxes, mask)
        b, p = mask.shape
        res = self._gate(queries, positions,
                         self.similarity_threshold if threshold is None else threshold)
        return RegionTokens(
            embeddings=res.embeddings.reshape(b, p, -1) * mask[..., None],
            source=res.source.reshape(b, p),
            similarity=res.similarity.reshape(b, p) * mask,
            positions=positions,
            mask=mask,
        )

    def evaluate_threshold(self, images, boxes, mask,
                           thresholds: Sequence[float] = tuple(np.arange(0.60, 0.951, 0.05))
                           ) -> Dict[float, Dict[str, float]]:
        """Threshold sweep: per threshold, the share of valid patches served
        by the store and by the fallback, and the mean similarity of the
        hits. One region encode; only the gate runs per threshold."""
        queries, positions, mask = self._queries(images, boxes, mask)
        valid = mask.reshape(-1).cpu().numpy() > 0
        out: Dict[float, Dict[str, float]] = {}
        for th in thresholds:
            res = self._gate(queries, positions, float(th))
            src = res.source.cpu().numpy()[valid]
            sims = res.similarity.cpu().numpy()[valid]
            n = max(len(src), 1)
            knn_frac = float((src == SOURCE_KNN).sum()) / n
            hits = src == SOURCE_KNN
            out[round(float(th), 2)] = {
                "knn_fraction": knn_frac,
                "fallback_fraction": 1.0 - knn_frac,
                "mean_similarity": float(sims[hits].mean()) if hits.any() else 0.0,
            }
        return out
