"""Patch-index builder (counterpart of `dclip_tpu/data/index.py`): the
reference's `compute_faiss.py` as one offline pass writing an
`EmbeddingStore`.

Per image: its boxes (a detection cache, a `detect_fn`, else the whole
frame), each box cropped with PIL and preprocessed as CLIP's processor
does (`data.pipeline.preprocess_image`), the crops encoded in batches by
`models.encoding.make_image_encoder` (K1 / K2 for a bf16 model on the
card) and stored L2-normalized with ids `<image-stem>_patch<i>` and the
box normalized to the frame as the position. Missing files are skipped,
and so is an unreadable one, with a message. Needs PIL
(`data.pipeline.require_pil`), so it runs where the decoder does.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from dclip_tpu_torch.data.detection_cache import DetectFn, DetectionCache
from dclip_tpu_torch.data.embedding_store import EmbeddingStore
from dclip_tpu_torch.data.pipeline import preprocess_image, require_pil


def build_patch_index(image_paths: Sequence[str], clip_model,
                      detection_cache: Optional[DetectionCache] = None,
                      detect_fn: Optional[DetectFn] = None, image_size: int = 224,
                      batch_size: int = 256, output_path: Optional[str] = None) -> EmbeddingStore:
    """Crop every detected box, batch-encode, store normalized embeddings."""
    from dclip_tpu_torch.models.encoding import make_image_encoder

    Image = require_pil()
    encoder = make_image_encoder(clip_model, batch_size)
    store: Optional[EmbeddingStore] = None
    pending_pixels: list = []
    pending_meta: list = []

    def flush():
        nonlocal store
        if not pending_pixels:
            return
        emb = encoder(pending_pixels)
        if store is None:
            store = EmbeddingStore(dim=emb.shape[-1])
        for (pid, pos), e in zip(pending_meta, emb):
            store.add(pid, e, position=pos)
        pending_pixels.clear()
        pending_meta.clear()

    for path in dict.fromkeys(image_paths):
        if not os.path.exists(path):
            continue
        try:
            with Image.open(path) as im:
                im = im.convert("RGB")
                w, h = im.size
                if detection_cache is not None and path in detection_cache:
                    boxes, _ = detection_cache.get(path)
                elif detect_fn is not None:
                    boxes, _ = detect_fn(np.asarray(im))
                else:
                    boxes = np.asarray([[0, 0, w, h]], np.float32)
                stem = os.path.splitext(os.path.basename(path))[0]
                for i, box in enumerate(boxes):
                    x1, y1, x2, y2 = (float(v) for v in box)
                    if x2 <= x1 or y2 <= y1:
                        continue
                    pending_pixels.append(preprocess_image(im.crop((x1, y1, x2, y2)), image_size))
                    pending_meta.append((f"{stem}_patch{i}", [x1 / w, y1 / h, x2 / w, y2 / h]))
                    if len(pending_pixels) >= batch_size:
                        flush()
        except OSError as e:  # PIL's UnidentifiedImageError included
            print(f"Skipping {path}: {e}")
    flush()
    store = store or EmbeddingStore(dim=512)  # nothing encoded: the JAX builder's default
    if output_path:
        store.save(output_path)
    return store
