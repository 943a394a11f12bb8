"""Karpathy retrieval evaluation, the flickr30k_eval / COCO protocol
(counterpart of `dclip_tpu/eval/retrieval.py:28-219`).

- an eval JSON of `{"image_path", "image_id", "captions"}` records, items
  without captions dropped, cut to `max_images`;
- every image and caption embedded in batches on the model's device (the
  image tower on K1 / K2 for a bf16 model on the card), L2-normalized,
  one cosine similarity matrix;
- t2i / i2t R@1/5/10 and MAP with the stable argsort ranks of
  `ops.retrieval`;
- the base-vs-custom table with the relative R@1 gain.

A file that cannot be read embeds as a zero image, as in the JAX package;
a missing image library raises instead (`data.pipeline`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from dclip_tpu_torch.data.corpus import load_corpus
from dclip_tpu_torch.models.clip import CLIPModule
from dclip_tpu_torch.models.encoding import (
    make_image_encoder,
    model_device,
    packed_text_forward,
    text_forward,
)
from dclip_tpu_torch.ops.retrieval import retrieval_metrics

_MESH = "mesh: multi-device eval is ROADMAP Queue 1 item 10 (multi-device)"


def load_eval_items(dataset_json: str, max_images: int = 1000) -> List[dict]:
    return load_corpus(dataset_json)[:max_images]


def embed_images(model: CLIPModule, image_paths: Sequence[str], batch_size: int = 256,
                 image_size: int = 224, mesh=None) -> np.ndarray:
    """Decode and preprocess on the host, embed in batches -> [N, P] f32."""
    from dclip_tpu_torch.data.pipeline import require_pil, preprocess_image

    if mesh is not None:
        raise NotImplementedError(_MESH)
    Image = require_pil()
    pixels = []
    for path in image_paths:
        try:
            with Image.open(path) as im:
                pixels.append(preprocess_image(im.convert("RGB"), image_size))
        except Exception:  # noqa: BLE001 — an unreadable file is a zero image, as in JAX
            pixels.append(np.zeros((image_size, image_size, 3), np.float32))
    return make_image_encoder(model, batch_size)(pixels)


def embed_captions(model: CLIPModule, tokenizer, captions: Sequence[str], batch_size: int = 256,
                   mesh=None, packed: bool = False) -> np.ndarray:
    """[N] captions -> [N, P] f32, in batches of `batch_size` (the tail
    padded with empty captions). `packed=True` encodes each batch as
    packed rows (`ops.packing.pack_captions`): several captions' tokens a
    row, features gathered back to caption order; the numbers of the
    unpacked encode."""
    from dclip_tpu_torch.ops.packing import pack_captions

    if mesh is not None:
        raise NotImplementedError(_MESH)
    out = []
    for start in range(0, len(captions), batch_size):
        chunk = list(captions[start:start + batch_size])
        n = len(chunk)
        chunk += [""] * (batch_size - n)
        ids, mask = tokenizer.encode_batch(chunk)
        if packed:
            emb = packed_text_forward(model, pack_captions(np.asarray(ids), np.asarray(mask),
                                                           model.cfg.text.eos_token_id))
        else:
            emb = text_forward(model, ids, mask)
        out.append(emb[:n].float().cpu().numpy())
    if not out:
        return np.zeros((0, model.cfg.projection_dim), np.float32)
    return np.concatenate(out, 0)


def evaluate_retrieval(model: CLIPModule, tokenizer, items: Sequence[dict], batch_size: int = 256,
                       image_size: int = 224, mesh=None,
                       packed_captions: bool = False) -> Dict[str, Dict[str, float]]:
    """The whole protocol on one model -> {"t2i": {...}, "i2t": {...}};
    the metrics run on the model's device."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    image_paths = [it["image_path"] for it in items]
    captions: List[str] = []
    caption_to_image: List[int] = []
    for idx, it in enumerate(items):
        for cap in it["captions"]:
            captions.append(cap)
            caption_to_image.append(idx)
    img = embed_images(model, image_paths, batch_size, image_size)
    cap = embed_captions(model, tokenizer, captions, batch_size, packed=packed_captions)
    metrics = retrieval_metrics(cap, img, np.asarray(caption_to_image, np.int64),
                                device=model_device(model))
    return {d: {k: float(v) for k, v in dd.items()} for d, dd in metrics.items()}


def print_retrieval_table(results: Dict[str, Dict[str, Dict[str, float]]]) -> None:
    """Base-vs-custom comparison with the relative R@1 gain."""
    for direction, label in (("t2i", "Text -> Image"), ("i2t", "Image -> Text")):
        print(f"\n{label} Retrieval")
        print("=" * 60)
        print(f"{'Model':<12} {'R@1':<10} {'R@5':<10} {'R@10':<10} {'MAP':<10}")
        print("-" * 60)
        for model_name, res in results.items():
            m = res[direction]
            print(f"{model_name:<12} {m['R@1']:<10.4f} {m['R@5']:<10.4f} "
                  f"{m['R@10']:<10.4f} {m['MAP']:<10.4f}")
        if "base" in results and "custom" in results:
            b, c = results["base"][direction], results["custom"][direction]
            if b["R@1"] > 0:
                print(f"Relative R@1 gain: {(c['R@1'] - b['R@1']) / b['R@1'] * 100:+.2f}%")
