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

With a `parallel.mesh.Mesh` of several ranks (`mesh=`), each rank decodes
and embeds its block of the images and of the captions (packed per rank)
and the features are all-gathered in order (`models.encoding.
sharded_encode`); the ranks then split the rank work
(`ops.retrieval.retrieval_metrics_sharded`). Every rank returns the
one-rank metrics.
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
    rank_batch_size,
    sharded_encode,
    text_forward,
)
from dclip_tpu_torch.ops.retrieval import retrieval_metrics, retrieval_metrics_sharded


def load_eval_items(dataset_json: str, max_images: int = 1000) -> List[dict]:
    return load_corpus(dataset_json)[:max_images]


def embed_images(model: CLIPModule, image_paths: Sequence[str], batch_size: int = 256,
                 image_size: int = 224, mesh=None) -> np.ndarray:
    """Decode and preprocess on the host, embed in batches -> [N, P] f32;
    with a mesh, each rank decodes and embeds its block."""
    from dclip_tpu_torch.data.pipeline import require_pil, preprocess_image

    Image = require_pil()
    encoder = make_image_encoder(model, rank_batch_size(batch_size, mesh))

    def encode_rows(paths):
        pixels = []
        for path in paths:
            try:
                with Image.open(path) as im:
                    pixels.append(preprocess_image(im.convert("RGB"), image_size))
            except Exception:  # noqa: BLE001 — an unreadable file is a zero image, as in JAX
                pixels.append(np.zeros((image_size, image_size, 3), np.float32))
        return encoder(pixels)

    return sharded_encode(list(image_paths), encode_rows, mesh, model.cfg.projection_dim)


def embed_captions(model: CLIPModule, tokenizer, captions: Sequence[str], batch_size: int = 256,
                   mesh=None, packed: bool = False) -> np.ndarray:
    """[N] captions -> [N, P] f32, in batches of `batch_size` (the tail
    padded with empty captions). `packed=True` encodes each batch as
    packed rows (`ops.packing.pack_captions`): several captions' tokens a
    row, features gathered back to caption order; the numbers of the
    unpacked encode. With a mesh, each rank encodes (and packs) its block
    of the captions in batches of batch_size / size."""
    from dclip_tpu_torch.ops.packing import pack_captions

    per_batch = rank_batch_size(batch_size, mesh)

    def encode_rows(caps):
        out = []
        for start in range(0, len(caps), per_batch):
            chunk = list(caps[start:start + per_batch])
            n = len(chunk)
            chunk += [""] * (per_batch - n)
            ids, mask = tokenizer.encode_batch(chunk)
            if packed:
                emb = packed_text_forward(model, pack_captions(
                    np.asarray(ids), np.asarray(mask), model.cfg.text.eos_token_id))
            else:
                emb = text_forward(model, ids, mask)
            out.append(emb[:n].float().cpu().numpy())
        if not out:
            return np.zeros((0, model.cfg.projection_dim), np.float32)
        return np.concatenate(out, 0)

    return sharded_encode(list(captions), encode_rows, mesh, model.cfg.projection_dim)


def evaluate_retrieval(model: CLIPModule, tokenizer, items: Sequence[dict], batch_size: int = 256,
                       image_size: int = 224, mesh=None,
                       packed_captions: bool = False) -> Dict[str, Dict[str, float]]:
    """The whole protocol on one model -> {"t2i": {...}, "i2t": {...}};
    the metrics run on the model's device, split over the mesh's ranks
    when there is one."""
    image_paths = [it["image_path"] for it in items]
    captions: List[str] = []
    caption_to_image: List[int] = []
    for idx, it in enumerate(items):
        for cap in it["captions"]:
            captions.append(cap)
            caption_to_image.append(idx)
    img = embed_images(model, image_paths, batch_size, image_size, mesh=mesh)
    cap = embed_captions(model, tokenizer, captions, batch_size, mesh=mesh,
                         packed=packed_captions)
    c2i = np.asarray(caption_to_image, np.int64)
    if mesh is not None:
        metrics = retrieval_metrics_sharded(cap, img, c2i, mesh, device=model_device(model))
    else:
        metrics = retrieval_metrics(cap, img, c2i, device=model_device(model))
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
