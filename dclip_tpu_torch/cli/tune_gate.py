"""Threshold sweep of the k-NN gate (counterpart of
`dclip_tpu/cli/tune_gate.py`): over a corpus sample, the share of valid
patches served by the store and by the fallback, and the mean similarity
of the hits, per threshold. The region encode runs once; only the gate
runs per threshold (`models.region_tokenizer.RegionTokenizer.
evaluate_threshold`).

    python -m dclip_tpu_torch.cli.tune_gate --json_file data/teacher_train.json \
        --detection_cache cache/teacher_train_precache.npz \
        --knn_store cache/teacher_train_patch_index.npz \
        [--projection_weights proj.pt] [--sample 64] [--device cuda|cpu] [model flags]

Pick the threshold where the knn share starts dropping steeply. Images
are read with PIL (`data.pipeline.require_pil`).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dclip_tpu_torch.cli.common import add_device_arg, add_model_args, load_clip
from dclip_tpu_torch.data.corpus import load_corpus
from dclip_tpu_torch.data.detection_cache import DetectionCache, GridProposalDetector, build_cache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sweep the knn-gate similarity threshold")
    p.add_argument("--json_file", required=True)
    p.add_argument("--detection_cache", default=None,
                   help="npz/native detection cache (cli.precache output); built on the fly "
                        "with grid proposals when absent")
    p.add_argument("--knn_store", required=True,
                   help="EmbeddingStore (cli.precache --build_index output)")
    p.add_argument("--projection_weights", default=None,
                   help="ImageProjectionModule weights enabling the projection branch below "
                        "the threshold: a port-format file (models.projections."
                        "save_image_projection, torch.save); flax msgpack is not read")
    p.add_argument("--sample", type=int, default=64,
                   help="corpus items to probe (first N after load)")
    p.add_argument("--max_patches", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224,
                   help="probe frame resolution (teacher_image_size)")
    p.add_argument("--thresholds", type=float, nargs="*", default=None,
                   help="default: 0.60..0.95 step 0.05")
    add_model_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.data.pipeline import require_pil, squash_resize
    from dclip_tpu_torch.models.region_tokenizer import RegionTokenizer

    Image = require_pil()
    items = load_corpus(args.json_file)[:args.sample]
    paths = [it["image_path"] for it in items]
    if args.detection_cache and os.path.exists(args.detection_cache):
        cache = DetectionCache.load(args.detection_cache)
    else:
        print("no --detection_cache: building grid proposals for the sample")
        cache = build_cache(paths, GridProposalDetector())

    cfg, model = load_clip(args.model_preset, args.clip_weights, args.seed, device=args.device)
    store = EmbeddingStore.load(args.knn_store)
    print(f"knn store: {len(store)} embeddings")
    projection_params = None
    if args.projection_weights and os.path.exists(args.projection_weights):
        from dclip_tpu_torch.models.projections import load_image_projection

        _, projection_params = load_image_projection(args.projection_weights, cfg.projection_dim)
        print("projection branch enabled")

    # The sample as one fixed-shape probe batch: the pipeline's teacher
    # frame (squash resize) with the boxes rescaled into it.
    size = args.image_size
    images, all_boxes, all_mask = [], [], []
    for path in paths:
        try:
            with Image.open(path) as im:
                im = im.convert("RGB")
                w, h = im.size
                images.append(squash_resize(im, size))
        except OSError:
            w = h = size
            images.append(np.zeros((size, size, 3), np.float32))
        boxes, _, mask = cache.get_fixed([path], args.max_patches)
        scale = np.asarray([size / max(w, 1), size / max(h, 1)] * 2, np.float32)
        all_boxes.append(boxes[0] * scale)
        all_mask.append(mask[0])

    tokenizer = RegionTokenizer(model, store=store, projection_params=projection_params,
                                patch_size=cfg.vision.image_size)
    thresholds = args.thresholds if args.thresholds else tuple(np.arange(0.60, 0.951, 0.05))
    results = tokenizer.evaluate_threshold(np.stack(images), np.stack(all_boxes),
                                           np.stack(all_mask), thresholds=thresholds)

    n_valid = int(np.stack(all_mask).sum())
    print(f"\nGate sweep over {len(items)} items / {n_valid} valid patches")
    print(f"{'threshold':<11} {'knn%':<8} {'fallback%':<11} {'mean knn sim':<12}")
    print("-" * 44)
    for th, row in sorted(results.items()):
        print(f"{th:<11.2f} {row['knn_fraction'] * 100:<8.1f} "
              f"{row['fallback_fraction'] * 100:<11.1f} {row['mean_similarity']:<12.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
