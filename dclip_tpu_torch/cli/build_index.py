"""Patch-index CLI over an image directory (counterpart of
`dclip_tpu/cli/build_index.py`, the reference's `training/compute_faiss.py`):
grid proposals over every image, each crop CLIP-encoded into one
EmbeddingStore.

    python -m dclip_tpu_torch.cli.build_index --image_dir /data/images \
        --output trained_models/patch_index.npz [--device cuda|cpu] [model flags]

Images are read with PIL (`data.pipeline.require_pil`).
"""
from __future__ import annotations

import argparse
import os

from dclip_tpu_torch.cli.common import add_device_arg, add_model_args, load_clip
from dclip_tpu_torch.data.detection_cache import GridProposalDetector
from dclip_tpu_torch.data.index import build_patch_index

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build the patch retrieval index")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--output", default="patch_index.npz")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--max_images", type=int, default=None)
    add_model_args(p, default_preset="vit-b-32")  # compute_faiss used B/32
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    paths = sorted(os.path.join(args.image_dir, f) for f in os.listdir(args.image_dir)
                   if f.lower().endswith(IMAGE_EXTS))
    if args.max_images:
        paths = paths[:args.max_images]
    print(f"Indexing {len(paths)} images from {args.image_dir}")
    cfg, model = load_clip(args.model_preset, args.clip_weights, args.seed, device=args.device)
    store = build_patch_index(paths, model, detect_fn=GridProposalDetector(),
                              image_size=cfg.vision.image_size, batch_size=args.batch_size,
                              output_path=args.output)
    print(f"Wrote {len(store)} patch embeddings to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
