"""Offline cache builder CLI (counterpart of `dclip_tpu/cli/precache.py`,
the reference's `training/train_pickle.py`): one pass over a corpus JSON
writes the detection cache and, with --build_index, the patch index.

    python -m dclip_tpu_torch.cli.precache --json_file data/teacher_train.json \
        --cache_dir cache [--detector grid|flax|ultralytics] [--build_index] \
        [--device cuda|cpu] [model flags]

Artifacts (the JAX CLI's layout, readable by both packages):
- <cache_dir>/<stem>_precache.npz      the detection cache
- <cache_dir>/<stem>_patch_index.npz   the patch EmbeddingStore (--build_index)

Images are read with PIL (`data.pipeline.require_pil`); an installation
without it raises, naming the decoder that replaces it.
"""
from __future__ import annotations

import argparse
import os

from dclip_tpu_torch.cli.common import add_device_arg, add_model_args, load_clip
from dclip_tpu_torch.data.corpus import load_corpus
from dclip_tpu_torch.data.detection_cache import (
    DetectionCache,
    GridProposalDetector,
    build_cache,
    cache_path_for,
)
from dclip_tpu_torch.data.index import build_patch_index


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build detection + patch-index caches")
    p.add_argument("--json_file", required=True)
    p.add_argument("--cache_dir", default="cache")
    p.add_argument("--detector", choices=["grid", "flax", "ultralytics"], default="grid",
                   help="'grid': dependency-free proposals; 'flax': the port's own YOLOv8 "
                        "detector (models.detector; random weights from --seed unless "
                        "--detector_checkpoint); 'ultralytics': real YOLOv8 weights imported "
                        "by models.detector_import from --detector_checkpoint (.pt state "
                        "dict / .npz / .safetensors, architecture inferred from shapes), "
                        "the reference's yolov8x proposal source")
    p.add_argument("--detector_checkpoint", default=None,
                   help="flax: the port's detector state dict (torch.save of "
                        "Detector.model.state_dict(); not flax msgpack); ultralytics: an "
                        "exported ultralytics state-dict file")
    p.add_argument("--detector_image_size", type=int, default=640)
    p.add_argument("--build_index", action="store_true",
                   help="also build the patch EmbeddingStore (compute_faiss role)")
    p.add_argument("--batch_size", type=int, default=256)
    add_model_args(p)
    add_device_arg(p)
    return p


def make_detect_fn(args):
    """The --detector choice as a `detect_fn`."""
    from dclip_tpu_torch.models.detector import Detector, DetectorConfig

    if args.detector == "ultralytics":
        from dclip_tpu_torch.models.detector_import import load_ultralytics_checkpoint

        if not args.detector_checkpoint:
            raise SystemExit("--detector ultralytics requires --detector_checkpoint")
        det_cfg, state_dict = load_ultralytics_checkpoint(
            args.detector_checkpoint, image_size=args.detector_image_size)
        print(f"Imported YOLOv8 checkpoint: width={det_cfg.width} depth={det_cfg.depth} "
              f"nc={det_cfg.num_classes}")
        return Detector(det_cfg, state_dict, args.device).as_detect_fn()
    if args.detector == "flax":
        det_cfg = DetectorConfig(image_size=args.detector_image_size)
        if args.detector_checkpoint:
            from dclip_tpu_torch.train.checkpoint import restore_state

            det = Detector(det_cfg, restore_state(args.detector_checkpoint), args.device)
        else:
            det = Detector.initialize(det_cfg, seed=args.seed, device=args.device)
        return det.as_detect_fn()
    return GridProposalDetector()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    items = load_corpus(args.json_file)
    paths = [it["image_path"] for it in items]
    print(f"{len(items)} corpus items, {len(dict.fromkeys(paths))} unique images")

    detect_fn = make_detect_fn(args)
    det_path = cache_path_for(args.json_file, "precache", args.cache_dir)
    existing = DetectionCache.load(det_path) if os.path.exists(det_path) else None
    cache = build_cache(paths, detect_fn, det_path, existing)
    print(f"Detection cache: {det_path} ({len(cache)} images)")

    if args.build_index:
        cfg, model = load_clip(args.model_preset, args.clip_weights, args.seed,
                               device=args.device)
        idx_path = cache_path_for(args.json_file, "patch_index", args.cache_dir)
        store = build_patch_index(paths, model, detection_cache=cache,
                                  image_size=cfg.vision.image_size, batch_size=args.batch_size,
                                  output_path=idx_path)
        print(f"Patch index: {idx_path} ({len(store)} embeddings)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
