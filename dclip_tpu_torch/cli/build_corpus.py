"""Corpus builder CLI (counterpart of `dclip_tpu/cli/build_corpus.py`): the
reference's `json_creation/big_teacher_data.py` (CLI contract :432-471:
--output_dir plus per-source image/annotation paths and target counts).
The same flags and output files as the JAX CLI; `--allow_network` fetches
the Conceptual Captions images (`data.fetch.fetch_conceptual_captions`) on
a machine with a network, and without it only images on disk are used.

    python -m dclip_tpu_torch.cli.build_corpus --output_dir data \
        --coco_images /data/coco/train2014 --coco_annotations captions.json \
        [--vg_images ... --vg_annotations ...] [--flickr_images ... \
        --flickr_annotations ...] [--cc_images ... --cc_annotations ...]
"""
from __future__ import annotations

import argparse
import os

from dclip_tpu_torch.data.corpus import DEFAULT_TARGETS, CorpusPaths, combine_datasets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build the combined training corpus")
    p.add_argument("--output_dir", default="data")
    p.add_argument("--train_name", default="teacher_train.json")
    p.add_argument("--val_name", default="teacher_val.json")
    p.add_argument("--coco_images", default=None)
    p.add_argument("--coco_annotations", default=None)
    p.add_argument("--vg_images", default=None)
    p.add_argument("--vg_annotations", default=None)
    p.add_argument("--flickr_images", default=None)
    p.add_argument("--flickr_annotations", default=None)
    p.add_argument("--cc_images", default=None)
    p.add_argument("--cc_annotations", default=None)
    p.add_argument("--coco_target", type=int, default=DEFAULT_TARGETS["coco"])
    p.add_argument("--vg_target", type=int, default=DEFAULT_TARGETS["visual_genome"])
    p.add_argument("--flickr_target", type=int, default=DEFAULT_TARGETS["flickr30k"])
    p.add_argument("--cc_target", type=int,
                   default=DEFAULT_TARGETS["conceptual_captions"])
    p.add_argument("--cc_max_scan_rows", type=int, default=None,
                   help="cap on CC TSV rows scanned; the reference scans "
                        "target*5 rows to absorb download failures "
                        "(big_teacher_data.py:263) and can undershoot — "
                        "default scans until the target is met")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--allow_network", action="store_true",
                   help="permit the Conceptual Captions live image fetch "
                        "(reference big_teacher_data.py:228-350: browser "
                        "UA, 5s timeout, PIL validation, 5x row "
                        "oversampling). Zero-egress default: only images "
                        "already on disk are used")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    paths = CorpusPaths(
        coco_images_dir=args.coco_images,
        coco_annotations_file=args.coco_annotations,
        vg_images_dir=args.vg_images,
        vg_annotations_file=args.vg_annotations,
        flickr_images_dir=args.flickr_images,
        flickr_annotations_file=args.flickr_annotations,
        cc_images_dir=args.cc_images,
        cc_annotations_file=args.cc_annotations,
        cc_max_scan_rows=args.cc_max_scan_rows,
        allow_network=args.allow_network,
        targets={
            "coco": args.coco_target,
            "visual_genome": args.vg_target,
            "flickr30k": args.flickr_target,
            "conceptual_captions": args.cc_target,
        },
    )
    os.makedirs(args.output_dir, exist_ok=True)
    train, val = combine_datasets(
        paths,
        os.path.join(args.output_dir, args.train_name),
        os.path.join(args.output_dir, args.val_name),
        seed=args.seed,
        val_fraction=args.val_fraction,
    )
    return 0 if train else 1


if __name__ == "__main__":
    raise SystemExit(main())
