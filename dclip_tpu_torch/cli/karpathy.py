"""Karpathy split CLI (counterpart of `dclip_tpu/cli/karpathy.py`): the
reference's `json_creation/karpathy_download.py` contract (--datasets
{coco,flickr30k,both}, --coco_dir, --flickr_dir, --output_dir, --split),
reading the Karpathy `dataset_<name>.json` already on disk, or with
`--download --allow_network` fetching and extracting the cs.stanford.edu
zip into --data_dir first (`data.fetch.download_karpathy_split`; a cached
zip is reused). It writes the --dataset_json that `flickr30k_eval` reads.

    python -m dclip_tpu_torch.cli.karpathy --datasets flickr30k \
        --flickr_dir /data/flickr30k_images \
        --karpathy_json /data/karpathy/flickr30k/dataset_flickr30k.json \
        --output_dir data --split test

    python -m dclip_tpu_torch.cli.karpathy --datasets flickr30k --download \
        --allow_network --data_dir data/karpathy \
        --flickr_dir /data/flickr30k_images --output_dir data --split test
"""
from __future__ import annotations

import argparse
import os

from dclip_tpu_torch.data.karpathy import prepare_karpathy_json

SPLITS = {"flickr30k": ["train", "val", "test"], "coco": ["train", "val", "test", "restval"]}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Prepare Karpathy split JSONs")
    p.add_argument("--datasets", choices=["coco", "flickr30k", "both"], default="both")
    p.add_argument("--coco_dir", default=None, help="COCO root (train2014/val2014 subdirs)")
    p.add_argument("--flickr_dir", default=None, help="Flickr30K images dir")
    p.add_argument("--karpathy_json", default=None,
                   help="path to dataset_<name>.json (single-dataset runs)")
    p.add_argument("--karpathy_dir", default=None,
                   help="dir containing <name>/dataset_<name>.json (both)")
    p.add_argument("--output_dir", default="data")
    p.add_argument("--split", default="all",
                   help='"all" or one of train/val/test (+restval for coco)')
    p.add_argument("--download", action="store_true",
                   help="materialize dataset_<name>.json into --data_dir "
                        "by downloading + extracting the cs.stanford.edu "
                        "zip (requires --allow_network; cached zips are "
                        "reused)")
    p.add_argument("--allow_network", action="store_true",
                   help="permit the --download fetch (zero-egress default)")
    p.add_argument("--data_dir", default=os.path.join("data", "karpathy"),
                   help="zip cache / extraction dir for --download")
    return p


def _json_path(args, name):
    if args.download:
        from dclip_tpu_torch.data.fetch import download_karpathy_split

        return download_karpathy_split(name, args.data_dir, allow_network=args.allow_network)
    if args.karpathy_json:
        return args.karpathy_json
    if args.karpathy_dir:
        return os.path.join(args.karpathy_dir, name, f"dataset_{name}.json")
    raise SystemExit("provide --karpathy_json/--karpathy_dir, or --download")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.datasets == "both" and args.karpathy_json:
        raise SystemExit("--karpathy_json is single-dataset; with --datasets both use "
                         "--karpathy_dir (containing <name>/dataset_<name>.json)")
    os.makedirs(args.output_dir, exist_ok=True)
    todo = ["coco", "flickr30k"] if args.datasets == "both" else [args.datasets]
    for name in todo:
        image_dir = args.coco_dir if name == "coco" else args.flickr_dir
        if not image_dir:
            print(f"Skipping {name}: no image dir given")
            continue
        splits = SPLITS[name] if args.split == "all" else [args.split]
        for split in splits:
            out = os.path.join(args.output_dir, f"{name}_{split}.json")
            prepare_karpathy_json(name, image_dir, _json_path(args, name), out, split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
