"""Karpathy retrieval-split JSON builder (a copy of
`dclip_tpu/data/karpathy.py`; host JSON only, no torch).

The eval JSON is a list of `{"image_path", "image_id", "captions": [...]}`
records, with the published split-size warnings (Flickr30k test / val
1000, train 29000; COCO test / val 5000, train 113287, restval 30504) and
COCO's subdirectory by filename prefix. The Karpathy `dataset_*.json` must
already be on disk: nothing is fetched.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

EXPECTED_COUNTS = {
    "flickr30k": {"test": 1000, "val": 1000, "train": 29000},
    "coco": {"test": 5000, "val": 5000, "train": 113287, "restval": 30504},
}


def _coco_subdir(filename: str) -> Optional[str]:
    if "COCO_train2014_" in filename:
        return "train2014"
    if "COCO_val2014_" in filename:
        return "val2014"
    return None


def prepare_karpathy_json(dataset: str, image_dir: str, karpathy_json_path: str,
                          output_json: Optional[str], split: str = "test",
                          require_exists: bool = True) -> List[dict]:
    """Build the eval JSON for one split of 'flickr30k' or 'coco'."""
    if dataset not in EXPECTED_COUNTS:
        raise ValueError(f"Unsupported dataset: {dataset}. Must be 'flickr30k' or 'coco'")
    with open(karpathy_json_path, encoding="utf-8") as f:
        karpathy = json.load(f)

    out: List[dict] = []
    images_not_found = 0
    for img in karpathy["images"]:
        if img["split"] != split:
            continue
        if dataset == "coco":
            subdir = _coco_subdir(img["filename"])
            if subdir is None:
                print(f"Unknown image format: {img['filename']}, skipping...")
                continue
            image_path = os.path.join(image_dir, subdir, img["filename"])
        else:
            image_path = os.path.join(image_dir, img["filename"])
        if require_exists and not os.path.exists(image_path):
            images_not_found += 1
            if images_not_found <= 5:
                print(f"Warning: Image not found: {image_path}")
            continue
        out.append({"image_path": image_path, "image_id": img["imgid"],
                    "captions": [s["raw"] for s in img["sentences"]]})
    if images_not_found > 5:
        print(f"... and {images_not_found - 5} more missing images")

    if output_json:
        os.makedirs(os.path.dirname(os.path.abspath(output_json)), exist_ok=True)
        with open(output_json, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2)

    n_caps = sum(len(e["captions"]) for e in out)
    print(f"Created {dataset} {split} split JSON with {len(out)} images and {n_caps} captions")
    expected = EXPECTED_COUNTS[dataset].get(split)
    if expected is not None and len(out) != expected:
        print(f"Warning: Expected {expected} images for {split} split, but found {len(out)}")
    return out
