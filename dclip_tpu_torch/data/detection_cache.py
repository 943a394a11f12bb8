"""Detection cache: the offline detector's boxes, fixed-shape at read time
(host numpy, copied from `dclip_tpu/data/detection_cache.py:35-219`).

image_path -> (boxes [N, 4] xyxy pixels, conf [N]). Storage is one `.npz`
(packed arrays, offsets and the key list; written tmp + rename) or, for a
`.dcs` path, the native mmap KV store. The npz layout is the JAX
package's, so both packages read one file. `get_fixed` pads / truncates
every image to `max_patches` slots, confidence-descending, with a
validity mask: the static shapes the teacher takes.

The detector is a plugin, any `detect_fn(image_rgb_uint8) -> (boxes,
conf)`; `GridProposalDetector` (whole image, center, quadrants) is the
built-in stand-in, so the pipeline runs without one. `build_cache` needs
PIL (`data.pipeline.require_pil`).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

DetectFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


class GridProposalDetector:
    """Deterministic proposals: full image, center crop, quadrants."""

    def __init__(self, include_quadrants: bool = True):
        self.include_quadrants = include_quadrants

    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        h, w = image.shape[:2]
        boxes = [[0, 0, w, h], [w * 0.25, h * 0.25, w * 0.75, h * 0.75]]
        confs = [0.9, 0.8]
        if self.include_quadrants:
            for qx, qy in ((0, 0), (0.5, 0), (0, 0.5), (0.5, 0.5)):
                boxes.append([w * qx, h * qy, w * (qx + 0.5), h * (qy + 0.5)])
                confs.append(0.5)
        return np.asarray(boxes, np.float32), np.asarray(confs, np.float32)


class DetectionCache:
    """image_path -> (boxes [N,4] xyxy pixel coords, conf [N])."""

    def __init__(self, entries: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None):
        self._entries: Dict[str, Tuple[np.ndarray, np.ndarray]] = entries or {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, path: str) -> bool:
        return path in self._entries

    def get(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        if path in self._entries:
            return self._entries[path]
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)

    def put(self, path: str, boxes: np.ndarray, conf: np.ndarray) -> None:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        conf = np.asarray(conf, np.float32).reshape(-1)
        if boxes.shape[0] != conf.shape[0]:
            raise ValueError(f"{boxes.shape[0]} boxes but {conf.shape[0]} confidences")
        self._entries[path] = (boxes, conf)

    # -- persistence -------------------------------------------------------------

    def save(self, path: str) -> None:
        """Atomic write: `.dcs` paths into the native KV store (one
        [N, 5] array per image), anything else one packed npz."""
        if path.endswith(".dcs"):
            from dclip_tpu_torch import native

            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
            with native.NativeKVStore(path, writable=True) as s:
                for k, (boxes, conf) in self._entries.items():
                    s.put_array(k, np.concatenate([boxes, conf[:, None]], 1))
            return
        keys = sorted(self._entries)
        counts = np.asarray([self._entries[k][0].shape[0] for k in keys], np.int64)
        nonempty = bool(keys) and bool(counts.sum())
        boxes = (np.concatenate([self._entries[k][0] for k in keys], 0) if nonempty
                 else np.zeros((0, 4), np.float32))
        conf = (np.concatenate([self._entries[k][1] for k in keys], 0) if nonempty
                else np.zeros((0,), np.float32))
        directory = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, keys=json.dumps(keys), counts=counts, boxes=boxes,
                                    conf=conf)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "DetectionCache":
        entries = {}
        if path.endswith(".dcs"):
            from dclip_tpu_torch import native

            store = native.NativeKVStore(path)
            try:
                for k in store.keys():
                    packed = store.get_array(k)
                    entries[k] = (packed[:, :4].copy(), packed[:, 4].copy())
            finally:
                store.close()
            return cls(entries)
        with np.load(path, allow_pickle=False) as z:
            keys = json.loads(str(z["keys"]))
            counts, boxes, conf = z["counts"], z["boxes"], z["conf"]
        off = 0
        for k, n in zip(keys, counts):
            entries[k] = (boxes[off:off + n].copy(), conf[off:off + n].copy())
            off += int(n)
        return cls(entries)

    # -- fixed-shape read path ----------------------------------------------------

    def get_fixed(self, paths: Sequence[str], max_patches: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(boxes [B, P, 4], conf [B, P], mask [B, P]): detections sorted by
        confidence, descending (stable), cut to `max_patches`; short rows
        zero-padded with mask 0."""
        b = len(paths)
        out_boxes = np.zeros((b, max_patches, 4), np.float32)
        out_conf = np.zeros((b, max_patches), np.float32)
        out_mask = np.zeros((b, max_patches), np.float32)
        for i, p in enumerate(paths):
            boxes, conf = self.get(p)
            if boxes.shape[0] == 0:
                continue
            order = np.argsort(-conf, kind="stable")[:max_patches]
            n = len(order)
            out_boxes[i, :n] = boxes[order]
            out_conf[i, :n] = conf[order]
            out_mask[i, :n] = 1.0
        return out_boxes, out_conf, out_mask


def build_cache(image_paths: Sequence[str], detect_fn: DetectFn,
                output_path: Optional[str] = None,
                existing: Optional[DetectionCache] = None) -> DetectionCache:
    """One detection pass over the unique existing image paths not yet in
    the cache; saved to `output_path` when given."""
    from dclip_tpu_torch.data.pipeline import require_pil

    Image = require_pil()
    cache = existing or DetectionCache()
    for p in (p for p in dict.fromkeys(image_paths) if p not in cache):
        if not os.path.exists(p):
            continue
        with Image.open(p) as im:
            arr = np.asarray(im.convert("RGB"))
        boxes, conf = detect_fn(arr)
        cache.put(p, boxes, conf)
    if output_path:
        cache.save(output_path)
    return cache


def cache_path_for(json_file: str, kind: str = "precache", cache_dir: str = "cache") -> str:
    """`<cache_dir>/<json-stem>_<kind>.npz`, the reference's naming."""
    stem = os.path.splitext(os.path.basename(json_file))[0]
    return os.path.join(cache_dir, f"{stem}_{kind}.npz")


def boxes_from_corpus_item(item: dict) -> Tuple[np.ndarray, np.ndarray]:
    """A corpus item's VG-style `boxes` dicts -> (xyxy [N, 4], conf 1.0 [N])."""
    boxes: List[List[float]] = [[bx["x"], bx["y"], bx["x"] + bx["width"], bx["y"] + bx["height"]]
                                for bx in item.get("boxes", [])]
    arr = np.asarray(boxes, np.float32).reshape(-1, 4)
    return arr, np.ones((arr.shape[0],), np.float32)
