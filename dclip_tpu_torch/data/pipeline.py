"""Host input pipeline: corpus JSON -> fixed-shape numpy batches (copy of
`dclip_tpu/data/pipeline.py:52-520`, host numpy only).

Every image is decoded once per step and feeds both consumers:

- `pixel_values` [B, S, S, 3]: the student's input, PIL-bicubic
  shortest-side resize + center crop + CLIP normalization (HF
  `CLIPProcessor` parity, `preprocess_image`);
- `teacher_pixels` [B, R, R, 3] in [0, 1]: the squash-resized full frame
  whose region crops the teacher takes on the device, with `boxes`
  rescaled into that frame;
- `input_ids` / `attention_mask` [B, T]: a caption drawn per (seed, epoch,
  item);
- `boxes` [B, P, 4] / `conf` [B, P] / `box_mask` [B, P]: detection-cache
  rows, confidence-descending, padded to `max_patches`;
- `index` and `content_key` (an md5 of the image path): the host-side
  identities the trainers' caches key on.

`MultiModalPipeline.epoch(e)` yields `Batch`es in a seeded order: decode
in a thread pool behind a bounded prefetch queue, or with `num_workers >
0` in a spawned process pool that receives a pickled copy of the pipeline
(items, tokenizer and detection cache are plain data; nothing of torch or
CUDA rides along); the item derivation depends only on (seed, epoch,
index), so the worker count never changes the stream. `shard_index` /
`shard_count` split every global batch into equal row ranges. An
unreadable image gives zero tensors, as the JAX pipeline's.

`decode_backend="native"` decodes JPEG files with the port's C++
libjpeg decoder (`native/jpeg_decode.cc`, `native.decode_preprocess`):
one call, the GIL released, so the thread pool scales over cores. The
per-item rule is the JAX pipeline's (`dclip_tpu/data/pipeline.py:
342-373`): a file whose first two bytes are not the JPEG SOI, or that
libjpeg cannot decode to RGB (CMYK, truncated, corrupt), takes the PIL
route. PIL is imported only on that route (`require_pil`), so a corpus of
JPEGs loads on a machine without PIL, and an item that needs PIL there
raises, naming its path. A decoder that cannot be built or loaded raises
when the pipeline is made; it never falls back to PIL. `resize_crop_uint8`
also serves the serving path, `preprocess_image` the eval paths.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from dclip_tpu_torch.data.detection_cache import DetectionCache
from dclip_tpu_torch.ops.image_ops import CLIP_MEAN, CLIP_STD

_CLIP_MEAN_F32 = np.asarray(CLIP_MEAN, np.float32)
_CLIP_STD_F32 = np.asarray(CLIP_STD, np.float32)


def require_pil(what: str = "image preprocessing"):
    """PIL's `Image`, or an ImportError that says what needed it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{what} needs PIL, which this installation lacks; JPEG files decode without it "
            "through decode_backend='native'") from e
    return Image


def resize_crop_uint8(image, size: int = 224) -> np.ndarray:
    """HF CLIPProcessor resize/crop geometry WITHOUT normalization:
    bicubic shortest-side resize + center crop, uint8 [size, size, 3]."""
    Image = require_pil()
    w, h = image.size
    # HF get_resize_output_image_size: shortest edge -> size, long side
    # truncated (int()), not rounded.
    if w <= h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    image = image.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    image = image.crop((left, top, left + size, top + size))
    return np.asarray(image, np.uint8)


def preprocess_image(image, size: int = 224) -> np.ndarray:
    """HF CLIPProcessor-parity preprocessing: bicubic shortest-side resize,
    center crop, rescale 1/255, CLIP mean/std normalize. NHWC float32."""
    arr = resize_crop_uint8(image, size).astype(np.float32) / 255.0
    return (arr - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def squash_resize(image, size: int) -> np.ndarray:
    """The full frame squash-resized to [size, size, 3] in [0, 1] (bilinear)."""
    Image = require_pil()
    return np.asarray(image.resize((size, size), Image.BILINEAR), np.float32) / 255.0


def content_key_for(image_path: str) -> np.int64:
    """A stable per-image identity: the first 8 bytes of md5(path)."""
    import hashlib

    digest = hashlib.md5(str(image_path).encode()).digest()[:8]
    return np.int64(int.from_bytes(digest, "little", signed=True))


@dataclass
class Batch:
    pixel_values: np.ndarray  # [B, S, S, 3] float32, CLIP-normalized
    input_ids: np.ndarray  # [B, T] int32
    attention_mask: np.ndarray  # [B, T] int32
    teacher_pixels: np.ndarray  # [B, R, R, 3] float32 in [0, 1]
    boxes: np.ndarray  # [B, P, 4] float32, xyxy in the teacher_pixels frame
    conf: np.ndarray  # [B, P] float32
    box_mask: np.ndarray  # [B, P] float32
    index: np.ndarray  # [B] int64 corpus indices
    content_key: Optional[np.ndarray] = None  # [B] int64, `content_key_for`

    def as_dict(self) -> Dict[str, np.ndarray]:
        return self.__dict__.copy()


class StarvationMonitor:
    """Prints one line when the consumer waits for data more than
    `threshold` of its wall time past a warm-up, with a suggested
    `--num_workers` (`dclip_tpu/data/pipeline.py:117-188`)."""

    def __init__(self, num_workers: int = 0, warmup_batches: int = 4, threshold: float = 0.3,
                 min_batches: int = 8, fast_decode: bool = False, decode_backend: str = "pil"):
        self.num_workers = num_workers
        self.fast_decode = fast_decode
        self.decode_backend = decode_backend
        self.warmup_batches = warmup_batches
        self.threshold = threshold
        self.min_batches = min_batches
        self.batches = 0
        self.wait_s = self.wall_s = 0.0
        self.items = 0
        self.warned = False

    def record(self, wait_s: float, wall_s: float, n_items: int) -> None:
        self.batches += 1
        if self.batches <= self.warmup_batches:
            return
        self.wait_s += wait_s
        self.wall_s += wall_s
        self.items += n_items

    def check(self, supply_items: int, supply_load_s: float) -> Optional[str]:
        """The warning line (once), or None."""
        if (self.warned or self.batches - self.warmup_batches < self.min_batches
                or self.wall_s <= 0 or self.items == 0):
            return None
        wait_frac = self.wait_s / self.wall_s
        if wait_frac < self.threshold:
            return None
        demand = self.items / max(self.wall_s - self.wait_s, 1e-9)
        supply = supply_items / max(supply_load_s, 1e-9)
        per_worker = supply / max(self.num_workers, 1)
        suggested = max(int(np.ceil(demand / max(per_worker, 1e-9))), 2)
        self.warned = True
        return (f"input pipeline is STARVING the accelerator: waited for data "
                f"{wait_frac * 100:.0f}% of step time (decode supply ~{supply:.0f} img/s vs "
                f"compute demand ~{demand:.0f} img/s). Suggest --num_workers {suggested} "
                f"(currently {self.num_workers})"
                f"{'' if self.fast_decode else _FAST_HINT}"
                f"{'' if self.decode_backend == 'native' else _NATIVE_HINT}.")


_FAST_HINT = " and/or --fast_decode (scaled DCT decode)"
_NATIVE_HINT = " and/or --decode_backend native (C++ decode, GIL-free threads)"

_WORKER_PIPELINE: Optional["MultiModalPipeline"] = None


def _worker_init(pipeline: "MultiModalPipeline") -> None:
    global _WORKER_PIPELINE
    _WORKER_PIPELINE = pipeline


def _worker_load(args):
    idx, epoch = args
    return _WORKER_PIPELINE._load_item(idx, epoch)


class MultiModalPipeline:
    """Deterministic epoch iterator over corpus records."""

    def __init__(self, items: Sequence[dict], tokenizer,
                 detection_cache: Optional[DetectionCache] = None, batch_size: int = 32,
                 max_patches: int = 8, image_size: int = 224, teacher_image_size: int = 224,
                 max_text_tokens: Optional[int] = None, seed: int = 42,
                 drop_remainder: bool = True, num_threads: int = 8, prefetch: int = 4,
                 shuffle: bool = True, num_workers: int = 0, monitor_starvation: bool = True,
                 fast_decode: bool = False, decode_backend: str = "pil", shard_index: int = 0,
                 shard_count: int = 1):
        if decode_backend not in ("pil", "native"):
            raise ValueError(f"decode_backend must be 'pil' or 'native', got {decode_backend!r}")
        if decode_backend == "native":
            from dclip_tpu_torch import native

            native.load_jpeg()  # build now: a missing libjpeg raises here, not mid-epoch
        if shard_count > 1:
            if batch_size % shard_count:
                raise ValueError(f"batch_size {batch_size} not divisible by shard_count "
                                 f"{shard_count}")
            if not 0 <= shard_index < shard_count:
                raise ValueError(f"shard_index {shard_index} out of range")
            if not drop_remainder:
                raise ValueError("shard_count > 1 requires drop_remainder=True (a tail batch "
                                 "cannot be split evenly across processes)")
        self.items = list(items)
        self.tokenizer = tokenizer
        self.cache = detection_cache or DetectionCache()
        self.batch_size = batch_size
        self.max_patches = max_patches
        self.image_size = image_size
        self.teacher_image_size = teacher_image_size
        self.max_text_tokens = max_text_tokens or getattr(tokenizer, "max_length", 77)
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.num_workers = num_workers
        # Scaled DCT decode (PIL draft) for JPEGs: a smaller frame whose
        # shortest side still covers the largest consumer.
        self.fast_decode = fast_decode
        self.decode_backend = decode_backend
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._local_bs = batch_size // shard_count
        self._pool = None
        self._starvation_monitor = (StarvationMonitor(num_workers, fast_decode=fast_decode,
                                                      decode_backend=decode_backend)
                                    if monitor_starvation else None)

    def _get_pool(self):
        """The spawned process pool, made once and reused across epochs
        (spawn, not fork: the parent holds CUDA and profiler threads)."""
        if self._pool is None:
            import multiprocessing as mp

            self._pool = mp.get_context("spawn").Pool(
                self.num_workers, initializer=_worker_init, initargs=(self,))
        return self._pool

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_pool"] = None  # pools are process-local
        return state

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.items)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # -- per item -------------------------------------------------------------------

    def _decode_native(self, path: str):
        """(student, teacher, (w, h)) from the native decoder; the zero
        tensors for a file that cannot be opened or read (PIL could not
        read it either); or None for an item it does not serve: a file
        whose first two bytes are not the JPEG SOI (read no further), or
        bytes libjpeg cannot decode to RGB. The call releases the GIL."""
        from dclip_tpu_torch import native

        try:
            with open(path, "rb") as f:
                head = f.read(2)
                if head != b"\xff\xd8":
                    return None
                data = head + f.read()
        except OSError:
            return self._zero_pixels()
        return native.decode_preprocess(data, self.image_size, self.teacher_image_size,
                                        fast=self.fast_decode, mean=_CLIP_MEAN_F32,
                                        std=_CLIP_STD_F32)

    def _zero_pixels(self):
        """The reference's zero tensors for an unreadable image, with the
        teacher frame as its size."""
        t = self.teacher_image_size
        return (np.zeros((self.image_size, self.image_size, 3), np.float32),
                np.zeros((t, t, 3), np.float32), (t, t))

    def _load_item(self, idx: int, epoch: int) -> dict:
        item = self.items[idx]
        rng = np.random.RandomState((self.seed * 1_000_003 + epoch * 9176 + idx) % (2**31))
        captions = item["captions"]
        caption = captions[rng.randint(len(captions))] if captions else ""
        decoded = (self._decode_native(item["image_path"])
                   if self.decode_backend == "native" else None)
        if decoded is not None:
            pixel_values, teacher_pixels, (w, h) = decoded
        else:
            Image = require_pil(f"{item['image_path']} (not served by the native JPEG decoder)"
                                if self.decode_backend == "native" else "image preprocessing")
            try:
                with Image.open(item["image_path"]) as im:
                    # The box rescale needs the original frame size, read
                    # before draft shrinks the decode.
                    w, h = im.size
                    if self.fast_decode:
                        t = max(self.image_size, self.teacher_image_size)
                        im.draft("RGB", (t, t))  # a no-op for non-JPEGs
                    im = im.convert("RGB")
                    pixel_values = preprocess_image(im, self.image_size)
                    teacher_pixels = squash_resize(im, self.teacher_image_size)
            except Exception:
                pixel_values, teacher_pixels, (w, h) = self._zero_pixels()
        boxes, conf, mask = self.cache.get_fixed([item["image_path"]], self.max_patches)
        boxes, conf, mask = boxes[0], conf[0], mask[0]
        sx = self.teacher_image_size / max(w, 1)
        sy = self.teacher_image_size / max(h, 1)
        boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)
        ids, amask = self.tokenizer.encode(caption, self.max_text_tokens)
        return {"pixel_values": pixel_values, "teacher_pixels": teacher_pixels, "boxes": boxes,
                "conf": conf, "box_mask": mask, "input_ids": ids, "attention_mask": amask,
                "index": np.int64(idx), "content_key": content_key_for(item["image_path"])}

    # -- epoch iteration --------------------------------------------------------------

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.items))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        return order

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        import time

        order = self._epoch_order(epoch)
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        supply = {"items": 0, "load_s": 0.0}

        def producer():
            # Exceptions go to the consumer and are raised there: a producer
            # that died quietly would cut every epoch short.
            try:
                import contextlib

                with contextlib.ExitStack() as stack:
                    if self.num_workers > 0:
                        proc_pool = self._get_pool()

                        def load(idxs):
                            return proc_pool.map(_worker_load, [(int(i), epoch) for i in idxs])
                    else:
                        pool = stack.enter_context(ThreadPoolExecutor(self.num_threads))

                        def load(idxs):
                            return list(pool.map(lambda i: self._load_item(int(i), epoch), idxs))
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        start = b * self.batch_size + self.shard_index * self._local_bs
                        idxs = order[start:start + self._local_bs]
                        t0 = time.perf_counter()
                        loaded = load(idxs)
                        supply["load_s"] += time.perf_counter() - t0
                        supply["items"] += len(loaded)
                        q.put(self._collate(loaded))
                q.put(None)
            except BaseException as e:  # noqa: BLE001 - forwarded, not swallowed
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        monitor = self._starvation_monitor
        try:
            prev = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                batch = q.get()
                now = time.perf_counter()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                if monitor is not None:
                    monitor.record(now - t0, now - prev, batch.index.shape[0])
                    warning = monitor.check(supply["items"], supply["load_s"])
                    if warning is not None:
                        print(f"MultiModalPipeline: {warning}", flush=True)
                prev = now
                yield batch
        finally:
            stop.set()
            while t.is_alive():  # drain so that the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)

    @staticmethod
    def _collate(items: List[dict]) -> Batch:
        return Batch(**{k: np.stack([i[k] for i in items]) for k in (
            "pixel_values", "input_ids", "attention_mask", "teacher_pixels", "boxes", "conf",
            "box_mask", "index", "content_key")})
