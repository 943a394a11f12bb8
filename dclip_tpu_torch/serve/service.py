"""Bucket-padded CLIP encoding service on one device.

Counterpart of `dclip_tpu/serve/service.py`. Requests are padded up to a
small set of batch buckets. PyTorch does not recompile per shape, but the
buckets keep the set of shapes the kernels see bounded and keep the
service's padding-invariance contract: a request's embedding does not
depend on what else shares its batch.

Text requests go raw string -> tokenizer -> [B, 77] ids; image requests
take uint8 RGB arrays, resize/crop them on the host in uint8 and ship the
uint8 bytes to the device, where rescale and CLIP normalization run. The
image tower takes `models.encoding.image_route`, the JAX service's rule
(`dclip_tpu/serve/service.py:96-118`): a bf16 model on CUDA runs the
hand-written block kernels (`kernels.vit_block.fused_image_features`,
K1 / K2) over weights packed once at construction; any other (f32, or on
the CPU) runs the module path. `quantize="int8"` serves both towers from
int8 weights instead (`serve.quant`, `dclip_tpu/serve/service.py:120-141`):
the quantized tree replaces the float weights and is moved to the device
once, here. Embeddings come back f32 and L2-normalized.

An optional in-memory retrieval index (`data.embedding_store
.EmbeddingStore` + `ops.knn.knn_search` on the device) turns the service
into a text->image search endpoint. The index's keys stay on the device
between searches: the first search after an add copies them there once
(with a snapshot of the ids), later searches copy nothing.

With a `parallel.mesh.Mesh` of several ranks (`mesh=`, the data axis of a
`torch.distributed` group; `dclip_tpu/serve/service.py:54-83, 153-169,
288-310, 365-377`) the service is one of the ranks, and its encode, search
and warm-up methods are collective: every rank calls them in the same
order with the same arguments (`serve.fanout` carries rank 0's requests to
the others). Global rank 0's weights are broadcast to every rank at
construction, before any packing or quantization. Each padded bucket of b
rows is split into b / size rows a rank by data index, each rank runs its
rows through its own route (the kernels on every rank: JAX demotes its
fused kernels to XLA on a mesh, the port does not), and the rows are
all-gathered, so every rank returns the whole result. The index's host
store is kept whole on every rank; a search pads it to a multiple of the
size, keeps this rank's row shard on the device and runs
`ops.knn.knn_search_sharded` with the real row count, under the lock.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dclip_tpu_torch.core.device import resolve_device
from dclip_tpu_torch.data.embedding_store import EmbeddingStore
from dclip_tpu_torch.models.encoding import image_forward, image_route
from dclip_tpu_torch.ops.image_ops import normalize as clip_normalize
from dclip_tpu_torch.ops.knn import knn_search, knn_search_sharded
from dclip_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_,
    collective_device,
    gather_cat,
    local_mesh,
)
from dclip_tpu_torch.serve import quant

DEFAULT_BUCKETS = (1, 4, 16, 64)


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; callers chunk by max(buckets) first."""
    if n < 1:
        raise ValueError(f"batch must be >= 1, got {n}")
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds the largest bucket {max(buckets)}")


def normalized(emb: torch.Tensor) -> torch.Tensor:
    """f32 rows scaled to unit L2 norm (the served embeddings)."""
    emb = emb.float()
    return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class ClipService:
    def __init__(
        self,
        model,
        cfg,
        tokenizer=None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        normalize: bool = True,
        index_dim: Optional[int] = None,
        quantize: Optional[str] = None,
        mesh=None,
        index: Optional[EmbeddingStore] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        """`model`: a `models.clip.CLIPModule` holding its weights (its
        `dtype` is the compute dtype). It is moved to `device` once, here,
        and, on the kernels' route, the image tower's weights are packed
        once. With `quantize="int8"` its weights are quantized on the host
        and only the int8 tree (`self.params`) goes to the device; the
        service then holds no float model (`self.model` is None).

        `mesh`: None, or a `parallel.mesh.Mesh` with a data axis only
        (module docstring). With more than one rank every bucket must
        divide by the data size, as in JAX. Constructing the service is
        then collective too: it broadcasts global rank 0's weights into
        `model`."""
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.buckets = tuple(sorted(buckets))
        self.mesh = _checked_mesh(mesh, self.buckets)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.normalize = normalize
        self.quantize = quantize
        self._lock = threading.Lock()  # encode calls + index mutations
        _replicate(model, self.mesh)
        if quantize == "int8":
            self.model = None
            self.params = quant.to_device(quant.quantize_clip(model, cfg), self.device)
            self.image_route = "int8"
            self._text_fn = functools.partial(quant.quantized_text_features, cfg, self.params)
            self._image_fn = functools.partial(quant.quantized_image_features, cfg, self.params)
        else:
            self.model = model.to(self.device).eval()
            self.image_route = image_route(self.device, self.model.dtype)
            self._text_fn = self.model.get_text_features
            self._image_fn = image_forward(self.model)

        self._index = None
        # The index's keys on the device and its ids, built by the first
        # search after an add and dropped by the next add (under _lock).
        self._index_keys: Optional[torch.Tensor] = None  # this rank's shard over a mesh
        self._index_ids: Optional[List[str]] = None
        if index is not None:
            if index_dim is not None and index.dim != index_dim:
                raise ValueError(f"index dim {index.dim} != index_dim {index_dim}")
            if index_dim is None and index.dim != cfg.projection_dim:
                raise ValueError(
                    f"preloaded index dim {index.dim} != model projection "
                    f"dim {cfg.projection_dim}; was it built with a "
                    f"different preset?"
                )
            self._index = index
        elif index_dim is not None:
            self._index = EmbeddingStore(dim=index_dim)

    def _maybe_normalize(self, emb: torch.Tensor) -> torch.Tensor:
        return normalized(emb) if self.normalize else emb.float()

    # -- encoding ----------------------------------------------------------
    # inference_mode sits inside these methods: grad mode is thread-local,
    # and DynamicBatcher calls them from its worker thread.

    def _text_batch(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(self.device)
            mask_t = torch.from_numpy(mask).to(self.device)
            emb = self._text_fn(ids_t, mask_t)
            return self._maybe_normalize(emb).cpu().numpy()

    def _image_batch(self, pixels_u8: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            px = torch.from_numpy(pixels_u8).to(self.device)
            px = clip_normalize(px.float() / 255.0)
            emb = self._image_fn(px)
            return self._maybe_normalize(emb).cpu().numpy()

    def _sharded(self, batch_fn, *arrays: np.ndarray) -> np.ndarray:
        """`batch_fn` over a padded bucket: over a mesh of several ranks on
        this rank's rows (`Mesh.rows`), all-gathered in rank order."""
        if not self.mesh.distributed:
            return batch_fn(*arrays)
        lo, hi = self.mesh.rows(arrays[0].shape[0])
        mine = torch.from_numpy(batch_fn(*(a[lo:hi] for a in arrays)))
        return gather_cat(mine.to(collective_device(self.mesh)), self.mesh).cpu().numpy()

    def tokenize(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """[N] strings -> ([N, T] ids, [N, T] mask), the host half of
        `encode_texts`."""
        if self.tokenizer is None:
            raise RuntimeError("ClipService built without a tokenizer")
        return self.tokenizer.encode_batch(list(texts), max_length=self.cfg.text.max_length)

    def encode_tokens(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """[N, T] ids and mask -> [N, projection_dim]; collective over a mesh."""
        return self._run_bucketed(
            len(ids),
            lambda lo, hi, b: self._sharded(
                self._text_batch, _pad_rows(ids[lo:hi], b), _pad_rows(mask[lo:hi], b)
            ),
        )

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[N] strings -> [N, projection_dim] (L2-normalized by default)."""
        if self.tokenizer is None:
            raise RuntimeError("ClipService built without a tokenizer")
        if len(texts) == 0:
            return np.zeros((0, self.cfg.projection_dim), np.float32)
        return self.encode_tokens(*self.tokenize(texts))

    def prepare_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """[N] uint8 RGB HWC arrays (any sizes) -> [N, S, S, 3] uint8 at the
        tower's geometry, the host half of `encode_images`."""
        from dclip_tpu_torch.data.pipeline import resize_crop_uint8

        size = self.cfg.vision.image_size

        def _prep(im):
            im = np.asarray(im, np.uint8)
            if im.shape == (size, size, 3):
                return im  # already target geometry — no PIL round-trip
            from PIL import Image

            return resize_crop_uint8(Image.fromarray(im), size)

        if len(images) == 0:
            return np.zeros((0, size, size, 3), np.uint8)
        return np.stack([_prep(im) for im in images])

    def encode_pixels(self, pixels: np.ndarray) -> np.ndarray:
        """[N, S, S, 3] uint8 -> [N, projection_dim]; collective over a mesh."""
        return self._run_bucketed(
            len(pixels),
            lambda lo, hi, b: self._sharded(self._image_batch, _pad_rows(pixels[lo:hi], b)),
        )

    def encode_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """[N] uint8 RGB HWC arrays (any sizes) -> [N, projection_dim]."""
        return self.encode_pixels(self.prepare_images(images))

    def _run_bucketed(self, n: int, run_chunk) -> np.ndarray:
        """Chunk [0, n) by the largest bucket, pad each chunk up to its
        bucket, run, and strip the padding."""
        if n == 0:
            return np.zeros((0, self.cfg.projection_dim), np.float32)
        out = []
        step = max(self.buckets)
        with self._lock:
            for lo in range(0, n, step):
                hi = min(lo + step, n)
                b = pad_to_bucket(hi - lo, self.buckets)
                out.append(run_chunk(lo, hi, b)[: hi - lo])
        return np.concatenate(out, axis=0)

    def warmup(self) -> Dict[str, float]:
        """Run every bucket once for both modalities; returns seconds per
        (modality, bucket), each ending in a device-to-host copy.
        Collective over a mesh."""
        timings = {}
        size = self.cfg.vision.image_size
        for b in self.buckets:
            t0 = time.perf_counter()
            ids = np.full((b, self.cfg.text.max_length), 1, np.int32)
            mask = np.ones((b, self.cfg.text.max_length), np.int32)
            with self._lock:
                self._sharded(self._text_batch, ids, mask)
            timings[f"text/{b}"] = round(time.perf_counter() - t0, 3)
            t0 = time.perf_counter()
            with self._lock:
                self._sharded(self._image_batch, np.zeros((b, size, size, 3), np.uint8))
            timings[f"image/{b}"] = round(time.perf_counter() - t0, 3)
        return timings

    # -- retrieval index ---------------------------------------------------

    @property
    def index_size(self) -> int:
        return 0 if self._index is None else len(self._index)

    def add_to_index(self, ids: Sequence[str], embeddings: np.ndarray) -> None:
        if self._index is None:
            raise RuntimeError("ClipService built without index_dim")
        with self._lock:
            self._index.add_batch(list(ids), np.asarray(embeddings))
            self._index_keys = self._index_ids = None

    def index_images(self, ids: Sequence[str], images: Sequence[np.ndarray]) -> None:
        self.add_to_index(ids, self.encode_images(images))

    def search_texts(self, texts: Sequence[str], k: int = 5) -> List[List[Tuple[str, float]]]:
        """Text queries -> top-k (id, score) over the image index."""
        return self.search(self.encode_texts(texts), k)

    def search(self, queries: np.ndarray, k: int = 5) -> List[List[Tuple[str, float]]]:
        """[Q, D] queries -> top-k (id, score) over the index; collective
        over a mesh."""
        if self._index is None:
            raise RuntimeError("ClipService built without index_dim")
        # Snapshot under the lock: the device keys and ids are rebuilt
        # lazily, and a concurrent add must not be lost behind a stale copy.
        # Both are replaced, never written, so on one rank K12 runs outside
        # the lock; over a mesh the search is a collective and stays inside
        # it, in the order of the other collectives.
        with self._lock:
            if len(self._index) == 0:
                return [[] for _ in range(len(queries))]
            if self._index_keys is None:
                store = self._index.pad_to_multiple(self.mesh.size)
                self._index_keys, _ = store.device_arrays(
                    self.device, self.mesh if self.mesh.distributed else None)
                self._index_ids = self._index.ids
            keys, ids = self._index_keys, self._index_ids
            if self.mesh.distributed:
                return self._top_k(queries, k, keys, ids)
        return self._top_k(queries, k, keys, ids)

    def _top_k(self, queries, k, keys, ids) -> List[List[Tuple[str, float]]]:
        if len(queries) == 0:
            return []
        with torch.inference_mode():
            q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
            k = min(k, len(ids))
            if self.mesh.distributed:
                scores, idx = knn_search_sharded(q, keys, self.mesh, k, n_valid=len(ids))
            else:
                scores, idx = knn_search(q, keys, k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return [
            [(ids[j], float(s)) for j, s in zip(row_i, row_s)]
            for row_i, row_s in zip(idx, scores)
        ]

    def stats(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "index_size": self.index_size,
            "projection_dim": self.cfg.projection_dim,
            "quantize": self.quantize,
            "device": str(self.device),
            "mesh": self.mesh.shape,
        }


def _checked_mesh(mesh, buckets: Sequence[int]) -> Mesh:
    """The service's mesh (the one-rank mesh for None), refused as JAX's
    service refuses it: buckets that do not divide the data size. The JAX
    service is data-parallel only, so a model axis is refused too."""
    if mesh is None:
        return local_mesh()
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh or None, got {type(mesh).__name__}")
    if mesh.model_size > 1:
        raise ValueError(f"ClipService serves over a data axis only; mesh {mesh.shape} has a "
                         "model axis")
    if mesh.size > 1:
        bad = [b for b in buckets if b % mesh.size]
        if bad:
            raise ValueError(
                f"buckets {bad} do not divide the mesh data size "
                f"{mesh.size}; pick multiples so every padded batch "
                f"shards evenly"
            )
    return mesh


@torch.no_grad()
def _replicate(model, mesh: Mesh) -> None:
    """Global rank 0's weights into `model` on every rank of `mesh` (gloo
    takes the CPU's and the card's tensors; under NCCL a CPU tensor goes
    through a copy on the card)."""
    if not mesh.distributed:
        return
    dev = collective_device(mesh)
    tensors = [t.data for t in list(model.parameters()) + list(model.buffers())]
    staged = [t if t.device == dev or dev.type == "cpu" else t.to(dev) for t in tensors]
    broadcast_(staged, mesh)
    for t, buf in zip(tensors, staged):
        if buf is not t:
            t.copy_(buf)


def _pad_rows(a: np.ndarray, b: int) -> np.ndarray:
    if a.shape[0] == b:
        return a
    pad = np.zeros((b - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)
