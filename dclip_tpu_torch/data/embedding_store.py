"""Append-only embedding store with npz and `.dcs` persistence.

A copy of `dclip_tpu/data/embedding_store.py`, with `device_arrays` as
torch tensors on a device (the service keeps its index's keys there
across searches). It is copied, not imported, because
`dclip_tpu/data/__init__.py` imports jax. `.dcs` files go through the
port's copy of the native runtime (`dclip_tpu_torch.native`), which keeps
the JAX package's file layout, so both packages read each other's stores.

The store replaces the reference's FAISS `IndexFlatIP(512)` + JSON
sidecars: one `[N, D]` float32 key matrix (+ values and positions), keys
L2-normalized on add; persistence is one atomic npz (no pickle) or the
native mmap KV store.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np


class EmbeddingStore:
    """Append-only store of (key embedding, value embedding, position, id)."""

    def __init__(self, dim: int = 512):
        self.dim = dim
        self._keys: List[np.ndarray] = []
        self._values: List[np.ndarray] = []
        self._positions: List[np.ndarray] = []
        self._ids: List[str] = []
        self._values_are_keys = True  # no value given: pack one matrix for both
        self._packed: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    def __len__(self) -> int:
        return len(self._ids)

    def add(
        self,
        patch_id: str,
        key: np.ndarray,
        value: Optional[np.ndarray] = None,
        position: Optional[Sequence[float]] = None,
    ) -> None:
        """Add one entry; key is L2-normalized like compute_faiss.py:44-48."""
        key = np.asarray(key, np.float32).reshape(-1)
        if key.shape[0] != self.dim:
            raise ValueError(f"key dim {key.shape[0]} != store dim {self.dim}")
        norm = np.linalg.norm(key)
        key = key / max(norm, 1e-12)
        self._keys.append(key)
        if value is None:
            self._values.append(key)
        else:
            self._values.append(np.asarray(value, np.float32).reshape(-1))
            self._values_are_keys = False
        self._positions.append(
            np.zeros(4, np.float32)
            if position is None
            else np.asarray(position, np.float32).reshape(4)
        )
        self._ids.append(patch_id)
        self._packed = None

    def add_batch(
        self,
        ids: Sequence[str],
        keys: np.ndarray,
        values: Optional[np.ndarray] = None,
        positions: Optional[np.ndarray] = None,
    ) -> None:
        for i, pid in enumerate(ids):
            self.add(
                pid,
                keys[i],
                None if values is None else values[i],
                None if positions is None else positions[i],
            )

    # -- packed views ---------------------------------------------------------

    def _pack(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._packed is None:
            if self._ids:
                keys = np.stack(self._keys)
                values = keys if self._values_are_keys else np.stack(self._values)
                self._packed = (keys, values, np.stack(self._positions))
            else:
                z = np.zeros((0, self.dim), np.float32)
                self._packed = (z, z.copy(), np.zeros((0, 4), np.float32))
        return self._packed

    @property
    def keys(self) -> np.ndarray:
        return self._pack()[0]

    @property
    def values(self) -> np.ndarray:
        return self._pack()[1]

    @property
    def positions(self) -> np.ndarray:
        return self._pack()[2]

    @property
    def ids(self) -> List[str]:
        return list(self._ids)

    def device_arrays(self, device, mesh=None):
        """(keys, values) as f32 tensors on `device`, to be reused across
        queries (`dclip_tpu/data/embedding_store.py:113-124`). A store whose
        values are its keys moves one matrix and returns it twice. With a
        `parallel.mesh.Mesh`, this rank's row shard [r N / size,
        (r + 1) N / size) for `ops.knn.knn_search_sharded` (pad N to a
        multiple of the size first: `pad_to_multiple`)."""
        import torch

        keys, values, _ = self._pack()
        if mesh is not None:
            lo, hi = mesh.rows(len(keys))
            same = values is keys
            keys = keys[lo:hi]
            values = keys if same else values[lo:hi]
        keys_t = torch.as_tensor(keys, dtype=torch.float32, device=device)
        if values is keys:
            return keys_t, keys_t
        return keys_t, torch.as_tensor(values, dtype=torch.float32, device=device)

    @classmethod
    def from_arrays(cls, keys: np.ndarray, values: Optional[np.ndarray] = None,
                    positions: Optional[np.ndarray] = None,
                    ids: Optional[Sequence[str]] = None) -> "EmbeddingStore":
        """A store holding these rows as given (keys are not renormalized,
        as `load` does not): keys and values [N, D], positions [N, 4], ids
        (default "0", "1", ...)."""
        keys = np.asarray(keys, np.float32)
        n = keys.shape[0]
        values = keys if values is None else np.asarray(values, np.float32)
        positions = (np.zeros((n, 4), np.float32) if positions is None
                     else np.asarray(positions, np.float32))
        store = cls(dim=keys.shape[1])
        store._keys, store._values, store._positions = list(keys), list(values), list(positions)
        store._ids = [str(i) for i in range(n)] if ids is None else list(ids)
        store._values_are_keys = values is keys
        store._packed = (keys, values, positions)
        return store

    def pad_to_multiple(self, multiple: int) -> "EmbeddingStore":
        """Pad rows with sentinels so N divides a mesh axis
        (`dclip_tpu/data/embedding_store.py:188`): zero keys and values
        (inner product 0 with any unit query, never above a positive
        threshold), ids "<pad>"; pass the real count as `n_valid` to
        `knn_search_sharded`. A store that divides already is returned."""
        n = len(self)
        pad = (-n) % multiple
        if pad == 0:
            return self
        keys, values, positions = self._pack()
        z = np.zeros((pad, self.dim), np.float32)
        return EmbeddingStore.from_arrays(
            np.concatenate([keys, z]), None if values is keys else np.concatenate([values, z]),
            np.concatenate([positions, np.zeros((pad, 4), np.float32)]),
            ids=self._ids + ["<pad>"] * pad)

    # -- persistence ------------------------------------------------------------

    def save(self, path: str) -> None:
        keys, values, positions = self._pack()
        if path.endswith(".dcs"):
            from dclip_tpu_torch import native

            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
            with native.NativeKVStore(path, writable=True) as s:
                s.put("dim", str(self.dim).encode())
                s.put("ids", json.dumps(self._ids).encode())
                s.put_array("keys", keys)
                s.put_array("values", values)
                s.put_array("positions", positions)
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(
                    f,
                    dim=np.int64(self.dim),
                    keys=keys,
                    values=values,
                    positions=positions,
                    ids=json.dumps(self._ids),
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "EmbeddingStore":
        names = ("keys", "values", "positions")
        if path.endswith(".dcs"):
            from dclip_tpu_torch import native

            s = native.NativeKVStore(path)
            try:
                ids = json.loads(s.get("ids").decode())
                arrays = [s.get_array(k) for k in names]
            finally:
                s.close()
        else:
            with np.load(path, allow_pickle=False) as z:
                ids = json.loads(str(z["ids"]))
                arrays = [z[k] for k in names]
        return cls.from_arrays(*arrays, ids=ids)
