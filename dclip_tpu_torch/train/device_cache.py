"""Device-resident level-0 cache of frozen teacher targets (counterpart
of `dclip_tpu/train/device_cache.py:63-241`).

The host `TeacherTargetCache` would send every cached row over the host
link again on each epoch; this level keeps rows in one device tensor and
serves a hit with a gather (the only upload is a [B] index vector). Keys
map to rows on the host. The buffer grows by doubling up to the byte
budget; past it `evict=False` stops inserting (the best policy for stable
keys scanned in order every epoch) and `evict=True` reuses the oldest
rows first (FIFO; for keys that go stale, like full targets keyed by the
sampled caption). `get` is all-or-nothing per batch, like the host
cache's `get_batch`. The port runs on one device, so the buffer is not
sharded; puts write in place (`index_copy_`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def resolve_device_cache(requested: Optional[bool], host_cache) -> bool:
    """On (when asked, or by default) whenever there is a host cache to
    front; the port is single-process, the only case the JAX gate allows."""
    if host_cache is None:
        return False
    return True if requested is None else bool(requested)


class DeviceTargetCache:
    def __init__(self, row_shape: Sequence[int], dtype: torch.dtype, capacity_bytes: int,
                 device, min_rows: int = 1024, evict: bool = False):
        self.row_shape = tuple(int(s) for s in row_shape)
        self.dtype = dtype
        self.device = torch.device(device)
        row_bytes = int(np.prod(self.row_shape)) * torch.empty((), dtype=dtype).element_size()
        self.capacity_rows = max(int(capacity_bytes // max(row_bytes, 1)), 0)
        self.evict = bool(evict)
        self._min_rows = min_rows
        self._rows: dict = {}  # key -> row; insertion order = FIFO age
        self._free: list = []  # rows of evicted keys, reused before _next
        self._next = 0
        self._buf: Optional[torch.Tensor] = None
        self.hits = self.misses = self.skipped_puts = self.evictions = 0

    def __len__(self) -> int:
        return len(self._rows)

    def _ensure(self, n_new: int) -> bool:
        need = self._next + max(n_new - len(self._free), 0)
        if need > self.capacity_rows:
            return False
        cur = 0 if self._buf is None else self._buf.shape[0]
        if need <= cur:
            return True
        new = min(self.capacity_rows, max(need, cur * 2, self._min_rows))
        grown = torch.zeros((new, *self.row_shape), dtype=self.dtype, device=self.device)
        if self._buf is not None:
            grown[:cur] = self._buf
        self._buf = grown
        return True

    def get(self, keys: Sequence) -> Optional[torch.Tensor]:
        """Gathered [B, *row_shape] device tensor, or None on ANY miss."""
        idx = np.empty(len(keys), np.int64)
        for j, k in enumerate(keys):
            r = self._rows.get(k)
            if r is None:
                self.misses += 1
                return None
            idx[j] = r
        self.hits += 1
        return self._buf.index_select(0, torch.from_numpy(idx).to(self.device))

    def _make_room(self, keys, n_new: int) -> bool:
        spare = (self.capacity_rows - self._next) + len(self._free)
        if n_new <= spare:
            return self._ensure(n_new)
        if not self.evict:
            return False
        batch, victims, need = set(keys), [], n_new - spare
        for k in self._rows:  # oldest first
            if k not in batch:
                victims.append(k)
                if len(victims) == need:
                    break
        if len(victims) < need:  # the batch alone exceeds capacity
            return False
        for k in victims:
            self._free.append(self._rows.pop(k))
        self.evictions += len(victims)
        return self._ensure(n_new)

    def put(self, keys: Sequence, values: torch.Tensor) -> None:
        """Insert [B, *row_shape] values (rows of present keys are
        overwritten); nothing is inserted if the budget cannot hold the
        batch's new keys."""
        new = len({k for k in keys if k not in self._rows})
        if not self._make_room(keys, new):
            self.skipped_puts += 1
            return
        idx = np.empty(len(keys), np.int64)
        for j, k in enumerate(keys):
            r = self._rows.get(k)
            if r is None:
                r = self._free.pop() if self._free else self._next
                if r == self._next:
                    self._next += 1
                self._rows[k] = r
            idx[j] = r
        self._buf.index_copy_(0, torch.from_numpy(idx).to(self.device),
                              values.to(self.device, self.dtype))
