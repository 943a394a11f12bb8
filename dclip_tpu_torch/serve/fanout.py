"""Serving over ranks: rank 0 takes the requests, every rank runs them.

The JAX service is one process that drives every chip of its mesh. The
port runs one process per card, so a `ClipService` over a mesh of several
ranks is collective (`serve.service`): every rank must make the same calls
in the same order. This module carries them. It has no JAX counterpart.

- `lead(service)` (global rank 0) returns a `Lead`, which has the
  service's public methods. A call first does the host work that can fail
  (tokenizing, resizing, checking the arguments) on rank 0, so a bad
  request fails there, before any other rank hears of it, and the next
  request is served. Then, under one lock, it broadcasts one command with
  its arrays (`parallel.mesh.broadcast_request`) and makes the collective
  call. The lock puts the commands of concurrent callers (the HTTP
  threads, both `DynamicBatcher` workers) in one order.
- `follow(service)` is every other rank's loop: it takes each command and
  makes the same call, until `STOP`.
- `Lead.close()` broadcasts `STOP`; the serve CLI calls it on every way
  out.
- While no request comes, the lead broadcasts `PING` every `HEARTBEAT_S`
  seconds, so a follower waiting for the next command never reaches the
  group's timeout (`cli.common.init_multihost`: 600 s), and a dead
  follower is found while idle.

No quiet failure: once a command is broadcast, any error (a collective
that fails, a dead peer) is fatal. The lead keeps the error, refuses every
later call with `GroupFailed`, calls `on_failure` (the CLI stops its
server and exits non-zero), and never serves from rank 0 alone. A follower
that fails raises out of `follow`, and its process exits non-zero.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

STOP, PING = "stop", "ping"
HEARTBEAT_S = 5.0


class GroupFailed(RuntimeError):
    """The group of ranks failed during a command; nothing more is served."""


def _run(service, name: str, objs, arrays: List[np.ndarray]):
    """The collective call of one command, the same on every rank."""
    if name == "encode_texts":
        return service.encode_tokens(*arrays)
    if name == "encode_images":
        return service.encode_pixels(*arrays)
    if name == "add_to_index":
        return service.add_to_index(objs, *arrays)
    if name == "index_images":
        return service.add_to_index(objs, service.encode_pixels(*arrays))
    if name == "search":
        return service.search(arrays[0], objs)
    if name == "search_texts":
        return service.search(service.encode_tokens(*arrays), objs)
    if name == "warmup":
        return service.warmup()
    raise ValueError(f"unknown command {name!r}")


def _receive(service) -> Tuple[str, object, List[np.ndarray]]:
    from dclip_tpu_torch.parallel.mesh import broadcast_request

    (name, objs), arrays = broadcast_request(None, [], service.mesh)
    return name, objs, arrays


def follow(service) -> None:
    """A follower's loop (a rank other than global rank 0): the lead's
    commands until `STOP`. An error raises out of it."""
    if service.mesh.is_primary:
        raise ValueError("global rank 0 leads; follow() runs on the other ranks")
    while True:
        name, objs, arrays = _receive(service)
        if name == STOP:
            return
        if name != PING:
            _run(service, name, objs, arrays)


class Lead:
    """Global rank 0's face of a service over ranks (module docstring)."""

    def __init__(self, service,
                 on_failure: Optional[Callable[[BaseException], None]] = None):
        if not service.mesh.is_primary:
            raise ValueError("lead() runs on global rank 0; the other ranks follow()")
        self.service = service
        self.on_failure = on_failure
        self.failed: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._closed = False
        self._last = time.monotonic()
        self._wake = threading.Event()
        self._beat = None
        if service.mesh.distributed:
            self._beat = threading.Thread(target=self._heartbeat, name="lead-heartbeat",
                                          daemon=True)
            self._beat.start()

    # -- what the service shows ------------------------------------------

    @property
    def cfg(self):
        return self.service.cfg

    @property
    def device(self):
        return self.service.device

    @property
    def quantize(self):
        return self.service.quantize

    @property
    def index_size(self) -> int:
        return self.service.index_size

    def stats(self) -> dict:
        return self.service.stats()

    # -- commands --------------------------------------------------------

    def _command(self, name: str, objs=None, arrays: Sequence[np.ndarray] = ()):
        from dclip_tpu_torch.parallel.mesh import broadcast_request

        with self._lock:
            if self.failed is not None:
                raise GroupFailed(f"the group of ranks failed: {self.failed!r}")
            if self._closed:
                raise RuntimeError("the lead is closed")
            try:
                _, arrays = broadcast_request((name, objs), list(arrays), self.service.mesh)
                out = _run(self.service, name, objs, arrays)
            except BaseException as e:  # noqa: BLE001 — the group is lost either way
                self._fail(e)
                if not isinstance(e, Exception):
                    raise
                raise GroupFailed(f"the group of ranks failed during {name!r}: {e!r}") from e
            finally:
                self._last = time.monotonic()
            return out

    def _fail(self, error: BaseException) -> None:
        self.failed = error
        self._wake.set()
        if self.on_failure is not None:
            self.on_failure(error)

    # An empty request goes to the service itself: it checks what it
    # checks and returns without a collective.

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        texts = list(texts)
        if not texts:
            return self.service.encode_texts(texts)
        return self._command("encode_texts", None, list(self.service.tokenize(texts)))

    def encode_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        if len(images) == 0:
            return self.service.encode_images(images)
        return self._command("encode_images", None, [self.service.prepare_images(images)])

    def _index_ids(self, ids: Sequence[str], n: int) -> list:
        if self.service._index is None:
            raise RuntimeError("ClipService built without index_dim")
        ids = list(ids)
        if len(ids) != n:
            raise ValueError(f"{len(ids)} ids for {n} rows")
        return ids

    def add_to_index(self, ids: Sequence[str], embeddings: np.ndarray) -> None:
        emb = np.asarray(embeddings, np.float32)
        dim = None if self.service._index is None else self.service._index.dim
        ids = self._index_ids(ids, len(emb))
        if emb.ndim != 2 or emb.shape[1] != dim:
            raise ValueError(f"embeddings of shape {emb.shape} for an index of dim {dim}")
        self._command("add_to_index", ids, [emb])

    def index_images(self, ids: Sequence[str], images: Sequence[np.ndarray]) -> None:
        ids = self._index_ids(ids, len(images))
        if self.service._index.dim != self.cfg.projection_dim:
            raise ValueError(f"index dim {self.service._index.dim} != projection dim "
                             f"{self.cfg.projection_dim}")
        self._command("index_images", ids, [self.service.prepare_images(images)])

    def _k(self, k) -> int:
        if self.service._index is None:
            raise RuntimeError("ClipService built without index_dim")
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return k

    def search(self, queries: np.ndarray, k: int = 5) -> List[List[Tuple[str, float]]]:
        k = self._k(k)
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.service._index.dim:
            raise ValueError(f"queries of shape {q.shape} for an index of dim "
                             f"{self.service._index.dim}")
        return self._command("search", k, [q])

    def search_texts(self, texts: Sequence[str], k: int = 5) -> List[List[Tuple[str, float]]]:
        k = self._k(k)
        texts = list(texts)
        if self.service._index.dim != self.cfg.projection_dim:
            raise ValueError(f"index dim {self.service._index.dim} != projection dim "
                             f"{self.cfg.projection_dim}")
        if not texts:
            return self.service.search_texts(texts, k)
        return self._command("search_texts", k, list(self.service.tokenize(texts)))

    def warmup(self) -> dict:
        return self._command("warmup")

    # -- the end ---------------------------------------------------------

    def _heartbeat(self) -> None:
        from dclip_tpu_torch.parallel.mesh import broadcast_request

        while not self._wake.wait(HEARTBEAT_S / 2):
            with self._lock:
                if self._closed or self.failed is not None:
                    return
                if time.monotonic() - self._last < HEARTBEAT_S:
                    continue
                try:
                    broadcast_request((PING, None), [], self.service.mesh)
                except Exception as e:  # noqa: BLE001 — a dead peer ends the group
                    self._fail(e)
                    return
                self._last = time.monotonic()

    def close(self) -> None:
        """Broadcast `STOP` (not after a failure: the group is gone)."""
        from dclip_tpu_torch.parallel.mesh import broadcast_request

        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._wake.set()
            if self.failed is None and self.service.mesh.distributed:
                broadcast_request((STOP, None), [], self.service.mesh)
        if self._beat is not None:
            self._beat.join()

    def __enter__(self) -> "Lead":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def lead(service, on_failure: Optional[Callable[[BaseException], None]] = None) -> Lead:
    """Global rank 0's `Lead` over `service` (module docstring)."""
    return Lead(service, on_failure)


def share_index(store, mesh):
    """Global rank 0's `EmbeddingStore` (or None) on every rank of `mesh`:
    a preloaded index is read on rank 0 only and broadcast, so a follower
    needs no file of its own. Collective; without a group, `store`."""
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.parallel.mesh import broadcast_request

    if not mesh.distributed:
        return store
    if mesh.is_primary and store is not None:
        same = store.values is store.keys
        head = (store.ids, same)
        arrays = [store.keys, store.positions] + ([] if same else [store.values])
    else:
        head, arrays = None, []
    head, arrays = broadcast_request(head, arrays, mesh)
    if head is None:
        return None
    ids, same = head
    keys, positions = arrays[:2]
    return EmbeddingStore.from_arrays(keys, None if same else arrays[2], positions, ids)
