"""Dynamic request batching for serving.

A copy of `dclip_tpu/serve/batcher.py` (pure Python, no device code). It
is copied, not imported, because `dclip_tpu/serve/__init__.py` imports the
JAX service and exporter.

The GPU, like the TPU, is used best by large batches; individual serving
requests arrive small and asynchronous. The
batcher bridges the two: callers block in `submit()` while a single
worker thread drains the queue into batches of up to `max_batch` items
(waiting at most `max_wait_s` for stragglers once the first item is in
hand) and runs them through one `run_batch` call.

Guarantees:
- results map back to callers in submission order within a batch;
- an exception inside `run_batch` propagates to every caller of that
  batch (and only that batch);
- `close()` drains nothing: queued requests fail fast with
  `RuntimeError`, in-flight batches finish.

New capability vs the reference (serving did not exist there).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item: Any):
        self.item = item
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    def __init__(
        self,
        run_batch: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 64,
        max_wait_s: float = 0.005,
        name: str = "batcher",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.name = name
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        # stats
        self._n_requests = 0
        self._n_batches = 0
        self._n_items = 0
        self._latency_sum = 0.0
        self._latency_max = 0.0
        self._worker = threading.Thread(
            target=self._loop, name=f"{name}-worker", daemon=True
        )
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, item: Any, timeout: Optional[float] = None) -> Any:
        """Enqueue one item and block until its result is ready."""
        t0 = time.perf_counter()
        p = _Pending(item)
        with self._wake:
            if self._closed:
                raise RuntimeError(f"{self.name} is closed")
            self._queue.append(p)
            self._n_requests += 1
            self._wake.notify()
        if not p.event.wait(timeout):
            raise TimeoutError(f"{self.name}: no result within {timeout}s")
        if p.error is not None:
            raise p.error
        with self._lock:
            lat = time.perf_counter() - t0
            self._latency_sum += lat
            self._latency_max = max(self._latency_max, lat)
        return p.result

    def submit_many(
        self, items: Sequence[Any], timeout: Optional[float] = None
    ) -> List[Any]:
        """Enqueue all items at once (they may share a batch with other
        callers') and block until every result is ready, in order."""
        t0 = time.perf_counter()
        pending = [_Pending(it) for it in items]
        with self._wake:
            if self._closed:
                raise RuntimeError(f"{self.name} is closed")
            self._queue.extend(pending)
            self._n_requests += len(pending)
            self._wake.notify()
        deadline = None if timeout is None else time.monotonic() + timeout
        for p in pending:
            remaining = None if deadline is None else deadline - time.monotonic()
            if not p.event.wait(remaining):
                raise TimeoutError(f"{self.name}: no result within {timeout}s")
            if p.error is not None:
                raise p.error
        with self._lock:
            lat = time.perf_counter() - t0
            self._latency_sum += lat * len(pending)
            self._latency_max = max(self._latency_max, lat)
        return [p.result for p in pending]

    def stats(self) -> dict:
        with self._lock:
            done = self._n_items
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "items": done,
                "mean_batch_size": (
                    done / self._n_batches if self._n_batches else 0.0
                ),
                "mean_latency_s": (
                    self._latency_sum / done if done else 0.0
                ),
                "max_latency_s": self._latency_max,
            }

    def close(self) -> None:
        with self._wake:
            if self._closed:
                return
            self._closed = True
            err = RuntimeError(f"{self.name} is closed")
            for p in self._queue:
                p.error = err
                p.event.set()
            self._queue.clear()
            self._wake.notify()
        self._worker.join(timeout=5.0)

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side -------------------------------------------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until work exists, then linger up to max_wait_s for more."""
        with self._wake:
            while not self._queue and not self._closed:
                self._wake.wait()
            if self._closed:
                return None
            deadline = time.monotonic() + self.max_wait_s
            while (
                len(self._queue) < self.max_batch
                and not self._closed
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._wake.wait(remaining):
                    break
            batch = self._queue[: self.max_batch]
            del self._queue[: len(batch)]
            return batch or None

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                results = self._run_batch([p.item for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"{self.name}: run_batch returned {len(results)} "
                        f"results for {len(batch)} items"
                    )
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:  # noqa: BLE001 — must reach callers
                for p in batch:
                    p.error = e
            finally:
                with self._lock:
                    self._n_batches += 1
                    self._n_items += len(batch)
                for p in batch:
                    p.event.set()
