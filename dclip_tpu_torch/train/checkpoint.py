"""Checkpoint manager: step-indexed save and restore, for resume
(counterpart of `dclip_tpu/train/checkpoint.py`).

The same artifact rules as the JAX package: a `checkpoints.json` index
written atomically after each file lands, file names
`<prefix>_epoch{n}_val{loss:.4f}.step{s}.pt` (the reference's
`<prefix>_epoch{n}_val{loss:.4f}` pattern), `save_top_k` retention by the
monitored metric with the latest regular checkpoint always kept, tagged
`.interrupt` / `.error` checkpoints of which only the newest per tag
stays, `latest()`, `best()` and `restore_latest_or_none()`. Writes are
synchronous: the JAX package's `async_writes` mode has no caller.

The format is the port's own: a trainer's state as nested dicts and lists
of plain tensors, numbers and strings, written with `torch.save` and read
with `torch.load(weights_only=True)` (no pickled code). The JAX package's
flax-msgpack checkpoints are not read.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_state(path: str, state: Any) -> None:
    buf = io.BytesIO()
    torch.save(state, buf)
    _atomic_write(path, buf.getvalue())


def restore_state(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """save_top_k retention + best tracking + latest-step resume."""

    INDEX = "checkpoints.json"

    def __init__(self, directory: str, prefix: str = "ckpt", save_top_k: int = 10,
                 monitor: str = "val_loss", mode: str = "min"):
        self.directory = directory
        self.prefix = prefix
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        os.makedirs(directory, exist_ok=True)
        self._index: List[Dict] = []
        self._load_index()

    # -- index ------------------------------------------------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.directory, self.INDEX)

    def _load_index(self) -> None:
        if os.path.exists(self._index_path()):
            with open(self._index_path()) as f:
                self._index = json.load(f)

    def _write_index(self) -> None:
        _atomic_write(self._index_path(), json.dumps(self._index, indent=2).encode())

    # -- save ---------------------------------------------------------------------------

    def save(self, state: Any, step: int, epoch: Optional[int] = None,
             metrics: Optional[Dict[str, float]] = None, tag: Optional[str] = None) -> str:
        """Write one checkpoint; retain top-k by the monitored metric + the latest."""
        metrics = dict(metrics or {})
        name = f"{self.prefix}"
        if epoch is not None:
            name += f"_epoch{epoch}"
        if self.monitor in metrics:
            name += f"_{self.monitor.replace('_loss', '')}{metrics[self.monitor]:.4f}"
        if tag:
            name += f".{tag}"
        name += f".step{step}.pt"
        path = os.path.join(self.directory, name)
        entry = {"path": path, "step": int(step), "epoch": None if epoch is None else int(epoch),
                 "metrics": {k: float(v) for k, v in metrics.items()}, "tag": tag,
                 "time": time.time()}
        save_state(path, state)
        # The index names a file only once it exists on disk; a rerun that
        # reproduces a file name replaces its entry (two entries on one path
        # would let retention delete the survivor's file).
        self._index = [e for e in self._index if e["path"] != path]
        self._index.append(entry)
        self._retain()
        self._write_index()
        return path

    def save_interrupt(self, state: Any, step: int, kind: str = "interrupt") -> str:
        """`.interrupt` / `.error` checkpoints; only the newest per tag stays."""
        keep, dropped = [], []
        for e in self._index:
            (dropped if e.get("tag") == kind else keep).append(e)
        for e in dropped:
            if os.path.exists(e["path"]):
                os.unlink(e["path"])
        self._index = keep
        return self.save(state, step, tag=kind)

    def _retain(self) -> None:
        if self.save_top_k <= 0:
            return
        scored = [e for e in self._index if self.monitor in e["metrics"] and not e.get("tag")]
        sign = 1 if self.mode == "min" else -1
        scored.sort(key=lambda e: sign * e["metrics"][self.monitor])
        keep = set(id(e) for e in scored[: self.save_top_k])
        # Regular checkpoints without the metric keep the newest top-k.
        unscored = [e for e in self._index
                    if not e.get("tag") and self.monitor not in e["metrics"]]
        unscored.sort(key=lambda e: -e["step"])
        keep |= set(id(e) for e in unscored[: self.save_top_k])
        # The newest regular checkpoint (the resume point) always stays.
        untagged = [e for e in self._index if not e.get("tag")]
        latest = max(untagged, key=lambda e: e["step"], default=None)
        new_index = []
        for e in self._index:
            if e.get("tag") or id(e) in keep or e is latest:
                new_index.append(e)
            elif os.path.exists(e["path"]):
                os.unlink(e["path"])
        self._index = new_index

    # -- query / restore --------------------------------------------------------------

    def latest(self) -> Optional[Dict]:
        entries = [e for e in self._index if not e.get("tag")]
        return max(entries, key=lambda e: e["step"], default=None)

    def best(self) -> Optional[Dict]:
        scored = [e for e in self._index if self.monitor in e["metrics"] and not e.get("tag")]
        if not scored:
            return None
        sign = 1 if self.mode == "min" else -1
        return min(scored, key=lambda e: sign * e["metrics"][self.monitor])

    def restore(self, entry: Optional[Dict] = None) -> Any:
        entry = entry or self.latest()
        if entry is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_state(entry["path"])

    def restore_latest_or_none(self):
        """Resume hook: (state, step) from the latest checkpoint, or None."""
        entry = self.latest()
        if entry is None:
            return None
        return restore_state(entry["path"]), entry["step"]
