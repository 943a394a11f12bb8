"""Shared trainer scaffolding: device transfer, epoch loop, fit
(counterpart of `dclip_tpu/train/base.py:206-311`).

Checkpoints, resume and preemption wait for the port's full trainer
(ROADMAP Queue 1 items 5 and 10); asking for them raises.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch


def fingerprint_objects(*objects) -> str:
    """md5 over strings, None, tensors / arrays and (nested) mappings of
    them, full bytes: the salt of a persistent cache of frozen-forward
    outputs (dclip_tpu/train/base.py `fingerprint_objects`)."""
    h = hashlib.md5()

    def feed(obj):
        if obj is None:
            h.update(b"none")
        elif isinstance(obj, str):
            h.update(obj.encode())
        elif isinstance(obj, Mapping):
            for k in sorted(obj):
                h.update(str(k).encode())
                feed(obj[k])
        elif isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous()
            h.update(str(tuple(t.shape)).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            arr = np.ascontiguousarray(obj)
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())

    for obj in objects:
        feed(obj)
    return h.hexdigest()[:12]


class BaseTrainer:
    """Subclasses set self.device and self.step and implement
    train_step_on_batch(batch) -> metrics (device scalars) and
    eval_loss_on_batch(batch) -> float."""

    # Host-only (index, content_key) and unconsumed (conf) fields never
    # cross to the device.
    _HOST_ONLY_FIELDS = ("index", "content_key", "conf")

    device: torch.device
    step: int = 0

    def _device_batch(self, batch, fields=None) -> Dict[str, torch.Tensor]:
        d = batch.as_dict() if hasattr(batch, "as_dict") else dict(batch)
        return {
            k: torch.as_tensor(v).to(self.device)
            for k, v in d.items()
            if k not in self._HOST_ONLY_FIELDS and v is not None
            and (fields is None or k in fields)
        }

    def _num_epochs(self) -> int:
        raise NotImplementedError

    def _on_epoch_start(self, epoch: int) -> None:
        pass

    def train_step_on_batch(self, batch):
        raise NotImplementedError

    def eval_loss_on_batch(self, batch) -> float:
        raise NotImplementedError

    def train_epoch(self, batches: Iterable, logger=None, preemption=None) -> float:
        """Mean step loss over the epoch. The loss sums on the device; the
        host syncs only at log points and at the end."""
        if preemption is not None:
            raise NotImplementedError(
                "preemption handling (train/preemption.py) is ROADMAP Queue 1 item 10")
        total, n = None, 0
        for batch in batches:
            metrics = self.train_step_on_batch(batch)
            total = metrics["loss"] if total is None else total + metrics["loss"]
            n += 1
            if logger and n % logger.print_every == 0:
                logger.log(self.step,
                           {k: float(v) for k, v in metrics.items() if k != "loss"}
                           | {"train_loss": float(metrics["loss"])})
        return float(total) / n if n else 0.0

    def validate(self, batches: Iterable) -> float:
        """Example-weighted mean eval loss; NaN for no batches."""
        total, n = 0.0, 0
        for batch in batches:
            d = batch.as_dict() if hasattr(batch, "as_dict") else dict(batch)
            rows = len(next(iter(d.values())))
            total += self.eval_loss_on_batch(batch) * rows
            n += rows
        return total / n if n else float("nan")

    def fit(self, train_pipeline, val_pipeline=None, checkpoints=None, logger=None,
            start_epoch: int = 0, preemption=None) -> Dict[str, list]:
        if checkpoints is not None:
            raise NotImplementedError(
                "checkpoints and resume are ROADMAP Queue 1 item 5 of the port")
        history: Dict[str, list] = {"train_loss": [], "val_loss": []}
        for epoch in range(start_epoch, self._num_epochs()):
            self._on_epoch_start(epoch)
            train_loss = self.train_epoch(train_pipeline.epoch(epoch), logger, preemption)
            history["train_loss"].append(train_loss)
            val_loss = (self.validate(val_pipeline.epoch(epoch))
                        if val_pipeline is not None else train_loss)
            if val_loss != val_loss:  # NaN: empty val pipeline
                print("validation yielded no batches; using train_loss")
                val_loss = train_loss
            history["val_loss"].append(val_loss)
            print(f"Epoch {epoch}: train_loss={train_loss:.4f} val_loss={val_loss:.4f}")
        return history
