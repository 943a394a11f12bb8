"""Shared trainer scaffolding: device transfer, epoch loop, fit with
checkpoints, resume, the k-NN gate of the teacher's patch embeddings and
the budgeted patch encode (counterpart of `dclip_tpu/train/base.py`).

A trainer's checkpoint is its `checkpoint_state()` (plain tensors,
numbers and strings; `train.checkpoint`), restored by
`load_checkpoint_state`. Preemption waits for the multi-device work
(ROADMAP Queue 1 item 10); asking for it raises. The budgeted patch encode
is the single-device branch (dp > 1 is item 10 too).
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Mapping

import numpy as np
import torch


def apply_knn_gate(pe: torch.Tensor, store_keys, store_values, threshold: float,
                   patch_mask: torch.Tensor) -> torch.Tensor:
    """Route patch embeddings pe [B, P, D] through the k-NN / raw-CLIP gate
    (`ops.knn.knn_or_projection`); masked slots stay zero."""
    from dclip_tpu_torch.ops.knn import knn_or_projection

    b, p, d = pe.shape
    res = knn_or_projection(pe.reshape(b * p, d), store_keys, store_values, threshold)
    return res.embeddings.reshape(b, p, d) * patch_mask[..., None]


def budgeted_patch_encode(clip_model, clip_config, raw_batch, device_batch, compact: bool,
                          image_features_fn=None) -> torch.Tensor:
    """The teacher's patch encode with optional crop compaction: when the
    host-resident box mask leaves slots empty, only the smallest of four
    buckets of slots that covers the valid boxes runs through the ViT
    (`models.teacher.patch_budget`). A mask already on the device is not
    read back (that would stall the step), and the dense encode runs."""
    from dclip_tpu_torch.models.teacher import encode_patches, encode_patches_compact, patch_budget

    budget = 0
    if compact:
        d = raw_batch.as_dict() if hasattr(raw_batch, "as_dict") else raw_batch
        mask = d["box_mask"]
        if isinstance(mask, np.ndarray):
            b = patch_budget(int(mask.sum()), mask.size)
            if b < mask.size:
                budget = b
    args = (clip_model, device_batch["teacher_pixels"], device_batch["boxes"],
            device_batch["box_mask"], clip_config.vision.image_size)
    if budget <= 0:
        return encode_patches(*args, image_features_fn=image_features_fn)
    return encode_patches_compact(*args, budget=budget, image_features_fn=image_features_fn)


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
    train_step_on_batch(batch) -> metrics (device scalars),
    eval_loss_on_batch(batch) -> float, and checkpoint_state() /
    load_checkpoint_state(state); optionally _num_epochs, _on_epoch_start
    and _prepare_resume."""

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

    def checkpoint_state(self) -> dict:
        raise NotImplementedError

    def load_checkpoint_state(self, state: Mapping) -> None:
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
        """Epochs [start_epoch, _num_epochs()): `_on_epoch_start`, the
        training batches, validation (else the train loss), and with a
        `CheckpointManager` one checkpoint per epoch; a KeyboardInterrupt or
        an error saves an `.interrupt` / `.error` checkpoint and re-raises."""
        if preemption is not None:
            raise NotImplementedError(
                "preemption handling (train/preemption.py) is ROADMAP Queue 1 item 10")
        history: Dict[str, list] = {"train_loss": [], "val_loss": []}
        try:
            for epoch in range(start_epoch, self._num_epochs()):
                self._on_epoch_start(epoch)
                train_loss = self.train_epoch(train_pipeline.epoch(epoch), logger)
                history["train_loss"].append(train_loss)
                val_loss = (self.validate(val_pipeline.epoch(epoch))
                            if val_pipeline is not None else train_loss)
                if val_loss != val_loss:  # NaN: empty val pipeline
                    print("validation yielded no batches; using train_loss")
                    val_loss = train_loss
                history["val_loss"].append(val_loss)
                print(f"Epoch {epoch}: train_loss={train_loss:.4f} val_loss={val_loss:.4f}")
                if checkpoints is not None:
                    checkpoints.save(self.checkpoint_state(), step=self.step, epoch=epoch,
                                     metrics={"train_loss": train_loss, "val_loss": val_loss})
        except KeyboardInterrupt:
            if checkpoints is not None:
                checkpoints.save_interrupt(self.checkpoint_state(), self.step, "interrupt")
            raise
        except Exception:
            if checkpoints is not None:
                checkpoints.save_interrupt(self.checkpoint_state(), self.step, "error")
            raise
        return history

    def _prepare_resume(self, saved_epoch: int) -> None:
        """Hook: bring the trainer's structure (the unfreeze stage) to the
        one it had when the checkpoint was saved, before restoring into it."""

    def resume(self, checkpoints) -> int:
        """Restore the latest regular checkpoint; returns the epoch to start
        from (0 when there is none)."""
        entry = checkpoints.latest()
        if entry is None:
            return 0
        saved_epoch = entry.get("epoch") or 0
        self._prepare_resume(saved_epoch)
        state, _ = checkpoints.restore_latest_or_none()
        self.load_checkpoint_state(state)
        return saved_epoch + 1
