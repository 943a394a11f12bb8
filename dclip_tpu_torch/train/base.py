"""Shared trainer scaffolding: device transfer, epoch loop, fit with
checkpoints, preemption and resume, the k-NN gate of the teacher's patch
embeddings and the budgeted patch encode (counterpart of
`dclip_tpu/train/base.py`).

A trainer's checkpoint is its `checkpoint_state()` (plain tensors,
numbers and strings; `train.checkpoint`), restored by
`load_checkpoint_state`. Under a process group (`parallel.mesh`) every
rank of a model group holds the same parameters: only the primary (global
rank 0) writes checkpoints, and every rank reads them on resume. Under
tensor parallelism a trainer whose state is sharded
(`_state_needs_every_rank`) gathers it on every rank before the primary
writes it: one checkpoint format whatever the model axis. The budgeted patch encode reads the
rank's own box mask, so its compaction budget is per rank (JAX's per-shard
budget).
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Mapping

import numpy as np
import torch


def apply_knn_gate(pe: torch.Tensor, positions, store_keys, store_values, projection_fn,
                   threshold: float, patch_mask: torch.Tensor) -> torch.Tensor:
    """Route patch embeddings pe [B, P, D] through the k-NN / projection /
    raw-CLIP gate (`ops.knn.knn_or_projection`); positions [B, P, 4] are the
    boxes normalized to the frame (None: zeros); masked slots stay zero."""
    from dclip_tpu_torch.ops.knn import knn_or_projection

    b, p, d = pe.shape
    res = knn_or_projection(pe.reshape(b * p, d),
                            None if positions is None else positions.reshape(b * p, 4),
                            store_keys, store_values, projection_fn, threshold)
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
    """Subclasses set self.device, self.cfg and self.step and implement
    train_step_on_batch(batch) -> metrics (device scalars),
    eval_loss_on_batch(batch) -> float, and checkpoint_state() /
    load_checkpoint_state(state); optionally _num_epochs, _on_epoch_start
    and _prepare_resume."""

    # Host-only (index, content_key) and unconsumed (conf) fields never
    # cross to the device.
    _HOST_ONLY_FIELDS = ("index", "content_key", "conf")

    device: torch.device
    step: int = 0
    mesh = None  # a parallel.mesh.Mesh; None: one process

    @property
    def is_primary(self) -> bool:
        """The rank that writes checkpoints (rank 0, or the only process)."""
        return self.mesh is None or self.mesh.is_primary

    def _device_batch(self, batch, fields=None) -> Dict[str, torch.Tensor]:
        d = batch.as_dict() if hasattr(batch, "as_dict") else dict(batch)
        return {
            k: torch.as_tensor(v).to(self.device)
            for k, v in d.items()
            if k not in self._HOST_ONLY_FIELDS and v is not None
            and (fields is None or k in fields)
        }

    # -- the k-NN gate of the teacher's patch embeddings (both trainers) --------

    def _init_knn_gate(self, knn_store, projection_params=None, embed_dim: int = 512) -> None:
        """Optional k-NN gate over the raw patch embeddings: an
        `EmbeddingStore` of (key, value) rows on the device and, with
        `projection_params` (an `ImageProjectionModule` state dict), the
        position-conditioned projection branch for the queries below the
        threshold. Without a store the gate is off, as in the JAX trainers."""
        self._knn_keys = self._knn_values = self._projection_fn = None
        self._projection_params = projection_params
        if knn_store is not None and len(knn_store) > 0:
            self._knn_keys, self._knn_values = knn_store.device_arrays(self.device)
        if projection_params is not None:
            from dclip_tpu_torch.models.projections import (
                ImageProjectionModule,
                projection_apply_fn,
            )

            self._projection_fn = projection_apply_fn(
                ImageProjectionModule(embed_dim, device="meta"), projection_params, self.device)

    def _maybe_knn_gate(self, pe: torch.Tensor, batch) -> torch.Tensor:
        """`apply_knn_gate` at the teacher config's threshold with the boxes
        normalized by the teacher frame, or `pe` as it is without a store."""
        if self._knn_keys is None:
            return pe
        frame = batch["teacher_pixels"].shape[1]
        return apply_knn_gate(pe, batch["boxes"] / float(frame), self._knn_keys,
                              self._knn_values, self._projection_fn,
                              self.cfg.teacher.similarity_threshold, batch["box_mask"])

    def _num_epochs(self) -> int:
        raise NotImplementedError

    def _state_needs_every_rank(self) -> bool:
        """True when `checkpoint_state()` is collective (its tensors are
        gathered over the model group): every rank must call it."""
        return False

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
        host syncs only at log points and at the end. With `preemption` (an
        installed `train.preemption.PreemptionGuard`) each batch, once
        drawn, passes the guard's check before its step: a stop raises
        `Preempted` at that step boundary."""
        total, n = None, 0
        for batch in batches:
            if preemption is not None and preemption.should_stop(n):
                from dclip_tpu_torch.train.preemption import Preempted

                raise Preempted(f"preemption signal honored at step boundary {n}")
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
        `CheckpointManager` one checkpoint per epoch (the primary rank's);
        a KeyboardInterrupt or an error saves an `.interrupt` / `.error`
        checkpoint and re-raises. With `preemption` a SIGTERM stops at the
        next step boundary, saves a tagged `preempt` checkpoint and raises
        `Preempted`; a failure after the signal was seen (a process-group
        SIGTERM kills the pipeline's workers first) is that preemption.
        A sharded state is gathered on every rank for the epoch and the
        preempt checkpoints (every rank reaches them together); an
        interrupt or an error on one rank cannot gather it and saves
        nothing."""
        from dclip_tpu_torch.train.preemption import Preempted

        every_rank = checkpoints is not None and self._state_needs_every_rank()
        if not self.is_primary:
            checkpoints = None

        def state(lockstep: bool = True):
            if not lockstep and every_rank:
                print("no checkpoint: the tensor-parallel state cannot be gathered from "
                      "one rank's failure")
                return None
            return self.checkpoint_state() if checkpoints is not None or every_rank else None

        history: Dict[str, list] = {"train_loss": [], "val_loss": []}
        try:
            for epoch in range(start_epoch, self._num_epochs()):
                self._on_epoch_start(epoch)
                train_loss = self.train_epoch(train_pipeline.epoch(epoch), logger,
                                              preemption=preemption)
                history["train_loss"].append(train_loss)
                val_loss = (self.validate(val_pipeline.epoch(epoch))
                            if val_pipeline is not None else train_loss)
                if val_loss != val_loss:  # NaN: empty val pipeline
                    print("validation yielded no batches; using train_loss")
                    val_loss = train_loss
                history["val_loss"].append(val_loss)
                print(f"Epoch {epoch}: train_loss={train_loss:.4f} val_loss={val_loss:.4f}")
                saved = state()
                if checkpoints is not None:
                    checkpoints.save(saved, step=self.step, epoch=epoch,
                                     metrics={"train_loss": train_loss, "val_loss": val_loss})
        except KeyboardInterrupt:
            saved = state(lockstep=False)
            if checkpoints is not None and saved is not None:
                checkpoints.save_interrupt(saved, self.step, "interrupt")
            raise
        except Exception as e:
            preempted = isinstance(e, Preempted) or (
                preemption is not None and preemption.requested)
            saved = state(lockstep=isinstance(e, Preempted))
            if checkpoints is not None and saved is not None:
                checkpoints.save_interrupt(saved, self.step,
                                           "preempt" if preempted else "error")
            if preempted and not isinstance(e, Preempted):
                raise Preempted("preemption signal seen; pipeline failed before the next "
                                f"step boundary ({type(e).__name__}: {e})") from e
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
