"""Student distillation trainer, the student half (counterpart of
`dclip_tpu/train/distill_trainer.py:56-180, 446-955`).

The cache-warm distillation step: on a full-target hit of the teacher
cache (epochs >= 1, `distill_trainer.py:921-936`), only the student runs:
its image tower and (packed) caption tower forward and backward, the
cos-distill(img) + cos-distill(txt) + InfoNCE loss, and the masked AdamW
update. With the kernels on (`use_pallas`, auto on CUDA) the towers run
the hand-written attention (K3/K4/K5) and frozen-MLP (K6) kernels and the
loss runs the fused distillation-loss kernel (K11).

What waits, each raising NotImplementedError that names its ROADMAP item:
a teacher-target cache miss (computing the targets; Queue 1 item 4; the
trainer takes `teacher_clip_state_dict` and `teacher_params` as the JAX one
does, and only fingerprints them), `eval_loss_on_batch`, checkpoints,
resume, the unfreeze schedule and `remat` (item 5), the fused text MLP
(K8, Queue 2 item 7) and fused attention block (K9, Queue 2 item 8), and
a mesh with dp or mp > 1 or `dp_equivalent` (Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from dclip_tpu.core.config import CLIPConfig, DistillConfig
from dclip_tpu_torch.core.device import resolve_device, resolve_dtype
from dclip_tpu_torch.core.fast_paths import resolve_fast_paths
from dclip_tpu_torch.kernels.distill_loss import fused_distillation_loss
from dclip_tpu_torch.models.clip import CLIPModule
from dclip_tpu_torch.ops.losses import distillation_loss
from dclip_tpu_torch.ops.packing import pack_captions_sharded
from dclip_tpu_torch.train.base import BaseTrainer, fingerprint_objects
from dclip_tpu_torch.train.device_cache import DeviceTargetCache, resolve_device_cache
from dclip_tpu_torch.train.optim import (
    count_trainable,
    make_optimizer,
    make_train_step,
    student_trainable_mask,
)


def _waits(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {where}")


class TeacherTargetCache:
    """Cross-epoch cache of frozen teacher targets.

    The modern analogue of the reference's per-patch knn pickle/dbm cache
    (train_pickle.py:61-176, CLIP_image_distillation.py:488-494): the
    teacher is frozen, so its (global_embedding, text_embedding) targets
    for a given (example, caption) pair never change — computing them is
    ~60% of the distillation step, and epochs >= 1 can skip it entirely.

    Keyed by md5(corpus index || caption token ids), so per-epoch random
    caption sampling still caches correctly. Backed by the native mmap KV
    store when a path is given (persists across runs, synced every
    `sync_every` puts like the reference's 100-batch dbm sync), else an
    in-process dict. Host numpy and hashlib, copied from the JAX package
    (distill_trainer.py:56-180), so both packages read one cache layout.
    """

    def __init__(self, path: Optional[str] = None, sync_every: int = 100,
                 salt: str = ""):
        self._mem: Dict[bytes, Any] = {}
        self._store = None
        self._puts = 0
        self.sync_every = sync_every
        # Fingerprint of the teacher (config + weights): a persistent cache
        # must never serve targets computed by a DIFFERENT teacher.
        self.salt = salt
        if path is not None:
            from dclip_tpu import native

            if native.available():
                self._store = native.NativeKVStore(path, writable=True)
            else:
                print("native store unavailable; teacher cache is in-memory only")

    @staticmethod
    def region_digests(batch: Dict[str, Any]):
        """Per-example md5 digest of the detection fields (boxes, box_mask).

        The teacher targets depend on the detections: re-running precache
        with a different detector/threshold changes the boxes, and a
        persistent cache keyed only on (item id, caption) would silently
        serve stale targets for the same images. Host-resident numpy only
        (the real pipeline's layout); returns None when absent so
        synthetic/test batches fall back to id-only keys.
        """
        import hashlib
        import numpy as np

        boxes = batch.get("boxes")
        mask = batch.get("box_mask")
        if not isinstance(boxes, np.ndarray) or not isinstance(mask, np.ndarray):
            return None
        return [
            hashlib.md5(b.tobytes() + m.tobytes()).digest()
            for b, m in zip(boxes, mask)
        ]

    def keys_for(self, batch: Dict[str, Any]) -> list:
        import hashlib
        import numpy as np

        item_ids = DistillTrainer._item_ids(batch)
        ids = np.asarray(batch["input_ids"])
        regions = self.region_digests(batch) or [b""] * len(ids)
        prefix = self.salt.encode()
        return [
            hashlib.md5(
                prefix
                + int(i).to_bytes(8, "little", signed=True)
                + row.tobytes()
                + reg
            ).hexdigest()
            for i, row, reg in zip(item_ids, ids, regions)
        ]

    def pe_keys_for(self, batch: Dict[str, Any]):
        """Caption-independent patch-embedding keys: (salt, item id,
        detection digest). Covers the boxes for the same staleness reason
        as keys_for. None when the batch has no host-resident item ids."""
        item_ids = DistillTrainer._item_ids(batch)
        if item_ids is None:
            return None
        regions = self.region_digests(batch) or [b""] * len(item_ids)
        return [
            f"pe:{self.salt}:{int(i)}:{reg.hex()}"
            for i, reg in zip(item_ids, regions)
        ]

    def get_batch(self, keys: list):
        """[B, 2, D] stacked (img, txt) targets, or None on any miss."""
        import numpy as np

        rows = []
        for k in keys:
            if self._store is not None:
                # The mmap store IS the cache; duplicating every row into
                # _mem would grow host RSS without bound at corpus scale.
                arr = self._store.get_array(k)
                if arr is None:
                    return None
                rows.append(arr)
            elif k in self._mem:
                rows.append(self._mem[k])
            else:
                return None
        return np.stack(rows)

    def put_batch(self, keys: list, targets) -> None:
        import numpy as np

        # float32: np.save round-trips ml_dtypes bfloat16 as raw void.
        targets = np.asarray(targets, np.float32)
        for k, row in zip(keys, targets):
            if self._store is not None:
                self._store.put_array(k, row)
                self._puts += 1
                if self._puts % self.sync_every == 0:
                    self._store.sync()
            else:
                self._mem[k] = row

    def close(self) -> None:
        if self._store is not None:
            self._store.sync()
            self._store.close()
            self._store = None


class DistillTrainer(BaseTrainer):
    # Fields the student step consumes; the teacher-only fields stay on
    # the host on a cache hit (they are most of the batch bytes).
    _STUDENT_FIELDS = ("pixel_values", "input_ids", "attention_mask")

    def __init__(
        self,
        cfg: DistillConfig,
        student_state_dict: Dict[str, torch.Tensor],
        teacher_clip_state_dict: Dict[str, torch.Tensor],
        teacher_params: Any,
        student_config: Optional[CLIPConfig] = None,
        teacher_clip_config: Optional[CLIPConfig] = None,
        device="cuda",
        teacher_cache: Optional[TeacherTargetCache] = None,
        knn_store=None,
        projection_params=None,
        dp_equivalent: bool = False,
    ):
        """`student_state_dict` / `teacher_clip_state_dict`: HF-named CLIP
        state dicts (`models.weights`); the trainer copies the student's
        to `device` in f32."""
        self.cfg = cfg
        self.student_config = student_config or CLIPConfig.from_name(cfg.student_model)
        self.teacher_clip_config = teacher_clip_config or CLIPConfig.from_name(
            cfg.teacher_clip_model)
        if self.student_config.projection_dim != cfg.teacher.embed_dim:
            raise ValueError(
                f"student projection_dim {self.student_config.projection_dim} != "
                f"teacher embed_dim {cfg.teacher.embed_dim}: the distillation "
                "cosine loss requires matching widths"
            )
        if self.teacher_clip_config.projection_dim != cfg.teacher.embed_dim:
            raise ValueError(
                f"teacher CLIP projection_dim {self.teacher_clip_config.projection_dim}"
                f" != teacher embed_dim {cfg.teacher.embed_dim}"
            )
        if dp_equivalent or cfg.mesh.data_parallel not in (-1, 1) or cfg.mesh.model_parallel != 1:
            raise _waits("a mesh with dp or mp > 1 (and dp_equivalent)", "Queue 1 item 10")
        if knn_store is not None or projection_params is not None:
            raise _waits("the k-NN / projection gate of the teacher targets", "Queue 1 item 4")
        self.device = resolve_device(device)
        cfg = self.cfg = resolve_fast_paths(cfg, self.device)
        for on, what, where in (
                (cfg.remat, "remat", "Queue 1 item 5"),
                (cfg.fused_text_mlp, "the fused trainable text MLP (K8)", "Queue 2 item 7"),
                (cfg.fused_attn_block, "the fused trainable attention block (K9)",
                 "Queue 2 item 8")):
            if on:
                raise _waits(what, where)
        if cfg.unfreeze_schedule or cfg.unfreeze_text_at_epoch is not None:
            raise _waits("the unfreeze schedule", "Queue 1 item 5")
        self._student_dtype = resolve_dtype(cfg.compute_dtype, self.device)
        self._use_kernels = bool(cfg.use_pallas)
        if self._use_kernels and self.device.type == "cuda" \
                and self._student_dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels compute in bfloat16: use compute_dtype "
                             "'bfloat16' (or 'auto'), or use_pallas=False")
        self._trainable_mask = student_trainable_mask(student_state_dict.keys())
        self.student = self._make_student(student_state_dict)
        self._build_optimizer()
        self.teacher_clip_state_dict = teacher_clip_state_dict
        self.teacher_params = teacher_params
        self.step = 0
        self.teacher_cache = teacher_cache
        # Device-resident level 0 in front of the host cache: a hit costs
        # one [B] index upload. Full keys go stale as captions resample,
        # so that level evicts FIFO (train/device_cache.py).
        self._dev_full = None
        if resolve_device_cache(cfg.device_target_cache, teacher_cache):
            self._dev_full = DeviceTargetCache(
                (2, cfg.teacher.embed_dim), torch.float32,
                cfg.device_cache_mb * (1 << 20) // 4, self.device, evict=True)
        self._packed_text = bool(cfg.packed_text)
        if teacher_cache is not None and not teacher_cache.salt:
            teacher_cache.salt = self._teacher_fingerprint()

    # -- construction ---------------------------------------------------------

    def _vision_mlp_frozen(self) -> bool:
        """True iff the trainable mask excludes every vision `mlp` and
        `layer_norm2` leaf: the validity condition of the frozen-MLP kernel
        (its backward gives those weights no gradient)."""
        return not any(
            trainable for name, trainable in self._trainable_mask.items()
            if name.startswith("vision_model.") and (".mlp." in name or "layer_norm2" in name)
        )

    def _make_student(self, state_dict) -> CLIPModule:
        """The student on the device, f32 parameters with requires_grad from
        the mask. With the kernels on, attention is fused in both towers and
        the vision LN2 + MLP blocks run the frozen-MLP kernel exactly while
        the mask freezes them (no VMEM gate: the kernels tile)."""
        fused_frozen = self._use_kernels and self._vision_mlp_frozen()
        model = CLIPModule(self.student_config, dtype=self._student_dtype, device="meta",
                           fused_attention=self._use_kernels, fused_frozen_mlp=fused_frozen)
        model.load_state_dict(
            {k: v.detach().to(self.device, torch.float32, copy=True)
             for k, v in state_dict.items()},
            strict=True, assign=True)
        for name, p in model.named_parameters():
            p.requires_grad_(self._trainable_mask[name])
        if fused_frozen:
            model.pack_frozen_vision_mlp()
        return model

    def _build_optimizer(self) -> None:
        n_train, n_total = count_trainable(self._trainable_mask)
        print(f"Student trainable leaves: {n_train}/{n_total}")
        self.optimizer = make_optimizer(
            [p for n, p in self.student.named_parameters() if self._trainable_mask[n]],
            self.cfg.learning_rate, kind="adamw", warmup_steps=self.cfg.warmup_steps,
            grad_clip=self.cfg.gradient_clip_val,
            accumulate_steps=self.cfg.accumulate_grad_batches)
        self._train_step = make_train_step(self._student_loss, self.student, self.optimizer)

    def _teacher_fingerprint(self) -> str:
        """Digest of everything that determines teacher targets: teacher
        config, CLIP preset, and every weight byte."""
        return fingerprint_objects(repr(self.cfg.teacher), self.cfg.teacher_clip_model,
                                   self.teacher_params, self.teacher_clip_state_dict)

    # -- the student step -----------------------------------------------------

    def _student_loss(self, teacher_img, teacher_txt, batch):
        student_img = self.student.image_features(batch["pixel_values"])
        if "packed_ids" in batch:
            student_txt = self.student.get_packed_text_features(
                batch["packed_ids"], batch["packed_segments"], batch["packed_positions"],
                batch["packed_eos_rows"], batch["packed_eos_cols"])
        else:
            student_txt = self.student.get_text_features(batch["input_ids"],
                                                         batch["attention_mask"])
        if self._use_kernels:
            # The JAX gate (distill_trainer.py:694-710) minus the TPU's
            # VMEM batch bound: one device, no dp-equivalent mode.
            return fused_distillation_loss(
                student_img, student_txt, teacher_img, teacher_txt,
                temperature=self.cfg.temperature,
                contrastive_weight=self.cfg.contrastive_weight)
        return distillation_loss(student_img, student_txt, teacher_img, teacher_txt,
                                 temperature=self.cfg.temperature,
                                 contrastive_weight=self.cfg.contrastive_weight)

    @staticmethod
    def _item_ids(d):
        """Stable per-example identity for cache keys: the pipeline's
        content_key when present, else the corpus index; None when the
        needed fields are not host-resident."""
        ck = d.get("content_key")
        if isinstance(ck, np.ndarray):
            return ck
        idx = d.get("index")
        if isinstance(idx, np.ndarray):
            return idx
        return None

    @classmethod
    def _cacheable(cls, d) -> bool:
        return cls._item_ids(d) is not None and isinstance(d.get("input_ids"), np.ndarray)

    def _maybe_pack_text(self, d, student_batch):
        """With cfg.packed_text, swap the text inputs for the packed layout
        (host packing over numpy ids, one data shard, bucketed rows)."""
        if not self._packed_text:
            return student_batch
        ids, am = d.get("input_ids"), d.get("attention_mask")
        if not (isinstance(ids, np.ndarray) and isinstance(am, np.ndarray)):
            return student_batch
        packed = pack_captions_sharded(ids, am, self.student_config.text.eos_token_id,
                                       n_shards=1)
        packed.pop("rows_per_shard")
        out = {k: v for k, v in student_batch.items()
               if k not in ("input_ids", "attention_mask")}
        for k, v in packed.items():
            out[k] = torch.from_numpy(v).to(self.device)
        return out

    def train_step_on_batch(self, batch):
        """One cache-warm training step: teacher targets from the device or
        host cache, then the student update. Returns the loss parts as
        device scalars (computed before the update)."""
        d = batch.as_dict() if hasattr(batch, "as_dict") else dict(batch)
        cached = keys = dev_hit = None
        if self.teacher_cache is not None and self._cacheable(d):
            keys = self.teacher_cache.keys_for(d)
            if self._dev_full is not None:
                dev_hit = self._dev_full.get(keys)
            if dev_hit is None:
                cached = self.teacher_cache.get_batch(keys)
        if dev_hit is not None:
            targets = dev_hit
        elif cached is not None:
            targets = torch.from_numpy(np.asarray(cached, np.float32)).to(self.device)
            if self._dev_full is not None:  # promote: later epochs stay on device
                self._dev_full.put(keys, targets)
        else:
            raise _waits("a teacher-target cache miss (computing the targets: crops, "
                         "teacher ViT and text encode, cross-attention, aggregation)",
                         "Queue 1 item 4")
        student_batch = self._maybe_pack_text(d, self._device_batch(d, self._STUDENT_FIELDS))
        metrics = self._train_step(targets[:, 0].float(), targets[:, 1].float(), student_batch)
        self.step += 1
        return metrics

    # -- BaseTrainer hooks ----------------------------------------------------

    def _num_epochs(self) -> int:
        return self.cfg.phase1_epochs

    def eval_loss_on_batch(self, batch) -> float:
        raise _waits("eval_loss_on_batch (it runs the teacher targets)", "Queue 1 items 4 and 5")

    def resume(self, checkpoints) -> int:
        raise _waits("resume", "Queue 1 item 5")
