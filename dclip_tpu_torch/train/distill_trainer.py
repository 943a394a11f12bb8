"""Student distillation trainer (counterpart of
`dclip_tpu/train/distill_trainer.py:56-180, 183-955`).

One training step: teacher targets for the batch, then the student update.

- Teacher targets, with a three-level cache. Full (img, txt) targets come
  from the device or host cache (keyed by item and caption); else the
  caption-independent patch embeddings come from the device level, then
  the host level (keyed by item and boxes); else the region encode runs:
  every box is cropped and squash-resized (`ops.image_ops`) and the
  frozen teacher ViT encodes the B x P crops (K1 / K2,
  `kernels.vit_block`), with crop compaction when boxes are missing. Then
  the tail: the teacher text tower's token features (K3 with causal and
  padding masks), the bidirectional cross-attention (K10,
  `kernels.cross_attention`), the temperature aggregation and fusion
  (`models.teacher`); every level takes the new rows. On a miss the
  teacher-only fields (`teacher_pixels`, `boxes`, `box_mask`) cross to the
  device; on a full hit they stay on the host.
- Student step: its image tower and (packed) caption tower forward and
  backward (K3 / K4 / K5 attention, K6 frozen MLP; opt-in, K8 for the text
  tower's LN2 + MLP with `fused_text_mlp` and K9 for the vision tower's
  LN1 + attention block with `fused_attn_block`), the cos-distill(img) +
  cos-distill(txt) + InfoNCE loss (K11), the masked AdamW update.
- Epochs: `fit` runs the unfreeze schedule (`unfreeze_schedule` plus the
  `unfreeze_text_at_epoch` sugar): when a stage changes the trainable
  mask, the student module is rebuilt for it (K6 switches off once the
  vision LN2 / MLP train) and the optimizer state starts afresh, the step
  count kept (`distill_trainer.py:957-1010`). A `CheckpointManager`
  saves `checkpoint_state()` after each epoch; `resume` replays the
  schedule to the saved epoch and restores parameters, AdamW moments,
  the accumulation state and the step.

With the kernels on (`use_pallas`, auto on CUDA) the kernels run; on the
CPU, asked for explicitly, their plain twins. The teacher tail computes
in f32 whether its patch embeddings were just encoded or come from a
cache (the JAX trainer runs it in bf16 after a host pe-cache hit,
ROADMAP Queue 3). `eval_loss_on_batch` runs the teacher and the student
loss without the caches and without gradients. The stages run under
`torch.profiler` ranges for a profile's breakdown of a step, each a
sibling of the others at the top of the step unless named inside one:
`dclip.cache_lookup` (the keys' hashing, both cache levels' `get` and a
host hit's upload), `dclip.h2d`, those of `models.teacher` and
`dclip.cross_attention`, `dclip.pack_text` (the host packing and its
uploads), and `dclip.student_step` (the forward and the loss;
`train.optim`'s `dclip.backward` and `dclip.optimizer` inside it). While
a profiler records, the backward runs under `dclip.backward.loss`,
`dclip.backward.text` and `dclip.backward.vision`, opened and closed on
autograd's thread (`core.metrics.BackwardSpans`); without one the step
builds no span and the ranges cost a few microseconds.

A SigLIP student (`CLIPConfig.family == "siglip"`, `models.siglip`) takes
the same cached step: its image and text features are its towers' pooled
outputs (no projection; its captions run unmasked, its module reads no
mask), and its vision head's `in_proj` / `out_proj` fall under the default
mask's "proj" rule. A student class that cannot take packed captions says
why (`packed_text_refusal`): an explicit `packed_text` then raises with
that reason and the auto setting resolves off. A SigLIP teacher CLIP serves the cache only: the region
encode through its pooling head and K10 at its width are not brought, so
a step that must compute targets raises.

`cfg.remat` runs the student's encoder layers under activation
recomputation (`models.clip`, JAX's `nn.remat`): the same numbers, less
device memory, one more forward of each layer per step. It is a property
of the student build only, so every rebuild of the unfreeze schedule keeps
it, a checkpoint does not record it (one saved with it resumes without it
and the other way round), and the teacher-target fingerprint does not
read it.

Data parallelism (`distill_trainer.py:196-330, 694-711`): under a process
group (`parallel.mesh`, one process per card) each rank runs the teacher
targets through its own caches (keyed by its own rows), packs and encodes
its own captions and images, and computes the loss over the all-gathered
global batch: K11 over the gathered [B_g, D] embeddings with the kernels
on (the JAX trainer takes XLA there for the TPU's VMEM bound and GSPMD's
sharding, neither of which holds on Hopper), `ops.losses.
distillation_loss_global` with them off. Each rank differentiates the
global loss with respect to its own rows, the gradients are summed over
the ranks in one f32 all-reduce, and every rank applies the same AdamW
update to parameters broadcast from rank 0 at construction.
`dp_equivalent=True` runs that code on one rank without a group.
`fit(preemption=guard)` stops at a step boundary on SIGTERM
(`train.preemption`).

Tensor parallelism (`distill_trainer.py:246-259, 542-597, 1020-1040`): a
mesh with a model axis (`parallel.tp`) holds the student's and the teacher
CLIP's encoder layers as this rank's slices (broadcast from global rank 0,
then sharded; head counts and MLP widths must divide). The student's
layers run the sharded composition with the attention core on K3 / K4 /
K5 at `heads / mp` heads; the whole-block kernels K6, K8 and K9 need whole
weights and step aside, as JAX demotes its in-module kernels. The region
encode runs the teacher ViT's slices through `vit_block.encoder_forward_tp`
(LayerNorm, GEMM and K1's core at shard width); K10 and the aggregation
are replicated; K11 runs over the batch gathered on the data group,
identically on every model rank. AdamW's moments are shard-shaped, the
clip's norm spans the model group, and gradients are summed over the data
group only. A checkpoint holds the gathered whole tensors, so it restores
at any model-parallel size.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from dclip_tpu_torch.core.config import CLIPConfig, DistillConfig, UnfreezeStage, model_family
from dclip_tpu_torch.core.device import resolve_device, resolve_dtype
from dclip_tpu_torch.core.fast_paths import resolve_fast_paths
from dclip_tpu_torch.core.metrics import BackwardSpans, profiling
from dclip_tpu_torch.kernels import vit_block
from dclip_tpu_torch.kernels.cross_attention import cross_attention_fused, pack_cross_attention
from dclip_tpu_torch.kernels.distill_loss import fused_distillation_loss
from dclip_tpu_torch.models.clip import CLIPModule
from dclip_tpu_torch.models.siglip import dual_encoder_class
from dclip_tpu_torch.models.teacher import (
    PatchTextAggregation,
    aggregate_attended,
    encode_patches,
    encode_tokens,
)
from dclip_tpu_torch.ops.losses import distillation_loss, distillation_loss_global
from dclip_tpu_torch.ops.packing import pack_captions_sharded
from dclip_tpu_torch.parallel.mesh import broadcast_, gather_cat, gather_rows, make_mesh
from dclip_tpu_torch.parallel.tp import (
    gather_clip_params,
    model_axis,
    param_spec,
    shard_clip_params,
)
from dclip_tpu_torch.train.base import BaseTrainer, budgeted_patch_encode, fingerprint_objects
from dclip_tpu_torch.train.device_cache import DeviceTargetCache, resolve_device_cache
from dclip_tpu_torch.train.optim import (
    count_trainable,
    make_optimizer,
    make_train_step,
    student_trainable_mask,
)


CHECKPOINT_FORMAT = "dclip_tpu_torch.DistillTrainer/1"


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
            from dclip_tpu_torch import native

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
    # Fields the student step consumes, and those only the teacher reads:
    # the latter stay on the host on a cache hit (they are most of the
    # batch bytes).
    _STUDENT_FIELDS = ("pixel_values", "input_ids", "attention_mask")
    _TEACHER_FIELDS = ("teacher_pixels", "boxes", "box_mask")

    def __init__(
        self,
        cfg: DistillConfig,
        student_state_dict: Dict[str, torch.Tensor],
        teacher_clip_state_dict: Dict[str, torch.Tensor],
        teacher_state_dict: Dict[str, torch.Tensor],
        student_config: Optional[CLIPConfig] = None,
        teacher_clip_config: Optional[CLIPConfig] = None,
        device="cuda",
        teacher_cache: Optional[TeacherTargetCache] = None,
        knn_store=None,
        projection_params=None,
        dp_equivalent: bool = False,
        mesh=None,
    ):
        """`student_state_dict` / `teacher_clip_state_dict`: HF-named CLIP
        state dicts (`models.weights.state_dict_from_jax` /
        `random_state_dict`); `teacher_state_dict`: the meta-teacher's
        `cross_modal_attention.*` state dict (`teacher_state_dict_from_jax` /
        `random_teacher_state_dict`). The trainer copies all three to
        `device` in f32 (rank 0's under a process group); `knn_store`: an
        `EmbeddingStore` for the k-NN gate; `projection_params`: an
        `ImageProjectionModule` state dict for its projection branch
        (`models.projections`); `mesh`: a `parallel.mesh.Mesh` (default
        `make_mesh(cfg.mesh)`: the default process group, else one rank);
        `dp_equivalent`: the data-parallel step (gathered loss, reduced
        gradients) even on one rank (JAX's bench mode)."""
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
        refusal = dual_encoder_class(self.student_config).packed_text_refusal
        if refusal is not None:
            if cfg.packed_text:
                raise ValueError(refusal)
            cfg = self.cfg = dataclasses.replace(cfg, packed_text=False)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh)
        self._dp = self.mesh.distributed or bool(dp_equivalent)
        self._tp = model_axis(self.mesh)
        self.device = resolve_device(device)
        cfg = self.cfg = resolve_fast_paths(cfg, self.device)
        self._student_dtype = resolve_dtype(cfg.compute_dtype, self.device)
        self._use_kernels = bool(cfg.use_pallas)
        if self._use_kernels and self.device.type == "cuda" \
                and self._student_dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels compute in bfloat16: use compute_dtype "
                             "'bfloat16' (or 'auto'), or use_pallas=False")
        if self._use_kernels and self._tp is not None:
            print("whole-block kernels (K6 frozen MLP, K8, K9) demoted to the sharded "
                  "composition: tensor-parallel mesh (mp>1; weights are TP-sharded); attention "
                  "stays on K3 / K4 / K5 at heads / mp, the region encode on LayerNorm, GEMM "
                  "and K1's core at shard width")
        self._unfrozen_extra: tuple = ()
        self._trainable_mask = self._student_mask(student_state_dict.keys())
        self.student = self._make_student(student_state_dict)
        self._build_optimizer()
        self.teacher_clip_state_dict = teacher_clip_state_dict
        self.teacher_state_dict = teacher_state_dict
        self._make_teacher(teacher_clip_state_dict, teacher_state_dict)
        self._init_knn_gate(knn_store, projection_params, cfg.teacher.embed_dim)
        self.step = 0
        self._spans = BackwardSpans()
        self.teacher_cache = teacher_cache
        # Device-resident level 0 in front of the host cache: a hit costs
        # one [B] index upload. Patch embeddings take 3/4 of the budget
        # (P x D rows, and their keys survive caption resampling); full
        # keys go stale as captions resample, so that level evicts FIFO.
        self._dev_full = self._dev_pe = None
        if resolve_device_cache(cfg.device_target_cache, teacher_cache):
            budget, d = cfg.device_cache_mb * (1 << 20), cfg.teacher.embed_dim
            self._dev_full = DeviceTargetCache((2, d), torch.float32, budget // 4, self.device,
                                               evict=True)
            self._dev_pe = DeviceTargetCache((cfg.teacher.max_patches, d), self._student_dtype,
                                             3 * budget // 4, self.device)
        self._compact = bool(cfg.compact_patches)
        self._packed_text = bool(cfg.packed_text)
        if teacher_cache is not None and not teacher_cache.salt:
            teacher_cache.salt = self._teacher_fingerprint()

    # -- construction ---------------------------------------------------------

    def _student_mask(self, names) -> Dict[str, bool]:
        """The trainable mask of the current unfreeze stage; with
        `unfreeze_text_at_epoch` set, the text tower starts frozen."""
        return student_trainable_mask(names, self._unfrozen_extra,
                                      freeze_text=self.cfg.unfreeze_text_at_epoch is not None)

    def _vision_mlp_frozen(self) -> bool:
        """True iff the trainable mask excludes every vision `mlp` and
        `layer_norm2` leaf: the validity condition of the frozen-MLP kernel
        (its backward gives those weights no gradient)."""
        return not any(
            trainable for name, trainable in self._trainable_mask.items()
            if name.startswith("vision_model.") and (".mlp." in name or "layer_norm2" in name)
        )

    def _on_device(self, state_dict) -> Dict[str, torch.Tensor]:
        """f32 copies on the device; under a process group, global rank 0's."""
        out = {k: v.detach().to(self.device, torch.float32, copy=True)
               for k, v in state_dict.items()}
        broadcast_(out.values(), self.mesh)
        return out

    def _placed(self, state_dict) -> Dict[str, torch.Tensor]:
        """Whole CLIP tensors -> this rank's: rank 0's, then its slices
        under tensor parallelism (JAX's `_put_replicated`)."""
        out = self._on_device(state_dict)
        return out if self._tp is None else shard_clip_params(out, self._tp)

    def _state_needs_every_rank(self) -> bool:
        return self._tp is not None

    def _make_student(self, state_dict, placed: bool = False) -> CLIPModule:
        """The student for the current unfreeze stage, on the device: f32
        parameters with requires_grad from the mask. With the kernels on
        (`distill_trainer.py:468-516`), attention is fused in both towers,
        the vision LN2 + MLP blocks run the frozen-MLP kernel (K6) exactly
        while the mask freezes them, the text LN2 + MLP blocks run K8 with
        `fused_text_mlp` and the vision attention blocks K9 with
        `fused_attn_block`; both towers recompute their layers in the
        backward with `cfg.remat`. There are no VMEM gates (`mlp_frozen_fit`,
        `mlp_trainable_fit`, `attn_block_fit` on the TPU): the kernels tile,
        so every width runs on them, ViT-L/14's included. Under tensor
        parallelism the whole-block kernels step aside (module docstring).
        `placed`: the state dict is this rank's already (the unfreeze
        rebuild: nothing is broadcast, nothing densified)."""
        kernels = self._use_kernels
        blocks = kernels and self._tp is None
        fused_frozen = blocks and self._vision_mlp_frozen()
        model = dual_encoder_class(self.student_config)(
            self.student_config, dtype=self._student_dtype, device="meta",
            fused_attention=kernels, fused_frozen_mlp=fused_frozen,
            fused_trainable_text_mlp=blocks and bool(self.cfg.fused_text_mlp),
            fused_trainable_attn_block=blocks and bool(self.cfg.fused_attn_block),
            remat=bool(self.cfg.remat), mesh=self._tp)
        sd = ({k: v.detach().to(self.device, torch.float32, copy=True)
               for k, v in state_dict.items()} if placed else self._placed(state_dict))
        model.load_state_dict(sd, strict=True, assign=True)
        for name, p in model.named_parameters():
            p.requires_grad_(self._trainable_mask[name])
        if fused_frozen:
            model.pack_frozen_vision_mlp()
        return model

    def _make_teacher(self, clip_state_dict, teacher_state_dict) -> None:
        """The frozen teacher on the device: its CLIP (text tower on the
        fused attention with the kernels on) and the meta-teacher module.
        With the kernels on, the teacher ViT's weights are packed once for
        the block kernels (`_teacher_image_features`, the region encode) and
        the cross-attention weights once for K10 (`_xattn`). Under tensor
        parallelism the CLIP holds this rank's slices; the meta-teacher is
        replicated."""
        clip_sd = self._placed(clip_state_dict)
        self.teacher_clip = dual_encoder_class(self.teacher_clip_config)(
            self.teacher_clip_config, dtype=self._student_dtype, device="meta",
            fused_attention=self._use_kernels, mesh=self._tp)
        self.teacher_clip.load_state_dict(clip_sd, strict=True, assign=True)
        self.teacher = PatchTextAggregation(self.cfg.teacher, device="meta")
        teacher_sd = self._on_device(teacher_state_dict)
        self.teacher.load_state_dict(teacher_sd, strict=True, assign=True)
        for module in (self.teacher_clip, self.teacher):
            module.requires_grad_(False).eval()
        self._teacher_image_features = self._xattn = None
        if self._use_kernels and not self._siglip_teacher():  # a SigLIP teacher never runs
            packed = vit_block.pack_vision_weights(self.teacher_clip_config, clip_sd,
                                                   self._student_dtype, self._tp)
            cfg = self.teacher_clip_config
            self._teacher_image_features = (
                lambda px: vit_block.fused_image_features(cfg, packed, px))
            self._xattn = pack_cross_attention(teacher_sd, self._student_dtype)

    def _siglip_teacher(self) -> bool:
        return model_family(self.teacher_clip_config) == "siglip"

    def _require_clip_teacher(self) -> None:
        """Teacher targets computed here need a CLIP teacher (module docstring)."""
        if self._siglip_teacher():
            raise ValueError(
                "the uncached distillation step with a SigLIP teacher is not brought: the "
                "region encode through SigLIP's pooling head and the cross-attention (K10) at "
                f"width {self.cfg.teacher.embed_dim} are missing; give every step's targets "
                "through the teacher cache")

    def _build_optimizer(self) -> None:
        n_train, n_total = count_trainable(self._trainable_mask)
        print(f"Student trainable leaves: {n_train}/{n_total}")
        names = self._trainable_names()
        params = dict(self.student.named_parameters())
        # Each tower's trainable leaves: their gradients close its backward span.
        self._tower_leaves = {
            tower: [params[n] for n in names if n.startswith(prefixes)]
            for tower, prefixes in (("vision", ("vision_model.", "visual_projection.")),
                                    ("text", ("text_model.", "text_projection.")))}
        self.optimizer = make_optimizer(
            [params[n] for n in names],
            self.cfg.learning_rate, kind="adamw", warmup_steps=self.cfg.warmup_steps,
            grad_clip=self.cfg.gradient_clip_val,
            accumulate_steps=self.cfg.accumulate_grad_batches, mesh=self._tp,
            sharded=[param_spec(n) is not None for n in names])
        self._train_step = make_train_step(self._student_loss, self.student, self.optimizer,
                                           self.mesh)

    def _teacher_fingerprint(self) -> str:
        """Digest of everything that determines teacher targets: teacher
        config, CLIP preset, every weight byte, the k-NN store and the
        projection head."""
        return fingerprint_objects(repr(self.cfg.teacher), self.cfg.teacher_clip_model,
                                   self.teacher_state_dict, self.teacher_clip_state_dict,
                                   self._knn_keys, self._knn_values, self._projection_params)

    # -- teacher forward (frozen) ---------------------------------------------

    def _encode_patches_only(self, batch) -> torch.Tensor:
        """Image side of the teacher: caption-independent, so cacheable per
        image even when captions are resampled every epoch."""
        return encode_patches(self.teacher_clip, batch["teacher_pixels"], batch["boxes"],
                              batch["box_mask"], self.teacher_clip_config.vision.image_size,
                              self._teacher_image_features)

    def _encode_patches_budgeted(self, raw_batch, device_batch) -> torch.Tensor:
        pe = budgeted_patch_encode(self.teacher_clip, self.teacher_clip_config, raw_batch,
                                   device_batch, self._compact, self._teacher_image_features)
        return self._maybe_knn_gate(pe, device_batch)

    def _teacher_tail(self, pe: torch.Tensor, batch):
        """Text encode + cross-attention + aggregation, given patch
        embeddings; f32 targets (global embedding, mean content token)."""
        te, tmask = encode_tokens(self.teacher_clip, batch["input_ids"], batch["attention_mask"],
                                  self.teacher_clip_config.text.eos_token_id)
        pe = pe.float()
        box_mask = batch["box_mask"]
        with record_function("dclip.cross_attention"):
            if self._xattn is not None:
                use_masks = self.cfg.teacher.mask_padding
                at, ai = cross_attention_fused(self._xattn, te, pe,
                                               tmask if use_masks else None,
                                               box_mask if use_masks else None,
                                               self.cfg.teacher.num_heads)
                out = aggregate_attended(self.cfg.teacher, at, ai, tmask, box_mask)
            else:
                out = self.teacher(te, pe, tmask, box_mask)
        # aggregate_text per caption: the mean over content tokens.
        denom = torch.clamp(tmask.sum(1, keepdim=True), min=1.0)
        teacher_text = (te * tmask[..., None]).sum(1) / denom
        return out.global_embedding.float(), teacher_text.float()

    @torch.no_grad()
    def _teacher_targets(self, batch):
        """The targets from scratch, without compaction or caches (eval)."""
        self._require_clip_teacher()
        pe = self._maybe_knn_gate(self._encode_patches_only(batch), batch)
        return self._teacher_tail(pe, batch)

    @torch.no_grad()
    def _get_teacher_targets(self, raw_batch, device_batch, keys=None, probe_full: bool = True):
        """Teacher targets through the cache levels (module docstring)."""
        self._require_clip_teacher()
        patch_keys = None
        if self.teacher_cache is not None and self._cacheable(raw_batch):
            if keys is None:
                keys = self.teacher_cache.keys_for(raw_batch)
            if probe_full:
                cached = self.teacher_cache.get_batch(keys)
                if cached is not None:
                    t = torch.from_numpy(np.asarray(cached, np.float32)).to(self.device)
                    return t[:, 0], t[:, 1]
            patch_keys = self.teacher_cache.pe_keys_for(raw_batch)
        pe = None
        if patch_keys is not None and self._dev_pe is not None:
            pe = self._dev_pe.get(patch_keys)
        if pe is None and patch_keys is not None:
            cached_pe = self.teacher_cache.get_batch(patch_keys)
            if cached_pe is not None:
                pe = torch.from_numpy(np.asarray(cached_pe, np.float32)).to(
                    self.device, self._student_dtype)
                if self._dev_pe is not None:
                    self._dev_pe.put(patch_keys, pe)
        if pe is None:
            pe = self._encode_patches_budgeted(raw_batch, device_batch)
            if patch_keys is not None:
                self.teacher_cache.put_batch(patch_keys, pe.float().cpu().numpy())
                if self._dev_pe is not None:
                    self._dev_pe.put(patch_keys, pe)
        teacher_img, teacher_txt = self._teacher_tail(pe, device_batch)
        if keys is not None:
            targets = torch.stack([teacher_img, teacher_txt], 1)
            self.teacher_cache.put_batch(keys, targets.cpu().numpy())
            if self._dev_full is not None:
                self._dev_full.put(keys, targets)
        return teacher_img, teacher_txt

    # -- the student step -----------------------------------------------------

    def _student_loss(self, teacher_img, teacher_txt, batch):
        spans = self._spans if profiling() else None
        if spans is None:
            self._spans.release()
        student_img = self.student.image_features(batch["pixel_values"])
        if spans is not None:
            student_img = spans.mark(student_img, "dclip.backward.vision",
                                     self._tower_leaves["vision"])
        if "packed_ids" in batch:
            student_txt = self.student.get_packed_text_features(
                batch["packed_ids"], batch["packed_segments"], batch["packed_positions"],
                batch["packed_eos_rows"], batch["packed_eos_cols"])
        else:
            student_txt = self.student.get_text_features(batch["input_ids"],
                                                         batch["attention_mask"])
        if spans is not None:
            student_txt = spans.mark(student_txt, "dclip.backward.text",
                                     self._tower_leaves["text"])
        loss, metrics = self._distillation_loss(student_img, student_txt, teacher_img,
                                                teacher_txt)
        if spans is not None:
            loss = spans.mark(loss, "dclip.backward.loss")
        return loss, metrics

    def _distillation_loss(self, student_img, student_txt, teacher_img, teacher_txt):
        if self._use_kernels:
            # K11 on one device and, over the gathered global batch, under
            # a process group (module docstring).
            if self._dp:
                student_img = gather_rows(student_img, self.mesh)
                student_txt = gather_rows(student_txt, self.mesh)
                teacher_img = gather_cat(teacher_img, self.mesh)
                teacher_txt = gather_cat(teacher_txt, self.mesh)
            return fused_distillation_loss(
                student_img, student_txt, teacher_img, teacher_txt,
                temperature=self.cfg.temperature,
                contrastive_weight=self.cfg.contrastive_weight)
        if self._dp:
            return distillation_loss_global(student_img, student_txt, teacher_img, teacher_txt,
                                            self.mesh, temperature=self.cfg.temperature,
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
        """One training step: teacher targets (the caches first; on a full
        hit only the student fields cross to the device), then the student
        update. Returns the loss parts as device scalars (computed before
        the update)."""
        d = batch.as_dict() if hasattr(batch, "as_dict") else dict(batch)
        keys = targets = None
        if self.teacher_cache is not None and self._cacheable(d):
            with record_function("dclip.cache_lookup"):
                keys = self.teacher_cache.keys_for(d)
                if self._dev_full is not None:
                    targets = self._dev_full.get(keys)
                if targets is None:
                    cached = self.teacher_cache.get_batch(keys)
                    if cached is not None:
                        targets = torch.from_numpy(np.asarray(cached, np.float32)).to(self.device)
                        if self._dev_full is not None:  # promote: later epochs stay on device
                            self._dev_full.put(keys, targets)
        if targets is not None:
            with record_function("dclip.h2d"):
                device_batch = self._device_batch(d, self._STUDENT_FIELDS)
            teacher_img, teacher_txt = targets[:, 0], targets[:, 1]
        else:
            with record_function("dclip.h2d"):
                device_batch = self._device_batch(d, self._STUDENT_FIELDS + self._TEACHER_FIELDS)
            teacher_img, teacher_txt = self._get_teacher_targets(d, device_batch, keys=keys,
                                                                 probe_full=False)
        student_batch = {k: device_batch[k] for k in self._STUDENT_FIELDS}
        with record_function("dclip.pack_text"):
            student_batch = self._maybe_pack_text(d, student_batch)
        with record_function("dclip.student_step"):
            metrics = self._train_step(teacher_img.float(), teacher_txt.float(), student_batch)
        self.step += 1
        return metrics

    # -- the unfreeze schedule -------------------------------------------------

    def _effective_unfreeze_schedule(self):
        """`unfreeze_schedule` plus the `unfreeze_text_at_epoch` sugar (the
        reference's intended text unfreeze, CLIP_image_distillation.py:753-755)."""
        schedule = tuple(self.cfg.unfreeze_schedule)
        if self.cfg.unfreeze_text_at_epoch is not None:
            schedule += (UnfreezeStage(epoch=self.cfg.unfreeze_text_at_epoch,
                                       patterns=("text_model",)),)
        return schedule

    def _maybe_unfreeze(self, epoch: int) -> None:
        """Apply the stages reached at `epoch`. A changed mask rebuilds the
        student for it (an unfrozen vision LN2 / MLP takes K6 off: its
        backward gives those weights no gradient) and starts a fresh
        optimizer state; the step count stays."""
        new = tuple(p for stage in self._effective_unfreeze_schedule() if epoch >= stage.epoch
                    for p in stage.patterns)
        if set(new) == set(self._unfrozen_extra):
            return
        self._unfrozen_extra = new
        self._trainable_mask = self._student_mask(self._trainable_mask.keys())
        self.student = self._make_student(self.student.state_dict(), placed=True)
        self._build_optimizer()

    # -- BaseTrainer hooks ----------------------------------------------------

    def _num_epochs(self) -> int:
        return self.cfg.phase1_epochs

    def _on_epoch_start(self, epoch: int) -> None:
        self._maybe_unfreeze(epoch)

    def _prepare_resume(self, saved_epoch: int) -> None:
        # The checkpoint's trainable set is the one of the stage active when
        # it was saved: replay the schedule to that epoch first.
        self._maybe_unfreeze(saved_epoch)

    def eval_loss_on_batch(self, batch) -> float:
        """The teacher and the student loss in one pass, no caches, no
        gradients (`distill_trainer.py:733-739, 1012-1019`)."""
        device_batch = self._device_batch(batch)
        teacher_img, teacher_txt = self._teacher_targets(device_batch)
        with torch.no_grad():
            loss, _ = self._student_loss(teacher_img, teacher_txt, device_batch)
        return float(loss)

    def checkpoint_state(self) -> dict:
        """Parameters, the trainable names and the AdamW state in their order
        (moments, accumulator, counters), the step and the unfreeze stage,
        on the CPU; under tensor parallelism the whole tensors, gathered
        over the model group (every rank of it must call)."""
        params = {n: p.detach() for n, p in self.student.named_parameters()}
        optimizer = self.optimizer.state_dict()
        if self._tp is not None:
            params = gather_clip_params(params, self._tp)
            optimizer = self._optimizer_tensors(optimizer, self._gathered)
        return {"format": CHECKPOINT_FORMAT, "step": self.step,
                "unfrozen": list(self._unfrozen_extra),
                "params": {n: p.cpu().clone() for n, p in params.items()},
                "trainable": self._trainable_names(), "optimizer": optimizer}

    def _gathered(self, named):
        moved = {n: t.to(self.device) for n, t in named.items()}
        return {n: t.cpu() for n, t in gather_clip_params(moved, self._tp).items()}

    def _optimizer_tensors(self, state: dict, fn) -> dict:
        """`state` with fn({name: tensor}) applied to the moments and the
        accumulator, named by the trainable parameters."""
        names, out = self._trainable_names(), dict(state)
        for key in ("mu", "nu", "acc"):
            if state[key] is not None:
                done = fn(dict(zip(names, state[key])))
                out[key] = [done[n] for n in names]
        return out

    def load_checkpoint_state(self, state) -> None:
        """Restore `checkpoint_state()` into this trainer, whose unfreeze
        stage must be the saved one (`resume` replays the schedule first)."""
        if state.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(f"not a {CHECKPOINT_FORMAT} checkpoint: {state.get('format')!r}")
        if set(state["unfrozen"]) != set(self._unfrozen_extra):
            raise ValueError(f"checkpoint saved at unfreeze stage {state['unfrozen']}, trainer at "
                             f"{list(self._unfrozen_extra)}")
        self.student = self._make_student(state["params"])
        self._build_optimizer()
        if state["trainable"] != self._trainable_names():
            raise ValueError("checkpoint's trainable parameters differ from the trainer's")
        optimizer = state["optimizer"]
        if self._tp is not None:  # JAX's `_place_state`: moments sharded like the params
            optimizer = self._optimizer_tensors(
                optimizer, lambda named: shard_clip_params(named, self._tp))
        self.optimizer.load_state_dict(optimizer)
        self.step = int(state["step"])

    def _trainable_names(self):
        return [n for n, _ in self.student.named_parameters() if self._trainable_mask[n]]
