"""Meta-teacher contrastive trainer (counterpart of
`dclip_tpu/train/teacher_trainer.py:45-337`).

The reference's `train_contrastive_teacher.py` semantics: seed 42, only
the parameters whose names match `trainable_patterns` train (all of the
cross-attention, through "attention"), Adam at lr 1e-5 with
`gradient_accumulation`, and a symmetric InfoNCE at temperature 0.05
between the teacher's fused global embedding and the mean of the caption's
content-token embeddings. One step:

1. The frozen patch embeddings of the batch's region crops, through the
   levels in order: the device level (`DeviceTargetCache`), the host
   `pe_cache` (a `TeacherTargetCache`, keyed by `pe_keys_for`: item and
   boxes), else the region encode (`budgeted_patch_encode`: crops, then
   the frozen CLIP ViT, K1 / K2 from weights packed once with the kernels
   on) and the k-NN gate; a miss puts the rows into both levels. Only the
   cross-attention trains, so from epoch 1 on a cache skips the encode.
2. The loss: the teacher text tower's token features under
   `torch.no_grad` (K3 with the kernels on), then
   `kernels.cross_attention_trainable` (K10 forward on weights packed from
   the live parameters every call, f32 recompute backward) with the masks
   when `mask_padding` (the module path with the kernels off), the
   aggregation and fusion, and `info_nce`. The token and patch
   embeddings enter in the compute dtype on every path, so a cache hit
   and a miss compute the same numbers.
3. Adam over the trainable parameters (`train.optim`).

The stages run under `torch.profiler` ranges: `dclip.crop`,
`dclip.region_encode`, `dclip.teacher_text` (`models.teacher`),
`dclip.cross_attention`, `dclip.cross_attention_bwd`, `dclip.backward`,
`dclip.optimizer` and `dclip.teacher_train_step` around the update.

Data parallelism (`teacher_trainer.py:57-140`): under a process group
(`parallel.mesh`) each rank runs steps 1 and 2 on its own rows through its
own caches, the loss is `ops.losses.info_nce_global` over the gathered
(global embedding, text) pairs, the ranks' gradients are summed in one f32
all-reduce, and every rank applies the same Adam update to parameters
broadcast from rank 0. `fit(preemption=guard)` stops at a step boundary on
SIGTERM (`train.preemption`).

Tensor parallelism (`teacher_trainer.py:212-225`): a mesh with a model axis
(`parallel.tp`) holds the frozen CLIP's encoder layers as this rank's
slices (its text tower on K3 at `heads / mp`, its ViT on LayerNorm, GEMM
and K1's core at shard width, `vit_block.encoder_forward_tp`); the
trainable cross-attention is replicated, so its gradients and checkpoints
are those of a data-parallel run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from dclip_tpu_torch.core.config import CLIPConfig, TeacherTrainConfig
from dclip_tpu_torch.core.device import resolve_device, resolve_dtype
from dclip_tpu_torch.core.fast_paths import resolve_fast_paths
from dclip_tpu_torch.core.metrics import trace_span
from dclip_tpu_torch.kernels import vit_block
from dclip_tpu_torch.kernels.cross_attention import cross_attention_trainable
from dclip_tpu_torch.models.clip import CLIPModule
from dclip_tpu_torch.models.teacher import PatchTextAggregation, aggregate_attended, encode_tokens
from dclip_tpu_torch.models.weights import random_teacher_state_dict
from dclip_tpu_torch.ops.losses import info_nce, info_nce_global
from dclip_tpu_torch.parallel.mesh import broadcast_, make_mesh
from dclip_tpu_torch.parallel.tp import clip_divisibility_check, model_axis, shard_clip_params
from dclip_tpu_torch.train.base import BaseTrainer, budgeted_patch_encode, fingerprint_objects
from dclip_tpu_torch.train.device_cache import DeviceTargetCache, resolve_device_cache
from dclip_tpu_torch.train.optim import (
    count_trainable,
    make_optimizer,
    make_train_step,
    pattern_mask,
)

CHECKPOINT_FORMAT = "dclip_tpu_torch.TeacherTrainer/1"


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """aggregate_text: the mean over content tokens (`teacher_trainer.py:45-48`)."""
    denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    return (x * mask[..., None]).sum(1) / denom


class TeacherTrainer(BaseTrainer):
    # The loss reads these fields; the region encode adds the other two on
    # a miss only (on a hit the pixels stay on the host).
    _LOSS_FIELDS = ("input_ids", "attention_mask", "box_mask")
    _REGION_FIELDS = ("teacher_pixels", "boxes")

    def __init__(
        self,
        cfg: TeacherTrainConfig,
        clip_state_dict: Dict[str, torch.Tensor],
        clip_config: Optional[CLIPConfig] = None,
        teacher_state_dict: Optional[Dict[str, torch.Tensor]] = None,
        knn_store=None,
        projection_params=None,
        pe_cache=None,
        device="cuda",
        mesh=None,
    ):
        """`clip_state_dict`: the frozen CLIP's HF-named state dict;
        `teacher_state_dict`: a `cross_modal_attention.*` state dict to
        start from, else random weights drawn from `cfg.seed`
        (`models.weights.random_teacher_state_dict`); `pe_cache`: a
        `TeacherTargetCache` for the frozen patch embeddings;
        `knn_store`: an `EmbeddingStore` for the k-NN gate;
        `projection_params`: an `ImageProjectionModule` state dict for its
        projection branch; `mesh`: a `parallel.mesh.Mesh` (default
        `make_mesh(cfg.mesh)`). Everything is copied to `device` in f32,
        rank 0's under a process group."""
        self.clip_config = clip_config or CLIPConfig.from_name(cfg.clip_model)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh)
        tp = model_axis(self.mesh)
        if tp is not None:  # before any tensor is sharded
            clip_divisibility_check(self.clip_config, tp)
        self.device = resolve_device(device)
        cfg = self.cfg = resolve_fast_paths(cfg, self.device)
        self._dtype = resolve_dtype(cfg.compute_dtype, self.device)
        self._use_kernels = bool(cfg.use_pallas)
        if self._use_kernels and self.device.type == "cuda" and self._dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels compute in bfloat16: use compute_dtype "
                             "'bfloat16' (or 'auto'), or use_pallas=False")
        clip_sd = {k: v.detach().to(self.device, torch.float32, copy=True)
                   for k, v in clip_state_dict.items()}
        broadcast_(clip_sd.values(), self.mesh)
        if tp is not None:
            clip_sd = shard_clip_params(clip_sd, tp)
        self.clip_state_dict = clip_state_dict
        self.clip = CLIPModule(self.clip_config, dtype=self._dtype, device="meta",
                               fused_attention=self._use_kernels, mesh=tp)
        self.clip.load_state_dict(clip_sd, strict=True, assign=True)
        self.clip.requires_grad_(False).eval()
        self._frozen_image_features = None
        if self._use_kernels:
            packed = vit_block.pack_vision_weights(self.clip_config, clip_sd, self._dtype, tp)
            ccfg = self.clip_config
            self._frozen_image_features = (
                lambda px: vit_block.fused_image_features(ccfg, packed, px))

        if teacher_state_dict is None:
            teacher_state_dict = random_teacher_state_dict(cfg.teacher, cfg.seed)
        self.teacher = PatchTextAggregation(cfg.teacher, device="meta")
        teacher_sd = {k: v.detach().to(self.device, torch.float32, copy=True)
                      for k, v in teacher_state_dict.items()}
        broadcast_(teacher_sd.values(), self.mesh)
        self.teacher.load_state_dict(teacher_sd, strict=True, assign=True)
        self._mask = pattern_mask([n for n, _ in self.teacher.named_parameters()],
                                  cfg.trainable_patterns)
        for name, p in self.teacher.named_parameters():
            p.requires_grad_(self._mask[name])
        n_train, n_total = count_trainable(self._mask)
        print(f"Teacher trainable leaves: {n_train}/{n_total}")
        self.optimizer = make_optimizer(
            [p for n, p in self.teacher.named_parameters() if self._mask[n]],
            cfg.learning_rate, kind="adam", accumulate_steps=cfg.gradient_accumulation)
        self._train_step = make_train_step(self._loss, self.teacher, self.optimizer, self.mesh)
        self.step = 0
        self._compact = bool(cfg.compact_patches)
        self._init_knn_gate(knn_store, projection_params, cfg.teacher.embed_dim)
        self.pe_cache = pe_cache
        if pe_cache is not None and not pe_cache.salt:
            # Everything that determines the (gated) patch embeddings.
            pe_cache.salt = fingerprint_objects(repr(cfg.teacher), cfg.clip_model,
                                                self.clip_state_dict, self._knn_keys,
                                                self._knn_values, self._projection_params)
        # Device-resident level 0 in front of the host pe cache: an epoch-1
        # hit costs one [B] index upload instead of the rows' copy.
        self._dev_pe = None
        if resolve_device_cache(cfg.device_target_cache, pe_cache):
            self._dev_pe = DeviceTargetCache(
                (cfg.teacher.max_patches, cfg.teacher.embed_dim), self._dtype,
                cfg.device_cache_mb * (1 << 20), self.device)

    # -- loss ----------------------------------------------------------------------

    def _loss(self, pe: torch.Tensor, batch):
        """pe (frozen patch embeddings) comes from `_patch_embeddings`: no
        gradient reaches the region encode or the CLIP."""
        with torch.no_grad():
            te, tmask = encode_tokens(self.clip, batch["input_ids"], batch["attention_mask"],
                                      self.clip_config.text.eos_token_id)
        te, pe = te.to(self._dtype), pe.to(self._dtype)
        box_mask = batch["box_mask"]
        if self._use_kernels:
            use_masks = self.cfg.teacher.mask_padding
            at, ai = cross_attention_trainable(
                dict(self.teacher.cross_modal_attention.named_parameters()), te, pe,
                tmask if use_masks else None, box_mask if use_masks else None,
                self.cfg.teacher.num_heads)
            out = aggregate_attended(self.cfg.teacher, at, ai, tmask, box_mask)
        else:
            out = self.teacher(te, pe, tmask, box_mask)
        text = masked_mean(te, tmask)
        if self.mesh.distributed:
            loss = info_nce_global(out.global_embedding, text, self.mesh, self.cfg.temperature)
        else:
            loss = info_nce(out.global_embedding, text, self.cfg.temperature)
        return loss, {"loss": loss, "contrastive_loss": loss}

    # -- BaseTrainer hooks -------------------------------------------------------------

    def _num_epochs(self) -> int:
        return self.cfg.epochs

    def _patch_embeddings(self, batch, device_batch) -> torch.Tensor:
        """[B, P, D] in the compute dtype through the cache levels (module
        docstring); on a miss the region fields are added to
        `device_batch`."""
        d = batch.as_dict() if hasattr(batch, "as_dict") else dict(batch)
        keys = None
        if self.pe_cache is not None:
            keys = self.pe_cache.pe_keys_for(d)
            if keys is not None:
                if self._dev_pe is not None:
                    hit = self._dev_pe.get(keys)
                    if hit is not None:
                        return hit
                cached = self.pe_cache.get_batch(keys)
                if cached is not None:
                    pe = torch.from_numpy(np.asarray(cached, np.float32)).to(
                        self.device, self._dtype)
                    if self._dev_pe is not None:
                        self._dev_pe.put(keys, pe)  # promote: later epochs stay on device
                    return pe
        device_batch.update(self._device_batch(d, self._REGION_FIELDS))
        with torch.no_grad():
            pe = budgeted_patch_encode(self.clip, self.clip_config, d, device_batch,
                                       self._compact, self._frozen_image_features)
            pe = self._maybe_knn_gate(pe, device_batch).to(self._dtype)
        if keys is not None:
            self.pe_cache.put_batch(keys, pe.float().cpu().numpy())
            if self._dev_pe is not None:
                self._dev_pe.put(keys, pe)
        return pe

    def train_step_on_batch(self, batch):
        """One update; returns the loss as device scalars (before the update)."""
        device_batch = self._device_batch(batch, self._LOSS_FIELDS)
        pe = self._patch_embeddings(batch, device_batch)
        with trace_span("dclip.teacher_train_step"):
            metrics = self._train_step(pe, device_batch)
        self.step += 1
        return metrics

    def eval_loss_on_batch(self, batch) -> float:
        device_batch = self._device_batch(batch, self._LOSS_FIELDS)
        pe = self._patch_embeddings(batch, device_batch)
        with torch.no_grad():
            loss, _ = self._loss(pe, device_batch)
        return float(loss)

    def checkpoint_state(self) -> dict:
        """The teacher's parameters (`cross_modal_attention.*`), the
        trainable names, the Adam state (moments, accumulator, counters)
        and the step, on the CPU."""
        return {"format": CHECKPOINT_FORMAT, "step": self.step,
                "params": {n: p.detach().cpu().clone()
                           for n, p in self.teacher.named_parameters()},
                "trainable": self._trainable_names(), "optimizer": self.optimizer.state_dict()}

    @torch.no_grad()
    def load_checkpoint_state(self, state) -> None:
        if state.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(f"not a {CHECKPOINT_FORMAT} checkpoint: {state.get('format')!r}")
        if state["trainable"] != self._trainable_names():
            raise ValueError("checkpoint's trainable parameters differ from the trainer's")
        for name, p in self.teacher.named_parameters():
            p.copy_(state["params"][name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def _trainable_names(self):
        return [n for n, _ in self.teacher.named_parameters() if self._mask[n]]


def teacher_config_summary(cfg: TeacherTrainConfig) -> str:
    """The configuration dump of `train_contrastive_teacher.py:110-123`."""
    lines = ["=== Teacher training configuration ==="]
    for f in dataclasses.fields(cfg):
        lines.append(f"{f.name}: {getattr(cfg, f.name)}")
    return "\n".join(lines)
