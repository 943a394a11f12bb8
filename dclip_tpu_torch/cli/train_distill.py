"""Student distillation CLI (counterpart of `dclip_tpu/cli/train_distill.py:34-318`):
the reference's `CLIP_image_distill_training.py` contract.

    python -m dclip_tpu_torch.cli.train_distill --train_file corpus_train.json \
        --val_file corpus_val.json --train_batch_size 32 --eval_batch_size 32 \
        --learning_rate 2e-5 --warmup_steps 100 --total_steps 10000 \
        --phase1_epochs 2 --checkpoint_dir checkpoints \
        --teacher_checkpoint models/teacher_contrastive_epoch4_val1.2345.step50.pt \
        [--device cuda|cpu] [model flags]

`--teacher_checkpoint` is a checkpoint of `cli.train_teacher` (read by
`cli.common.restore_student_params`), a directory of them (the latest),
or a torch `.pth` / `.bin` state dict of the reference teacher (its
`cross_modal_attention.*` keys); without one the teacher starts from
seeded random weights. Checkpoints: `CheckpointManager(checkpoint_dir,
prefix="distill", save_top_k=10, monitor="train_loss")`. `--remat`
recomputes each encoder layer's activations in the backward
(`torch.utils.checkpoint`, the JAX CLI's `nn.remat`); `--tiled_frozen_mlp`
is accepted and changes nothing, since K6 tiles at every width.
`--projection_weights` reads a port-format file; `--decode_backend native`
and `--multihost` behave as in `cli.train_teacher` (a `--teacher_cache`
path gets one file per rank: the cache keys come from the rank's own
rows). `--mesh_model N` trains over a (mesh_data, N) grid of ranks: the
student's and the teacher CLIP's encoder layers sharded over each model
group (`parallel.tp`); checkpoints hold the whole tensors. `--model_preset
vit-l-14` gives the reference's L/14 run: `TeacherConfig(embed_dim=768)`.
"""
from __future__ import annotations

import argparse
import os

import torch

from dclip_tpu_torch.cli.common import (
    add_data_args,
    add_device_arg,
    add_mesh_args,
    add_model_args,
    fit_with_preemption,
    load_clip_state_dict,
    load_detection_cache,
    load_knn_store,
    load_projection_params,
    load_tokenizer,
    make_pipeline,
    mesh_config,
    rank_path,
    restore_student_params,
    start_processes,
    stop_processes,
)
from dclip_tpu_torch.core.config import DistillConfig, TeacherConfig
from dclip_tpu_torch.core.metrics import MetricsLogger
from dclip_tpu_torch.models.weights import random_teacher_state_dict
from dclip_tpu_torch.parallel.mesh import make_mesh
from dclip_tpu_torch.train.checkpoint import CheckpointManager
from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Distill the meta-teacher into a CLIP student")
    p.add_argument("--train_file", required=True)
    p.add_argument("--val_file", default=None)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--total_steps", type=int, default=1000)
    p.add_argument("--phase1_epochs", type=int, default=2)
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--accumulate_grad_batches", type=int, default=4)
    p.add_argument("--gradient_clip_val", type=float, default=0.5)
    p.add_argument("--teacher_checkpoint", default=None,
                   help="the meta-teacher: a cli.train_teacher checkpoint (or directory), "
                        "or a torch .pth state dict of the reference teacher")
    p.add_argument("--student_preset", default=None,
                   help="student CLIP preset (default: same as --model_preset)")
    p.add_argument("--student_weights", default=None,
                   help="student weights source (default: same as --clip_weights)")
    p.add_argument("--teacher_cache", default=None,
                   help="cross-epoch teacher-target cache (a native store path, or 'memory')")
    p.add_argument("--fused_text_mlp", action="store_true",
                   help="the student text tower's LN2 + MLP on the trainable kernel (K8)")
    p.add_argument("--packed_text", action=argparse.BooleanOptionalAction, default=None,
                   help="caption sequence packing for the student text tower (auto: on CUDA)")
    p.add_argument("--device_cache_mb", type=int, default=512,
                   help="device byte budget for --device_target_cache")
    p.add_argument("--tiled_frozen_mlp", action="store_true",
                   help="accepted for the JAX CLI's contract; K6 tiles at every width")
    p.add_argument("--remat", action="store_true",
                   help="recompute each encoder layer's activations in the backward "
                        "(less device memory, one more forward per layer)")
    p.add_argument("--unfreeze_text_at_epoch", type=int, default=None,
                   help="freeze the student text encoder until this epoch")
    add_data_args(p)
    add_model_args(p)  # the teacher CLIP
    add_mesh_args(p)
    add_device_arg(p)
    return p


def load_teacher_state_dict(path, teacher_cfg, seed):
    """The meta-teacher's `cross_modal_attention.*` state dict from a
    `cli.train_teacher` checkpoint or a reference `.pth`, else seeded
    random weights (`dclip_tpu/cli/train_distill.py:134-160`)."""
    template = random_teacher_state_dict(teacher_cfg, seed)
    if not path:
        print("Warning: no teacher checkpoint given, using fresh teacher init")
        return template
    if path.endswith((".pth", ".bin")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        missing = sorted(set(template) - set(sd))
        if missing:
            raise ValueError(f"{path}: not a teacher state dict: missing {missing[:5]}")
        return {k: sd[k].float() for k in template}  # its other keys are frozen parts
    return restore_student_params(path, template)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = start_processes(args)
    teacher_clip_cfg, teacher_clip_sd = load_clip_state_dict(args.model_preset,
                                                             args.clip_weights, args.seed)
    student_preset = args.student_preset or args.model_preset
    student_weights = args.student_weights or args.clip_weights
    if (student_preset, student_weights) == (args.model_preset, args.clip_weights):
        student_cfg, student_sd = teacher_clip_cfg, teacher_clip_sd
    else:
        student_cfg, student_sd = load_clip_state_dict(student_preset, student_weights,
                                                       args.seed)
    tokenizer = load_tokenizer(args.tokenizer_dir, student_cfg.text.max_length)
    if student_cfg.projection_dim != teacher_clip_cfg.projection_dim:
        raise SystemExit(
            f"student preset '{student_preset}' (projection_dim {student_cfg.projection_dim}) "
            f"is width-incompatible with the teacher CLIP '{args.model_preset}' "
            f"(projection_dim {teacher_clip_cfg.projection_dim}); the cosine distillation "
            "loss requires matching widths: pick matching presets")
    teacher_cfg = TeacherConfig(embed_dim=teacher_clip_cfg.projection_dim,
                                max_patches=args.max_patches,
                                max_text_tokens=teacher_clip_cfg.text.max_length)
    cfg = DistillConfig(
        train_file=args.train_file, val_file=args.val_file,
        train_batch_size=args.train_batch_size, eval_batch_size=args.eval_batch_size,
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        total_steps=args.total_steps, phase1_epochs=args.phase1_epochs,
        checkpoint_dir=args.checkpoint_dir, gradient_clip_val=args.gradient_clip_val,
        accumulate_grad_batches=args.accumulate_grad_batches, seed=args.seed,
        student_model=student_preset, teacher_clip_model=args.model_preset, teacher=teacher_cfg,
        mesh=mesh_config(args), compute_dtype=args.compute_dtype, use_pallas=args.use_pallas,
        remat=args.remat, compact_patches=args.compact_patches,
        fused_text_mlp=args.fused_text_mlp, packed_text=args.packed_text,
        tiled_frozen_mlp=args.tiled_frozen_mlp, device_target_cache=args.device_target_cache,
        device_cache_mb=args.device_cache_mb, unfreeze_text_at_epoch=args.unfreeze_text_at_epoch)
    teacher_sd = load_teacher_state_dict(args.teacher_checkpoint, teacher_cfg, args.seed)
    mesh = make_mesh(cfg.mesh)
    cache = load_detection_cache(args.detection_cache)
    train_pipe = make_pipeline(args, cfg.train_file, tokenizer, cache, student_cfg,
                               cfg.train_batch_size, teacher_cfg.max_patches, cfg.seed, mesh=mesh)
    val_pipe = (make_pipeline(args, cfg.val_file, tokenizer, cache, student_cfg,
                              cfg.eval_batch_size, teacher_cfg.max_patches, cfg.seed,
                              drop_remainder=False, mesh=mesh)
                if cfg.val_file and os.path.exists(cfg.val_file) else None)
    teacher_cache = None
    if args.teacher_cache:
        teacher_cache = TeacherTargetCache(
            None if args.teacher_cache == "memory" else rank_path(args.teacher_cache))
    trainer = DistillTrainer(cfg, student_sd, teacher_clip_sd, teacher_sd, student_cfg,
                             teacher_clip_cfg, device=device, teacher_cache=teacher_cache,
                             knn_store=load_knn_store(args.knn_store),
                             projection_params=load_projection_params(
                                 args.projection_weights, cfg.teacher.embed_dim), mesh=mesh)
    ckpts = CheckpointManager(cfg.checkpoint_dir, prefix="distill", save_top_k=cfg.save_top_k,
                              monitor="train_loss")  # ModelCheckpoint(monitor="train_loss")
    start_epoch = trainer.resume(ckpts) if args.resume else 0
    # Every rank prints its log lines; only the primary writes the CSV.
    logger = MetricsLogger(args.metrics_csv if trainer.is_primary else None,
                           print_every=cfg.log_every)
    try:
        fit_with_preemption(trainer, train_pipe, val_pipe, ckpts, logger, start_epoch)
    finally:
        logger.close()
        for pipe in (train_pipe, val_pipe):
            if pipe is not None:
                pipe.close()
        if teacher_cache is not None:
            teacher_cache.close()
        stop_processes(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
