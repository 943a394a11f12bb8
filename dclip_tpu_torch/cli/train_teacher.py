"""Teacher training CLI (counterpart of `dclip_tpu/cli/train_teacher.py:34-242`):
the reference's `train_contrastive_teacher.py` contract.

    python -m dclip_tpu_torch.cli.train_teacher --train_file corpus_train.json \
        --epochs 5 --batch_size 32 --learning_rate 1e-5 \
        --output_path models/teacher_contrastive [--val_file ...] \
        [--detection_cache cache/corpus_train_precache.npz] [--device cuda|cpu] \
        [model flags]

The val file defaults to the train file with "_train" -> "_val" in its
name. One checkpoint per epoch (`train.checkpoint.CheckpointManager`,
`save_top_k=0`: every epoch kept), named with its val loss; the best is
printed at the end; `--resume` starts after the latest. `--pe_cache`
('memory' or a native store path) caches the frozen region embeddings
across epochs. `--projection_weights` is a port-format
`ImageProjectionModule` file (`models.projections`), not flax msgpack.
`--decode_backend native` decodes JPEG files with the port's libjpeg
decoder (`native/jpeg_decode.cc`), the route of a machine without PIL.
`--multihost` runs one process per card (`cli.common.init_multihost`):
each rank reads its rows of every global batch of `--batch_size`, only
rank 0 writes checkpoints and the metrics CSV, a `--pe_cache` path gets
one file per rank (`<path>.rank<r>`), and a SIGTERM to any rank stops
every rank at one step boundary with a `preempt` checkpoint and exit 0.
`--mesh_model N` shards the frozen CLIP's encoder layers over N ranks of
each model group (`parallel.tp`), which read the same rows: the group has
mesh_data x N processes.
"""
from __future__ import annotations

import argparse
import os

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
    start_processes,
    stop_processes,
)
from dclip_tpu_torch.core.config import TeacherConfig, TeacherTrainConfig
from dclip_tpu_torch.core.metrics import MetricsLogger
from dclip_tpu_torch.parallel.mesh import make_mesh
from dclip_tpu_torch.train.checkpoint import CheckpointManager
from dclip_tpu_torch.train.teacher_trainer import TeacherTrainer, teacher_config_summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the cross-modal meta-teacher")
    p.add_argument("--train_file", required=True)
    p.add_argument("--val_file", default=None)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--gradient_accumulation", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--output_path", default="models/teacher_contrastive")
    p.add_argument("--pe_cache", default=None,
                   help="cross-epoch cache of the frozen region patch embeddings (a native "
                        "store path, or 'memory'): epochs >= 1 skip the region encode")
    p.add_argument("--device_cache_mb", type=int, default=384,
                   help="device byte budget for --device_target_cache")
    add_data_args(p)
    add_model_args(p)
    add_mesh_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = start_processes(args)
    clip_cfg, clip_sd = load_clip_state_dict(args.model_preset, args.clip_weights, args.seed)
    tokenizer = load_tokenizer(args.tokenizer_dir, clip_cfg.text.max_length)

    # The reference derives val from train ("_train" -> "_val" in the base
    # name) and never lets it alias the training set.
    val_file = args.val_file
    if val_file is None:
        d, base = os.path.split(args.train_file)
        if "_train" in base:
            val_file = os.path.join(d, base.replace("_train", "_val"))
        else:
            print("No --val_file and train_file lacks '_train'; validation disabled")
            val_file = ""
    cfg = TeacherTrainConfig(
        train_file=args.train_file, val_file=val_file, epochs=args.epochs,
        batch_size=args.batch_size, gradient_accumulation=args.gradient_accumulation,
        learning_rate=args.learning_rate, output_path=args.output_path, seed=args.seed,
        teacher=TeacherConfig(embed_dim=clip_cfg.projection_dim, max_patches=args.max_patches,
                              max_text_tokens=clip_cfg.text.max_length),
        clip_model=args.model_preset, mesh=mesh_config(args), compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas, compact_patches=args.compact_patches,
        device_target_cache=args.device_target_cache, device_cache_mb=args.device_cache_mb)
    print(teacher_config_summary(cfg))

    mesh = make_mesh(cfg.mesh)
    cache = load_detection_cache(args.detection_cache)
    train_pipe = make_pipeline(args, cfg.train_file, tokenizer, cache, clip_cfg, cfg.batch_size,
                               cfg.teacher.max_patches, cfg.seed, mesh=mesh)
    # Validation keeps partial batches: a val set smaller than a batch
    # would otherwise evaluate nothing.
    val_pipe = (make_pipeline(args, cfg.val_file, tokenizer, cache, clip_cfg, cfg.batch_size,
                              cfg.teacher.max_patches, cfg.seed, drop_remainder=False,
                              mesh=mesh)
                if cfg.val_file and os.path.exists(cfg.val_file) else None)
    print(f"Training set size: {len(train_pipe.items)} samples")
    if val_pipe is not None:
        print(f"Validation set size: {len(val_pipe.items)} samples")

    pe_cache = None
    if args.pe_cache:
        from dclip_tpu_torch.train.distill_trainer import TeacherTargetCache

        pe_cache = TeacherTargetCache(
            None if args.pe_cache == "memory" else rank_path(args.pe_cache))
    trainer = TeacherTrainer(cfg, clip_sd, clip_cfg, knn_store=load_knn_store(args.knn_store),
                             projection_params=load_projection_params(
                                 args.projection_weights, cfg.teacher.embed_dim),
                             pe_cache=pe_cache, device=device, mesh=mesh)
    ckpts = CheckpointManager(os.path.dirname(cfg.output_path) or ".",
                              prefix=os.path.basename(cfg.output_path),
                              save_top_k=0)  # the teacher keeps every epoch
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
        if pe_cache is not None:
            pe_cache.close()
        stop_processes(args)
    best = ckpts.best() if trainer.is_primary else None
    if best:
        print(f"Best model: {best['path']} (val_loss={best['metrics']['val_loss']:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
