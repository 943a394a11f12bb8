"""Retrieval eval CLI (counterpart of `dclip_tpu/cli/flickr30k_eval.py`):
the reference's `eval_scripts/flickr30k_eval.py` contract (--max_images,
--model {base,custom,both}, --checkpoint) plus --dataset_json and
--device.

    python -m dclip_tpu_torch.cli.flickr30k_eval --dataset_json flickr_test.json \
        --max_images 1000 --model both --checkpoint checkpoints/ckpt_epoch0.step10.pt \
        [--device cuda|cpu] [model flags]

--checkpoint is a checkpoint of the port's trainer (`train.checkpoint`),
or a directory of them (the latest); flax msgpack files are not read.
`--multihost` (one process per card, `cli.common.init_multihost`) splits
the embedding forwards and the rank work over the ranks; the metrics are
exact, and only rank 0 prints the table.
"""
from __future__ import annotations

import argparse

from dclip_tpu_torch.cli.common import (
    add_device_arg,
    add_model_args,
    add_multihost_arg,
    eval_mesh,
    load_clip,
    load_tokenizer,
    restore_student_params,
    start_processes,
    stop_processes,
)
from dclip_tpu_torch.eval.retrieval import (
    evaluate_retrieval,
    load_eval_items,
    print_retrieval_table,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Karpathy-split retrieval evaluation")
    p.add_argument("--dataset_json", required=True)
    p.add_argument("--max_images", type=int, default=1000)
    p.add_argument("--model", choices=["base", "custom", "both"], default="both")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["auto", "float32", "bfloat16"],
                   help="bfloat16 on the card runs the image tower on the fused block "
                        "kernels; float32 (default) matches the reference numerics")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="ranks to shard the embedding forwards and the rank computation "
                        "over (-1: every rank of --multihost's group); metrics are exact")
    p.add_argument("--packed_captions", action="store_true",
                   help="caption sequence packing for the text encode (ops/packing.py): "
                        "each batch embeds as R << B dense rows, with the same numbers")
    add_model_args(p)
    add_device_arg(p)
    add_multihost_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = start_processes(args)
    try:
        return _run(args, device, eval_mesh(args))
    finally:
        stop_processes(args)


def _run(args, device, mesh) -> int:
    cfg, model = load_clip(args.model_preset, args.clip_weights, args.seed,
                           args.compute_dtype, device)
    tokenizer = load_tokenizer(args.tokenizer_dir, cfg.text.max_length)
    items = load_eval_items(args.dataset_json, args.max_images)
    print(f"Evaluating on {len(items)} images")

    results = {}
    if args.model in ("base", "both"):
        results["base"] = evaluate_retrieval(model, tokenizer, items, args.batch_size,
                                             cfg.vision.image_size, mesh=mesh,
                                             packed_captions=args.packed_captions)
    if args.model in ("custom", "both"):
        if not args.checkpoint:
            raise SystemExit("--checkpoint is required for --model custom/both")
        model.load_state_dict(restore_student_params(args.checkpoint, model.state_dict()))
        results["custom"] = evaluate_retrieval(model, tokenizer, items, args.batch_size,
                                               cfg.vision.image_size, mesh=mesh,
                                               packed_captions=args.packed_captions)
    if mesh is None or mesh.is_primary:
        print_retrieval_table(results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
