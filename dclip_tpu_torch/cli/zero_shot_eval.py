"""Zero-shot eval CLI (counterpart of `dclip_tpu/cli/zero_shot_eval.py`):
the reference's `test_zero_shot_ImageNet.py` and `CIFAR_zeroshot.py` with
their in-source constants as flags, plus --device. The results files keep
the reference's names and bodies.

    python -m dclip_tpu_torch.cli.zero_shot_eval --dataset cifar10 \
        --data_dir /data/cifar --model both --checkpoint checkpoints/ \
        [--results_file cifar_zero_shot_results.txt] [--device cuda|cpu] [model flags]

--checkpoint is a checkpoint of the port's trainer (`train.checkpoint`),
or a directory of them (the latest); flax msgpack files are not read.
`--multihost` (one process per card) splits each image batch over the
ranks; the accuracies are exact, and only rank 0 prints the table and
writes the results file.
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
from dclip_tpu_torch.eval.zero_shot import (
    CIFAR_PROMPT,
    IMAGENET_PROMPT,
    embed_classnames,
    ensure_extracted,
    evaluate_zero_shot,
    format_cifar_results,
    format_imagenet_results,
    iterate_image_folder,
    iterate_preprocessed,
    load_cifar_batches,
    print_comparison_table,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Zero-shot classification evaluation")
    p.add_argument("--dataset", choices=["cifar10", "cifar100", "imagenet"], default="cifar10")
    p.add_argument("--data_dir", required=True,
                   help="CIFAR pickle-batches root or ImageFolder directory")
    p.add_argument("--model", choices=["base", "custom", "both"], default="both")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["auto", "float32", "bfloat16"],
                   help="bfloat16 on the card runs the image tower on the fused block "
                        "kernels; float32 (default) matches the reference numerics")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--mesh_data", type=int, default=1,
                   help="ranks to shard each image batch over (-1: every rank of "
                        "--multihost's group); accuracies are exact")
    p.add_argument("--results_file", default=None,
                   help="defaults to the reference filename for the dataset")
    p.add_argument("--classnames_file", default=None,
                   help="one classname per line, ordered by class index (folder names are "
                        "the default)")
    add_model_args(p, default_preset="vit-l-14")
    add_device_arg(p)
    add_multihost_arg(p)
    return p


def _batches(args, image_size):
    if args.dataset in ("cifar10", "cifar100"):
        images, labels, classnames = load_cifar_batches(args.data_dir, args.dataset)
        if args.max_images:
            images, labels = images[:args.max_images], labels[:args.max_images]
        return classnames, lambda: iterate_preprocessed(images, labels, args.batch_size,
                                                        image_size)
    data_dir = ensure_extracted(args.data_dir)
    classnames, _ = iterate_image_folder(data_dir, args.batch_size, image_size)

    def gen():
        _, it = iterate_image_folder(data_dir, args.batch_size, image_size)
        count = 0
        for pixels, labels in it:
            if args.max_images and count >= args.max_images:
                return
            count += len(labels)
            yield pixels, labels

    return classnames, gen


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
    classnames, batches = _batches(args, cfg.vision.image_size)
    if args.classnames_file:
        with open(args.classnames_file) as f:
            classnames = [line.strip() for line in f if line.strip()]
    elif args.dataset == "imagenet" and classnames and classnames[0].startswith("n0"):
        # ImageNet layouts name class dirs by WordNet id; prompts like "a
        # photo of a n01440764" are meaningless.
        print("WARNING: class directories look like WordNet ids; pass "
              "--classnames_file with one readable name per class index or "
              "accuracies will be near-random")
    prompt = CIFAR_PROMPT if args.dataset.startswith("cifar") else IMAGENET_PROMPT

    def run():
        text = embed_classnames(model, tokenizer, classnames, prompt)
        return evaluate_zero_shot(model, text, batches(), mesh=mesh)

    results = {}
    if args.model in ("base", "both"):
        print("\n==== Base CLIP Model ====")
        results["base"] = run()
    if args.model in ("custom", "both"):
        if not args.checkpoint:
            raise SystemExit("--checkpoint is required for --model custom/both")
        print("\n==== Custom Model ====")
        model.load_state_dict(restore_student_params(args.checkpoint, model.state_dict()))
        results["custom"] = run()

    if mesh is not None and not mesh.is_primary:
        return 0
    print_comparison_table({args.dataset: results})

    zero = {"top1": 0.0, "top5": 0.0}
    if args.dataset.startswith("cifar"):
        out = args.results_file or "cifar_zero_shot_results.txt"
        base = results.get("base", zero)
        custom = results.get("custom", zero)
        # The reference file reports both CIFAR sections; a one-dataset run
        # fills the evaluated one and zeroes the other.
        if args.dataset == "cifar10":
            body = format_cifar_results(base, custom, zero, zero)
        else:
            body = format_cifar_results(zero, zero, base, custom)
    else:
        out = args.results_file or "imagenet_zero_shot_results.txt"
        body = format_imagenet_results(results.get("custom", zero), results.get("base"))
    with open(out, "w") as f:
        f.write(body)
    print(f"Results written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
