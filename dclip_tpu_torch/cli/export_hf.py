"""Export a trained student checkpoint as a HuggingFace CLIP snapshot
(counterpart of `dclip_tpu/cli/export_hf.py`).

    python -m dclip_tpu_torch.cli.export_hf --model_preset vit-b-16 \
        --checkpoint checkpoints/ --out exported_clip/ \
        [--export_tokenizer_dir <dir with vocab.json+merges.txt>]

The output directory loads with `transformers.CLIPModel.from_pretrained(out)`
(and `CLIPProcessor` when --export_tokenizer_dir is given). `--checkpoint`
is a checkpoint of the port's `train.checkpoint.CheckpointManager` (a file
or a checkpoint directory, read by `cli.common.restore_student_params`).
Without it the weights named by --clip_weights are re-exported.
"""
from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    from dclip_tpu_torch.cli.common import add_model_args

    p = argparse.ArgumentParser(description="Export student weights as an HF CLIP snapshot")
    p.add_argument("--checkpoint", default=None,
                   help="CheckpointManager file or directory (trainer state or a state dict)")
    p.add_argument("--out", required=True, help="output snapshot directory")
    p.add_argument("--export_tokenizer_dir", default=None,
                   help="copy vocab.json+merges.txt from this dir into the snapshot")
    add_model_args(p)
    return p


def template_state_dict(cfg):
    """The student's parameter names, shapes and dtypes as host tensors
    (uninitialised: only `restore_student_params`' template)."""
    from dclip_tpu_torch.models.clip import CLIPModule

    return {k: torch.empty(v.shape, dtype=v.dtype)
            for k, v in CLIPModule(cfg, device="meta").state_dict().items()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from dclip_tpu_torch.core.config import CLIPConfig
    from dclip_tpu_torch.models.hf_export import save_pretrained

    cfg = CLIPConfig.from_name(args.model_preset)
    if args.checkpoint:
        from dclip_tpu_torch.cli.common import restore_student_params

        sd = restore_student_params(args.checkpoint, template_state_dict(cfg))
    elif args.clip_weights != "random":
        from dclip_tpu_torch.cli.common import load_clip

        sd = load_clip(args.model_preset, args.clip_weights, device="cpu")[1].state_dict()
    else:
        raise SystemExit("need --checkpoint or --clip_weights to export")
    save_pretrained(sd, cfg, args.out, tokenizer_dir=args.export_tokenizer_dir)
    print(f"Exported HF CLIP snapshot to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
