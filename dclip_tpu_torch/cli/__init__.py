"""Command-line entry points: python -m dclip_tpu_torch.cli.{serve, train_teacher,
train_distill, flickr30k_eval, zero_shot_eval, karpathy}."""
