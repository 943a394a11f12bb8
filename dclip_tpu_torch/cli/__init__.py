"""Command-line entry points (python -m dclip_tpu_torch.cli.serve)."""
