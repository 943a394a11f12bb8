"""optimizer_ms: the device span of `dclip.optimizer` a step (the masked
AdamW: its launches and the gaps between them), over the traced window."""
UNIT = "ms"
LAYER = "student step: models/clip.py, kernels/distill_loss.py, train/optim.py"
MOVES = "train_images_per_s"
RANGE = "dclip.optimizer"


def read(summary):
    span = summary["ranges_s"].get(RANGE)
    return None if span is None else 1e3 * span / summary["steps"]
