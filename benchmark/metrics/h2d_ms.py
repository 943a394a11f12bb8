"""h2d_ms: the device span of `dclip.h2d` a step (the batch's upload from
host memory), gaps included, over the traced window."""
UNIT = "ms"
LAYER = "trainer: train/distill_trainer.py"
MOVES = "train_images_per_s"
RANGE = "dclip.h2d"


def read(summary):
    span = summary["ranges_s"].get(RANGE)
    return None if span is None else 1e3 * span / summary["steps"]
