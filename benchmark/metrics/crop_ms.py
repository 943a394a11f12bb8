"""crop_ms: the device span of `dclip.crop` a step (every box cropped and
squash-resized for the teacher), gaps included, over the traced window."""
UNIT = "ms"
LAYER = "teacher targets: models/teacher.py, ops/image_ops.py"
MOVES = "train_images_per_s"
RANGE = "dclip.crop"


def read(summary):
    span = summary["ranges_s"].get(RANGE)
    return None if span is None else 1e3 * span / summary["steps"]
