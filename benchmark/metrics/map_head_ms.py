"""map_head_ms: the device span of `dclip.map_head` a step (the SigLIP
student's attention-pooling head: its probe against the image tokens and
its MLP, in the forward), over the traced window."""
UNIT = "ms"
LAYER = "SigLIP student: models/siglip.py"
MOVES = "train_images_per_s"
RANGE = "dclip.map_head"


def read(summary):
    span = summary["ranges_s"].get(RANGE)
    return None if span is None else 1e3 * span / summary["steps"]
