"""grad_all_reduce_ms: the device span of `dclip.grad_all_reduce` a step on
rank 0 (the one f32 all-reduce of the flattened trainable gradients over
the data group, every step), over the traced window."""
UNIT = "ms"
LAYER = "data parallel: parallel/mesh.py under train/optim.py"
MOVES = "train_images_per_s"
RANGE = "dclip.grad_all_reduce"


def read(summary):
    span = summary["ranges_s"].get(RANGE)
    return None if span is None else 1e3 * span / summary["steps"]
