"""backward_ms: the summed device spans of `dclip.backward.loss`,
`dclip.backward.text` and `dclip.backward.vision` a step (the student's
backward: the spans open and close on autograd's thread, which launches
its kernels), gaps included, over the traced window; null when the trace
holds none of them."""
UNIT = "ms"
LAYER = "student backward: autograd's device thread over models/clip.py and kernels/*.py"
MOVES = "train_images_per_s"
SPANS = ("dclip.backward.loss", "dclip.backward.text", "dclip.backward.vision")


def read(summary):
    found = [summary["ranges_s"][n] for n in SPANS if n in summary["ranges_s"]]
    return 1e3 * sum(found) / summary["steps"] if found else None
