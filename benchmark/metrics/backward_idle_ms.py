"""backward_idle_ms: the device's idle time a step named after the
backward's ranges (`dclip.backward` on the caller's thread, and
`dclip.backward.loss`, `.text` and `.vision` on autograd's): the share of
the backward that waits for the host's launches, over the traced window.

It sums the summary's `idle_gaps` under those names. That list holds the
ten largest gaps by name, so a name whose idle is smaller than the tenth
is dropped. It reads 0 when the spans ran and no gap carries their names,
and null when the trace holds none of the ranges this program version
added (`dclip.backward.*`, `dclip.cache_lookup`, `dclip.pack_text`)."""
UNIT = "ms"
LAYER = "student backward: autograd's device thread over models/clip.py and kernels/*.py"
MOVES = "train_images_per_s"
NAMES = ("dclip.backward", "dclip.backward.loss", "dclip.backward.text",
         "dclip.backward.vision")
NEW = ("dclip.backward.loss", "dclip.backward.text", "dclip.backward.vision",
       "dclip.cache_lookup", "dclip.pack_text")


def read(summary):
    if not any(n in summary["ranges_s"] for n in NEW):
        return None
    return 1e3 * sum(s for name, s in summary["idle_gaps"] if name in NAMES) / summary["steps"]
