"""input_idle_ms: the device's idle time a step named after the step's
input ranges (`dclip.cache_lookup`: the keys' hashing and the target
cache's levels; `dclip.pack_text`: the captions' host packing and its
uploads; `dclip.h2d`: the batch's upload): the time a step waits for its
inputs, over the traced window.

It sums the summary's `idle_gaps` under those names. That list holds the
ten largest gaps by name, so a name whose idle is smaller than the tenth
is dropped. It reads 0 when the ranges ran and no gap carries their names,
and null when the trace holds none of the ranges this program version
added (`dclip.backward.*`, `dclip.cache_lookup`, `dclip.pack_text`)."""
UNIT = "ms"
LAYER = "trainer: train/distill_trainer.py"
MOVES = "train_images_per_s"
NAMES = ("dclip.cache_lookup", "dclip.pack_text", "dclip.h2d")
NEW = ("dclip.backward.loss", "dclip.backward.text", "dclip.backward.vision",
       "dclip.cache_lookup", "dclip.pack_text")


def read(summary):
    if not any(n in summary["ranges_s"] for n in NEW):
        return None
    return 1e3 * sum(s for name, s in summary["idle_gaps"] if name in NAMES) / summary["steps"]
