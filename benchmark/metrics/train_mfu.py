"""train_mfu: the whole step's share of the card's bf16 peak: the traced
window's images/s times the model FLOPs of one image (the frozen
`distill_step_flops` under the default mask's "true" convention, the
teacher's work counted only when the cell computes it, the student's text
tower at the captions' real lengths), in %."""
from benchmark.frozen import flops

UNIT = "%"
LAYER = "the whole step"
MOVES = "train_images_per_s"


def read(summary):
    if summary["device_name"] not in flops.CARD_PEAKS:
        return None
    shapes, tokens = summary["shapes"], summary["caption_tokens"]
    text_fraction = (flops.text_tokens_forward_flops(shapes, tokens)
                     / (len(tokens) * flops.text_forward_flops(shapes)))
    per_image = flops.distill_step_flops(shapes, shapes, shapes.teacher, 1,
                                         teacher_cached=summary["cached"], reference_mask=True,
                                         text_rows_fraction=text_fraction)
    rate = summary["images"] / summary["window_s"]
    return 100.0 * rate * per_image / flops.card_peaks(summary["device_name"]).bf16
