"""dp_train_mfu: `train_mfu`'s convention over rank 0's traced window, a
card: rank 0's images/s times the model FLOPs of one image (the frozen
`distill_step_flops` under the default mask, the teacher's work counted
where the cell computes it, the text tower at the captions' real lengths)
over one card's bf16 peak, in %."""
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
