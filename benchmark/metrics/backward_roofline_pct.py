"""backward_roofline_pct: the least time of the student's backward at the
step's shapes over the summed device spans of `dclip.backward.loss`,
`.text` and `.vision`, in %.

The least time is the larger of the operations over the bf16 peak and
the bytes over the memory peak. The operations are the frozen masked step
(`flops.student_step_flops_masked`) less the student's forward: per image
the vision tower's dX chain down to layer 0 and the attention
projections' and the visual projection's weight gradients, and twice the
text forward over the captions at their real lengths
(`flops.text_tokens_forward_flops`), averaged over the pool's steps as
`student_forward_roofline_pct` averages. The bytes are the student's
weights read once in bf16 and the trainable leaves' gradients written once
in f32 (the leaves are f32)."""
from benchmark import counts
from benchmark.frozen import flops

UNIT = "%"
LAYER = "kernels: kernels/*.py on csrc/*.cu"
MOVES = "train_images_per_s"
SPANS = ("dclip.backward.loss", "dclip.backward.text", "dclip.backward.vision")


def backward_flops(shapes, batch: int, caption_tokens) -> float:
    """One step's backward operations: `batch` images, captions of the given
    token counts."""
    vision = (flops.student_step_flops_masked(shapes, text_scale=0.0)
              - flops.vision_forward_flops(shapes))
    return batch * vision + 2.0 * flops.text_tokens_forward_flops(shapes, caption_tokens)


def trainable_params(shapes) -> int:
    """The default mask's trainable elements: the vision attention
    projections and the visual projection, the whole text tower and its
    projection, the logit scale."""
    v = shapes.vision
    return (v.num_layers * (4 * v.hidden_size ** 2 + 4 * v.hidden_size)
            + v.hidden_size * shapes.projection_dim + counts.text_params(shapes) + 1)


def least_s(shapes, batch: int, caption_tokens, peaks) -> float:
    data = (2 * (counts.vision_params(shapes) + counts.text_params(shapes))
            + 4 * trainable_params(shapes))
    return max(backward_flops(shapes, batch, caption_tokens) / peaks.bf16, data / peaks.hbm)


def read(summary):
    span = sum(summary["ranges_s"].get(n, 0.0) for n in SPANS)
    if not span or summary["device_name"] not in flops.CARD_PEAKS:
        return None
    tokens, b = summary["caption_tokens"], summary["batch"]
    peaks = flops.card_peaks(summary["device_name"])
    steps = [tokens[i:i + b] for i in range(0, len(tokens), b)]
    least = sum(least_s(summary["shapes"], b, t, peaks) for t in steps) / len(steps)
    return 100.0 * least * summary["steps"] / span
