"""student_forward_roofline_pct: the least time of the student's image and
text forward at the step's shapes (`counts.student_forward_least_s`, the
captions at their real lengths) over the device span of
`dclip.student_step`, which holds the forward and the loss (the backward's
kernels launch outside every range), in %."""
from benchmark import counts
from benchmark.frozen import flops

UNIT = "%"
LAYER = "kernels: kernels/*.py on csrc/*.cu"
MOVES = "train_images_per_s"
RANGE = "dclip.student_step"


def read(summary):
    span = summary["ranges_s"].get(RANGE)
    if not span or summary["device_name"] not in flops.CARD_PEAKS:
        return None
    tokens, b = summary["caption_tokens"], summary["batch"]
    peaks = flops.card_peaks(summary["device_name"])
    steps = [tokens[i:i + b] for i in range(0, len(tokens), b)]
    least = sum(counts.student_forward_least_s(summary["shapes"], b, t, peaks)
                for t in steps) / len(steps)  # the pool's mean step
    return 100.0 * least * summary["steps"] / span
