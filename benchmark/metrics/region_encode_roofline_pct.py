"""region_encode_roofline_pct: the least time of the teacher image tower's
forward over the step's B x P crops (`counts.region_encode_least_s` at the
card's peaks) over the device span of `dclip.region_encode`, in %."""
from benchmark import counts
from benchmark.frozen import flops

UNIT = "%"
LAYER = "kernels: kernels/*.py on csrc/*.cu"
MOVES = "train_images_per_s"
RANGE = "dclip.region_encode"


def read(summary):
    span = summary["ranges_s"].get(RANGE)
    if not span or summary["device_name"] not in flops.CARD_PEAKS:
        return None
    shapes = summary["shapes"]
    crops = summary["batch"] * shapes.teacher.max_patches
    least = counts.region_encode_least_s(shapes, crops, flops.card_peaks(summary["device_name"]))
    return 100.0 * least * summary["steps"] / span
