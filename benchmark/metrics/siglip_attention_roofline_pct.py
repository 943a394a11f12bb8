"""siglip_attention_roofline_pct: the least time of the SigLIP step's
attention cores (`counts_siglip.attention_least_s`: both towers, the
forward twice a layer under remat, the backward once) over the device time
of the port's attention kernels in the traced window (the forward, and the
backward's dq and dk / dv kernels, summed by kernel name), in %."""
from benchmark import counts_siglip
from benchmark.frozen import flops

UNIT = "%"
LAYER = "kernels: kernels/*.py on csrc/*.cu"
MOVES = "train_images_per_s"
FAMILIES = ("attention_fwd", "attention_dq", "attention_dkdv")


def read(summary):
    kernels = summary.get("kernels_s")
    if not kernels or summary["device_name"] not in flops.CARD_PEAKS:
        return None
    busy = sum(kernels.get(f, 0.0) for f in FAMILIES)
    if not busy:
        return None
    least = counts_siglip.attention_least_s(summary["shapes"], summary["batch"],
                                            flops.card_peaks(summary["device_name"]),
                                            2 if summary["remat"] else 1)
    return 100.0 * least * summary["steps"] / busy
