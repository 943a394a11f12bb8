"""siglip_frozen_mlp_roofline_pct: the least time of the SigLIP step's
frozen vision MLP (K6: `counts_siglip.frozen_mlp_least_s`, its LayerNorm,
fc1 with tanh-GELU, fc2, and the backward's two GEMMs and LayerNorm tail;
the forward twice a layer under remat) over the device time of the port's
GEMM and LayerNorm kernels in the traced window, summed by kernel name (on
this step they run K6 alone), in %."""
from benchmark import counts_siglip
from benchmark.frozen import flops

UNIT = "%"
LAYER = "kernels: kernels/*.py on csrc/*.cu"
MOVES = "train_images_per_s"
FAMILIES = ("gemm", "layernorm", "layernorm_bwd")


def read(summary):
    kernels = summary.get("kernels_s")
    if not kernels or summary["device_name"] not in flops.CARD_PEAKS:
        return None
    busy = sum(kernels.get(f, 0.0) for f in FAMILIES)
    if not busy:
        return None
    least = counts_siglip.frozen_mlp_least_s(summary["shapes"], summary["batch"],
                                             flops.card_peaks(summary["device_name"]),
                                             2 if summary["remat"] else 1)
    return 100.0 * least * summary["steps"] / busy
