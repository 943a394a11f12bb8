"""siglip_train_mfu: the SigLIP step's share of the card's bf16 peak: the
traced window's images/s times the model FLOPs of one image
(`counts_siglip.step_flops_per_image`: the default mask's GEMMs,
recomputation not counted, the text tower at its 64 computed positions),
in %."""
from benchmark import counts_siglip
from benchmark.frozen import flops

UNIT = "%"
LAYER = "the whole step"
MOVES = "train_images_per_s"


def read(summary):
    if summary["device_name"] not in flops.CARD_PEAKS:
        return None
    rate = summary["images"] / summary["window_s"]
    return (100.0 * rate * counts_siglip.step_flops_per_image(summary["shapes"])
            / flops.card_peaks(summary["device_name"]).bf16)
