"""device_idle_pct: the share of the traced window in which no operation
ran on the device: 100 x (1 - union of the device intervals / window)."""
UNIT = "%"
LAYER = "device"
MOVES = "train_images_per_s"


def read(summary):
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
