"""Writes the image fixtures of the native JPEG decoder's tests and of
`chip_smoke.py`'s files phase into this directory (needs PIL and numpy):

    python tests/data/make_jpeg_fixtures.py

Seeded smooth colour fields with a little noise, in the shapes the decoder
must serve or refuse: RGB JPEGs of even and odd, landscape and portrait
frames (640 x 480 is large enough for the scaled DCT decode at 224 px),
one true one-channel grayscale JPEG, one progressive JPEG, and two files
the decoder hands to PIL: a PNG and a CMYK JPEG. The machine with the
card has no PIL, so the files are committed; rerunning this script on
the same PIL version rewrites them byte for byte.
"""
from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (width, height, mode, save options)
FIXTURES = {
    "rgb_640x480.jpg": (640, 480, "RGB", {"quality": 85}),
    "rgb_375x500.jpg": (375, 500, "RGB", {"quality": 85}),
    "rgb_53x37.jpg": (53, 37, "RGB", {"quality": 95}),
    "rgb_224x224.jpg": (224, 224, "RGB", {"quality": 90}),
    "gray_121x90.jpg": (121, 90, "L", {"quality": 90}),
    "progressive_300x200.jpg": (300, 200, "RGB", {"quality": 85, "progressive": True}),
    "cmyk_50x40.jpg": (50, 40, "CMYK", {"quality": 90}),
    "rgb_40x30.png": (40, 30, "RGB", {}),
}
JPEGS = [n for n, (_, _, mode, _) in FIXTURES.items() if n.endswith(".jpg") and mode != "CMYK"]


def field(rng: np.random.RandomState, w: int, h: int) -> np.ndarray:
    """[h, w, 3] uint8: a random linear colour ramp, a disc, mild noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(40, 215, 3)
    slope = rng.uniform(-60, 60, (2, 3))
    img = base + (x / w)[..., None] * slope[0] + (y / h)[..., None] * slope[1]
    cx, cy, r = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h, 0.2 * min(w, h)
    disc = ((x - cx) ** 2 + (y - cy) ** 2) < r * r
    img[disc] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> int:
    from PIL import Image

    rng = np.random.RandomState(14)
    for name, (w, h, mode, opts) in FIXTURES.items():
        im = Image.fromarray(field(rng, w, h)).convert(mode)
        im.save(os.path.join(HERE, name), **opts)
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in FIXTURES)
    print(f"wrote {len(FIXTURES)} fixtures, {total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
