"""The style image of the `laenerf_style` cell: a frozen copy of the
procedural wave that `chip_smoke.py::wave_png` and the recolor gate draw,
in place of LAENeRF's `style_images/wave_style.png`, which the repository
does not hold. The values pass through the PNG's 8-bit rounding, as the
pipeline reads the image back from that file."""

import numpy as np


def wave_image(size=256):
    """[3, size, size] float32 in [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    wave = 0.5 + 0.5 * np.sin(12 * xx + 5 * np.sin(6 * yy))
    img = np.stack([wave, 0.4 + 0.5 * wave ** 2, 0.9 - 0.6 * wave], -1)
    return np.ascontiguousarray(np.moveaxis(
        (img * 255).astype(np.uint8), -1, 0)).astype(np.float32) / 255.0
