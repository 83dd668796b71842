"""PNG writing with Pillow (the pipeline's image artifacts)."""

import numpy as np
from PIL import Image


def write_png(path, img):
    """Write a uint8 [H, W] or [H, W, 3|4] array as a PNG."""
    Image.fromarray(np.ascontiguousarray(img)).save(path)


def to_u8(img):
    """[0, 1] float image -> uint8 (clipped)."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)
