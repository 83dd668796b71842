"""PNG writing with Pillow (the pipeline's image artifacts) and the
bilinear resize of the style and NPR losses."""

import numpy as np
import torch.nn.functional as F
from PIL import Image


def write_png(path, img):
    """Write a uint8 [H, W] or [H, W, 3|4] array as a PNG."""
    Image.fromarray(np.ascontiguousarray(img)).save(path)


def to_u8(img):
    """[0, 1] float image -> uint8 (clipped)."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def resize_bilinear(x, size):
    """Bilinear resize of the last two axes of x [..., H, W] to size (h, w),
    as jax.image.resize(x, (..., h, w), "bilinear") does it: half-pixel
    centres and, where it shrinks, a triangle filter widened by the scale
    (antialiasing). Differentiable."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[-2:]) == size:
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + tuple(x.shape[-2:])), size=size,
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(lead + size)
