"""Palette imagery (counterpart of laenerf_tpu/utils/palette.py): a color
palette, and a before -> after change strip, as small PNGs written with
Pillow."""

import os

import numpy as np

from .images import write_png


def _swatch_strip(palette, swatch: int = 64, pad: int = 4):
    """[K, 3] palette -> horizontal swatch strip image (uint8)."""
    palette = np.clip(np.asarray(palette, np.float32), 0, 1)
    K = palette.shape[0]
    W = K * swatch + (K + 1) * pad
    img = np.ones((swatch + 2 * pad, W, 3), np.float32)
    for k in range(K):
        x0 = pad + k * (swatch + pad)
        img[pad:pad + swatch, x0:x0 + swatch] = palette[k]
    return (img * 255).astype(np.uint8)


def palette_to_img(palette, path, prefix: str = "palette"):
    out = os.path.join(path, f"{prefix}_palette.png")
    write_png(out, _swatch_strip(palette))
    return out


def palette_change_to_img(palette_og, palette_mod, path, prefix: str = "mod"):
    """Two stacked strips: original over modified, with a gap."""
    top = _swatch_strip(palette_og)
    bot = _swatch_strip(palette_mod)
    gap = np.full((8, top.shape[1], 3), 255, np.uint8)
    out = os.path.join(path, f"{prefix}_palette_change.png")
    write_png(out, np.concatenate([top, gap, bot], axis=0))
    return out
