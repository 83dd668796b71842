"""sRGB <-> linear colour conversions (counterpart of
laenerf_tpu/utils/color.py), for --color_space linear. Each takes a numpy
array or a tensor and returns the same kind."""

import numpy as np
import torch


def _lib(x):
    return torch if isinstance(x, torch.Tensor) else np


def srgb_to_linear(x):
    xp = _lib(x)
    x = xp.clip(x, 0.0, 1.0)
    return xp.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    xp = _lib(x)
    x = xp.clip(x, 0.0, 1.0)
    return xp.where(x <= 0.0031308, x * 12.92,
                    1.055 * x ** (1.0 / 2.4) - 0.055)
