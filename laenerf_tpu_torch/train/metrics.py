"""Quality metrics: PSNR, SSIM and LPIPS (counterpart of
laenerf_tpu/train/metrics.py).

The functions take tensors on any device; the meters take numpy images or
tensors. PSNR and SSIM compute on the CPU in f32 (evaluation renders come
back as numpy arrays); LPIPS runs its VGG-16 on the meter's device.
"""

import numpy as np
import torch
import torch.nn.functional as F


def _t(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def psnr(pred, gt):
    """PSNR over the whole batch (one mean over every element)."""
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return torch.tensor(np.outer(g, g), dtype=torch.float32)


def ssim(pred, gt, max_val=1.0):
    """SSIM with the standard 11x11 gaussian window over [H, W, C] images
    in [0, max_val] (a 'valid' depthwise filter, moments clamped so the
    index stays in [-1, 1] under f32 cancellation)."""
    k = _gaussian_kernel().to(pred.device)[None, None]
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(img):
        x = torch.movedim(img, -1, 0)[:, None]  # [C, 1, H, W]
        return torch.movedim(F.conv2d(x, k)[:, 0], 0, -1)

    mu_p, mu_g = filt(pred), filt(gt)
    mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    s_pp = torch.clamp(filt(pred * pred) - mu_pp, min=0.0)
    s_gg = torch.clamp(filt(gt * gt) - mu_gg, min=0.0)
    s_pg = filt(pred * gt) - mu_pg
    bound = torch.sqrt(s_pp * s_gg)
    s_pg = torch.maximum(torch.minimum(s_pg, bound), -bound)
    num = (2 * mu_pg + c1) * (2 * s_pg + c2)
    den = (mu_pp + mu_gg + c1) * (s_pp + s_gg + c2)
    return torch.mean(num / den)


class Meter:
    """Running average of a metric over evaluation images."""

    def __init__(self, fn, name):
        self.fn = fn
        self.name = name
        self.clear()

    def clear(self):
        self.vals = []

    def update(self, pred, gt):
        self.vals.append(float(self.fn(_t(pred), _t(gt))))

    def measure(self):
        return float(np.mean(self.vals)) if self.vals else 0.0

    def report(self):
        return f"{self.name} = {self.measure():.6f}"


def psnr_meter():
    return Meter(psnr, "PSNR")


def ssim_meter():
    return Meter(ssim, "SSIM")


class LPIPSMeter:
    """LPIPS through the VGG-16 port (editing/vgg.py::lpips_fn), computed
    on `device`; `available` only with local VGG-16 weights, and without
    them it records nothing and reports n/a."""

    name = "LPIPS"

    def __init__(self, device="cuda"):
        # imported here: editing.vgg imports train.trainer, which imports
        # this module
        from ..editing.vgg import lpips_fn

        self.device = torch.device(device)
        self.vals = []
        try:
            self._fn = lpips_fn(device=self.device)
        except RuntimeError:  # no local VGG-16 weights
            self._fn = None

    @property
    def available(self):
        return self._fn is not None

    def clear(self):
        self.vals = []

    @torch.no_grad()
    def update(self, pred, gt):
        if self._fn is None:
            return
        a, b = (_t(x).to(self.device) for x in (pred, gt))
        self.vals.append(float(self._fn(a, b)))

    def measure(self):
        return float(np.mean(self.vals)) if self.vals else 0.0

    def report(self):
        if not self.available:
            return "LPIPS = n/a (no local VGG weights)"
        return f"LPIPS = {self.measure():.6f}"
