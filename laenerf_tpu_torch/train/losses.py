"""Auxiliary training losses (counterpart of laenerf_tpu/train/losses.py):
the MAPE and Huber criteria and the O(N) distortion loss of mip-NeRF 360
in its prefix-sum form (autograd of cumsum gives the suffix-sum
gradient)."""

import torch


def mape_loss(pred, target, reduction="mean"):
    """Mean absolute percentage error."""
    loss = torch.abs(pred - target) / (torch.abs(target) + 1e-2)
    return torch.mean(loss) if reduction == "mean" else loss


def huber_loss(pred, target, delta=0.1, reduction="mean"):
    """Huber: 0.5 / delta * r^2 inside delta, r - 0.5 * delta outside."""
    rel = torch.abs(pred - target)
    sqr = 0.5 / delta * rel * rel
    loss = torch.where(rel > delta, rel - 0.5 * delta, sqr)
    return torch.mean(loss) if reduction == "mean" else loss


def eff_distloss(w, m, interval):
    """O(N) distortion loss.

    Args:
      w: [B, N] volume-rendering weights.
      m: [B, N] sample midpoint distances.
      interval: scalar or [B, N] sample interval widths.
    """
    n_rays = w.shape[0] if w.dim() > 1 else 1
    w_cumsum = torch.cumsum(w, dim=-1)
    wm_cumsum = torch.cumsum(w * m, dim=-1)
    zero = torch.zeros_like(w_cumsum[..., :1])
    w_prefix = torch.cat([zero, w_cumsum[..., :-1]], dim=-1)
    wm_prefix = torch.cat([zero, wm_cumsum[..., :-1]], dim=-1)
    loss_uni = (1.0 / 3.0) * interval * w ** 2
    loss_bi = 2.0 * w * (m * w_prefix - wm_prefix)
    return (torch.sum(loss_bi) + torch.sum(loss_uni)) / n_rays
