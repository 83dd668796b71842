"""Volume-rendering compositing over padded [N, S] sample grids (counterpart
of laenerf_tpu/ops/composite.py).

Transmittance is exp(-cumsum(sigma * dt)); early termination is a keep-mask:
a sample contributes iff the transmittance after the previous sample was
still >= T_thresh ("accumulate, then break"). Autograd gives the gradient,
including the depth term.
"""

import torch


def composite_rays_train(sigmas, rgbs, dts, ts, valid, t0, T_thresh=1e-4):
    """Composite padded samples into per-ray outputs.

    Args:
      sigmas: [N, S]; rgbs: [N, S, 3]; dts, ts: [N, S]; valid: [N, S] bool;
      t0: [N] march origin (depth is accumulated relative to it).
    Returns:
      weights_sum [N], depth [N], image [N, 3].
    """
    sd = torch.where(valid, sigmas * dts, 0.0)
    csum = torch.cumsum(sd, dim=1)
    T_incl = torch.exp(-csum)
    T_excl = torch.exp(-(csum - sd))
    alpha = 1.0 - torch.exp(-sd)
    weights = alpha * T_excl

    prev_T = torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]],
                       dim=1)
    weights = weights * (prev_T >= T_thresh).to(weights.dtype)

    cum_delta = (ts + dts) - t0[:, None]
    weights_sum = weights.sum(dim=1)
    depth = (weights * cum_delta).sum(dim=1)
    image = (weights[..., None] * rgbs).sum(dim=1)
    return weights_sum, depth, image


def composite_chunk(carry, sigmas, rgbs, dts, ts, valid, t0, T_thresh=1e-4):
    """One inference compositing round over K samples per ray.

    carry: dict with 'T' [N], 'ws' [N], 'depth' [N], 'rgb' [N, 3]; returns
    the updated dict.
    """
    sd = torch.where(valid, sigmas * dts, 0.0)
    csum = torch.cumsum(sd, dim=1)
    T_in = carry["T"][:, None]
    T_incl = T_in * torch.exp(-csum)
    T_excl = T_in * torch.exp(-(csum - sd))
    alpha = 1.0 - torch.exp(-sd)
    weights = alpha * T_excl

    prev_T = torch.cat([T_in, T_incl[:, :-1]], dim=1)
    weights = weights * (prev_T >= T_thresh).to(weights.dtype)

    cum_depth = (ts + dts) - t0[:, None]
    return {
        "T": T_incl[:, -1],
        "ws": carry["ws"] + weights.sum(dim=1),
        "depth": carry["depth"] + (weights * cum_depth).sum(dim=1),
        "rgb": carry["rgb"] + (weights[..., None] * rgbs).sum(dim=1),
    }
