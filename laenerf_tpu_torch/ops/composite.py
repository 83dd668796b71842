"""Volume-rendering compositing (counterpart of laenerf_tpu/ops/composite.py).

Transmittance is exp(-cumsum(sigma * dt)); early termination is a keep-mask:
a sample contributes iff the transmittance after the previous sample was
still >= T_thresh ("accumulate, then break"). `composite_rays_train` and
`composite_chunk` (one round of the inference and distill renders) take
padded [N, S] sample grids and autograd gives their gradient, including
the depth term. The train path composites its packed samples with
`composite_rays_train_packed`: kernel K9 (csrc/composite.cu), forward
and analytic backward, on the card, and on the CPU its plain version,
which unpacks them to a padded grid for `composite_rays_train`.
"""

import torch

from ..utils.timers import count
from .cuda_build import F32, I32, I64, P, launch, on_cpu

_SOURCE = "composite.cu"


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


def composite_chunk(carry, sigmas, rgbs, dts, ts, valid, t0, T_thresh=1e-4,
                    edit=None):
    """One render round's compositing over K samples per ray: the
    inference and distill paths' accumulator.

    carry: dict with 'T' [N], 'ws' [N], 'depth' [N], 'rgb' [N, 3] (and,
    with edit flags, 'ws_edit' and 'depth_edit' [N]); returns the updated
    dict. t0 [N]: the depth origin (depth is the sum of w * (t - t0)), or
    None for the absolute depth. edit: optional [N, K] bool flags of
    samples in the edit grid, whose weights and depths are also summed
    apart.
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

    depth = ts + dts if t0 is None else (ts + dts) - t0[:, None]
    out = {
        "T": T_incl[:, -1],
        "ws": carry["ws"] + weights.sum(dim=1),
        "depth": carry["depth"] + (weights * depth).sum(dim=1),
        "rgb": carry["rgb"] + (weights[..., None] * rgbs).sum(dim=1),
    }
    if edit is not None:
        e = (edit & valid).to(weights.dtype)
        out["ws_edit"] = carry["ws_edit"] + (weights * e).sum(dim=1)
        out["depth_edit"] = (carry["depth_edit"]
                             + (weights * depth * e).sum(dim=1))
    return out


def composite_rays_train_packed(sigmas, rgbs, dts, ts, ends, counts, t0,
                                T_thresh=1e-4):
    """composite_rays_train over each ray's run of packed samples.

    Args:
      sigmas [M], rgbs [M, 3], dts, ts [M] float32: the evaluated samples,
        ray by ray and in march order within a ray (the train path's
        compaction).
      ends [N] int64: the inclusive running count of `counts`, so that ray
        r's samples were [ends[r] - counts[r], ends[r]) before the packing
        was cut at M; ray r keeps the first clamp(M - (ends[r] - counts[r]),
        0, counts[r]) of them.
      counts [N] int32: each ray's samples before the cut.
      t0 [N] float32: the march origin (depth is relative to it).
    Returns:
      weights_sum [N], depth [N], image [N, 3], as composite_rays_train
      gives them over a padded grid of those samples; differentiable in
      sigmas and rgbs.

    On CUDA tensors this launches K9's forward, and its backward when the
    gradient is taken, each counted in `composite_rays_train_packed.launches`
    and `composite_rays_train_packed_backward.launches` (and the tracer's
    counters of the same names); on CPU tensors it runs
    `composite_rays_train_packed_plain`.
    """
    args = [t.contiguous() for t in (sigmas, rgbs, dts, ts, ends, counts,
                                     t0)]
    _check_packed(*args)
    if on_cpu("composite_rays_train_packed", *args):
        return composite_rays_train_packed_plain(*args, T_thresh)
    return _CompositePacked.apply(*args, float(T_thresh))


composite_rays_train_packed.launches = 0


def _check_packed(sigmas, rgbs, dts, ts, ends, counts, t0):
    tensors = (sigmas, rgbs, dts, ts, ends, counts, t0)
    M, N = sigmas.shape[0], counts.shape[0]
    want = ((M,), (M, 3), (M,), (M,), (N,), (N,), (N,))
    got = tuple(tuple(t.shape) for t in tensors)
    if got != want:
        raise ValueError(
            "composite_rays_train_packed: want sigmas [M], rgbs [M, 3], dts, "
            f"ts [M], ends, counts, t0 [N], got {list(got)}")
    if any(t.dtype != torch.float32 for t in tensors[:4] + (t0,)) \
            or ends.dtype != torch.int64 or counts.dtype != torch.int32:
        raise TypeError("composite_rays_train_packed: samples and t0 must be "
                        "float32, ends int64, counts int32")


class _CompositePacked(torch.autograd.Function):
    """K9 forward; the backward is K9's analytic backward."""

    @staticmethod
    def forward(ctx, sigmas, rgbs, dts, ts, ends, counts, t0, T_thresh):
        ctx.set_materialize_grads(False)
        N, M = counts.shape[0], sigmas.shape[0]
        ws = torch.empty((N,), dtype=torch.float32, device=sigmas.device)
        depth = torch.empty_like(ws)
        image = torch.empty((N, 3), dtype=torch.float32,
                            device=sigmas.device)
        n_open = torch.empty((N,), dtype=torch.int32, device=sigmas.device)
        if N:
            launch(_SOURCE, "composite_rays_train_packed",
                   [P] * 11 + [I32, I64, F32], sigmas, rgbs, dts, ts, ends,
                   counts, t0, ws, depth, image, n_open, N, M, T_thresh)
            composite_rays_train_packed.launches += 1
            count("composite_rays_train_packed.launches")
        ctx.save_for_backward(sigmas, rgbs, dts, ts, ends, counts, t0, ws,
                              depth, image, n_open)
        ctx.T_thresh = T_thresh
        return ws, depth, image

    @staticmethod
    def backward(ctx, g_ws, g_depth, g_image):
        if g_ws is None and g_depth is None and g_image is None:
            return (None,) * 8
        g_sigma, g_rgb = composite_rays_train_packed_backward(
            g_ws, g_depth, g_image, *ctx.saved_tensors, ctx.T_thresh)
        return g_sigma, g_rgb, None, None, None, None, None, None


def composite_rays_train_packed_backward(g_ws, g_depth, g_image, sigmas,
                                         rgbs, dts, ts, ends, counts, t0, ws,
                                         depth, image, n_open, T_thresh):
    """K9's backward launch: the gradients to sigmas [M] and rgbs [M, 3]
    from those to weights_sum, depth and image (each may be None, read as
    zero) and the forward's inputs and outputs (n_open [N] int32: 1 + the
    last sample of each ray whose keep-mask is set)."""
    N, M = counts.shape[0], sigmas.shape[0]
    g_sigma = torch.empty_like(sigmas)
    g_rgb = torch.empty_like(rgbs)
    grads = [None if g is None else g.contiguous()
             for g in (g_ws, g_depth, g_image)]
    if N and M:
        launch(_SOURCE, "composite_rays_train_packed_backward",
               [P] * 16 + [I32, I64, F32], *grads, sigmas, rgbs, dts, ts,
               ends, counts, t0, ws, depth, image, n_open, g_sigma, g_rgb, N,
               M, T_thresh)
        composite_rays_train_packed_backward.launches += 1
        count("composite_rays_train_packed_backward.launches")
    return g_sigma, g_rgb


composite_rays_train_packed_backward.launches = 0


def composite_rays_train_packed_plain(sigmas, rgbs, dts, ts, ends, counts,
                                      t0, T_thresh=1e-4):
    """Plain PyTorch version of K9 (`composite_rays_train_packed`'s
    arguments and result): each ray's kept samples unpacked to the left of
    a padded [N, K] grid, K the longest run, then composite_rays_train;
    autograd gives the gradient."""
    N, M = counts.shape[0], sigmas.shape[0]
    starts = ends - counts
    kept = torch.minimum(torch.clamp(M - starts, min=0), counts.long())
    p = torch.arange(M, device=sigmas.device)
    ray = torch.searchsorted(ends, p, right=True)
    K = int(kept.max()) if N else 0
    flat = ray * K + (p - starts[ray])

    def grid(x):
        out = x.new_zeros((N * K,) + x.shape[1:])
        return out.index_put((flat,), x).reshape((N, K) + x.shape[1:])

    valid = torch.arange(K, device=sigmas.device)[None, :] < kept[:, None]
    return composite_rays_train(grid(sigmas), grid(rgbs), grid(dts),
                                grid(ts), valid, t0, T_thresh)
