"""Composite inputs shared by the CPU tests of the packed composite's plain
version against the padded one (tests/test_torch_ops.py) and the card tests
of K9 against the plain version (tests/test_torch_cuda.py). numpy and torch
only, no JAX.

A case is a padded grid: sigmas [N, S], rgbs [N, S, 3], dts, ts [N, S],
valid [N, S] bool, t0 [N] as numpy float32 arrays, the evaluation capacity
m_cap (None: every valid sample), and the threshold: a float, or
("csum", c) for the transmittance exp(-c) the test computes on its device,
where c is a running sum that some ray reaches exactly.
"""

import numpy as np
import torch

T_THRESH = 1e-4


def _grid(rng, lengths, S, sig_hi, gaps=True):
    """Rays with lengths[r] valid slots among S (spread with gaps)."""
    N = len(lengths)
    dts = rng.uniform(0.005, 0.05, (N, S)).astype(np.float32)
    t0 = rng.uniform(0.5, 2.5, N).astype(np.float32)
    ts = (t0[:, None] + np.cumsum(dts, axis=1) - dts).astype(np.float32)
    sig = rng.uniform(0.0, sig_hi, (N, S)).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (N, S, 3)).astype(np.float32)
    valid = np.zeros((N, S), bool)
    for r, n in enumerate(lengths):
        slots = (np.sort(rng.choice(S, n, replace=False)) if gaps
                 else np.arange(n))
        valid[r, slots] = True
    return sig, rgb, dts, ts, valid, t0


def composite_cases():
    """name -> (sigmas, rgbs, dts, ts, valid, t0, m_cap, thresh)."""
    rng = np.random.RandomState(22)
    cases = {}
    # runs across warp-sized rounds, thin enough that few stop early
    lengths = [0, 1, 31, 32, 33, 64, 65, 100, 7, 0, 2, 120]
    cases["ragged"] = _grid(rng, lengths, 128, 4.0) + (None, T_THRESH)
    # dense rays that stop mid-run (transmittance under T_thresh)
    cases["early_stop"] = _grid(rng, [90, 120, 40, 110, 75, 128], 128,
                                400.0) + (None, T_THRESH)
    # empty rays first, last and between
    cases["empty_rays"] = _grid(rng, [0, 12, 0, 0, 30, 5, 0], 48,
                                60.0) + (None, T_THRESH)
    # the capacity cuts ray 3 after 7 of its 40 samples and rays 4-5 to
    # nothing (both hold samples); ray 1 holds one sample
    lengths = [20, 1, 25, 40, 9, 33]
    cases["cut"] = _grid(rng, lengths, 64, 30.0) + (20 + 1 + 25 + 7,
                                                    T_THRESH)
    # single-sample rays, one kept of a ray the capacity cuts
    lengths = [1, 1, 0, 1, 5, 3]
    cases["single"] = _grid(rng, lengths, 8, 200.0) + (4, T_THRESH)
    # sigma * dt in sixteenths: every running sum is exact in any order, so
    # the transmittance before ray 0's sample 6 equals exp(-csum through its
    # sample 5) on both sides and that sample is kept (>=), the next not
    sig, rgb, dts, ts, valid, t0 = _grid(rng, [12, 10, 16, 4], 16, 1.0,
                                         gaps=False)
    dts[:] = 0.0625
    ts = (t0[:, None] + 0.0625 * np.arange(16)).astype(np.float32)
    sig = rng.randint(8, 40, sig.shape).astype(np.float32)
    c = float(sig[0, :6].sum() * 0.0625)
    cases["exact_thresh"] = (sig, rgb, dts, ts, valid, t0, None, ("csum", c))
    return cases


def threshold(thresh, device):
    """The case's T_thresh as a float: exp(-c) in float32 on `device`."""
    if isinstance(thresh, tuple):
        c = torch.tensor(-thresh[1], dtype=torch.float32, device=device)
        return float(torch.exp(c))
    return thresh


def packed(sig, rgb, dts, ts, valid, m_cap):
    """The padded grid's samples packed as the train path packs them:
    (sigmas, rgbs, dts, ts) [M] rows, ends [N] int64, counts [N] int32,
    and the flat slot of each packed sample."""
    from laenerf_tpu_torch.ops.compaction import packed_sample_indices

    idx = packed_sample_indices(valid, valid.numel() if m_cap is None
                                else m_cap)
    counts = valid.sum(dim=1).to(torch.int32)
    rows = [x.reshape((-1,) + x.shape[2:])[idx] for x in (sig, rgb, dts, ts)]
    return rows, torch.cumsum(counts, dim=0), counts, idx


OUTPUTS = ("weights_sum", "depth", "image")


def cotangents(N, which, seed=0):
    """Seeded cotangents of weights_sum [N], depth [N] and image [N, 3];
    None for an output `which` leaves out ("all": none)."""
    g = torch.Generator().manual_seed(seed)
    cots = [torch.randn(shape, generator=g) for shape in ((N,), (N,), (N, 3))]
    return [c if which in ("all", name) else None
            for name, c in zip(OUTPUTS, cots)]


def _loss(outs, which):
    total = 0.0
    for out, cot in zip(outs, cotangents(outs[0].shape[0], which)):
        if cot is not None:
            total = total + (out * cot.to(out.device)).sum()
    return total


def sigma_grad_scale(ts, dts, rgbs, ray, t0, which):
    """A bound on |dt * dL/dw| over packed samples (ray [M]: each one's
    ray): the size of the two terms whose difference is a sigma gradient
    (the transmittance after a sample and the weights after it), so a
    float32 rounding of either moves the gradient by ~1e-7 of this."""
    if ts.shape[0] == 0:
        return 0.0
    N = t0.shape[0]
    cw, cd, ci = (torch.zeros(N) if c is None
                  else c.abs().reshape(N, -1).sum(dim=1)
                  for c in cotangents(N, which))
    cw, cd, ci = (c.to(ts.device)[ray] for c in (cw, cd, ci))
    delta = ((ts + dts) - t0[ray]).abs()
    gw = cw + cd * delta + ci * rgbs.amax(dim=-1)
    return float((dts * gw).max())


def run_padded(case, which, device):
    """composite_rays_train over the case's padded grid, samples past the
    capacity masked out: the outputs, and the gradients to the packed
    samples' sigmas and rgbs."""
    from laenerf_tpu_torch.ops.composite import composite_rays_train

    sig, rgb, dts, ts, valid, t0, m_cap, thresh = case
    sig, rgb, dts, ts, valid, t0 = (torch.from_numpy(a).to(device) for a in
                                    (sig, rgb, dts, ts, valid, t0))
    sig.requires_grad_(True)
    rgb.requires_grad_(True)
    order = torch.cumsum(valid.reshape(-1).long(), 0).reshape(valid.shape)
    kept = valid if m_cap is None else valid & (order <= m_cap)
    outs = composite_rays_train(sig, rgb, dts, ts, kept, t0,
                                threshold(thresh, device))
    _loss(outs, which).backward()
    idx = packed(sig, rgb, dts, ts, valid, m_cap)[3]
    return ([o.detach() for o in outs], _grad(sig).reshape(-1)[idx],
            _grad(rgb).reshape(-1, 3)[idx])


def run_packed(fn, case, which, device):
    """fn (a packed composite) over the case's samples packed as the train
    path packs them: the outputs, the gradients to sigmas and rgbs, and
    sigma_grad_scale of the samples."""
    sig, rgb, dts, ts, valid, t0, m_cap, thresh = case
    sig, rgb, dts, ts, valid, t0 = (torch.from_numpy(a).to(device) for a in
                                    (sig, rgb, dts, ts, valid, t0))
    (s, c, d, t), ends, counts, idx = packed(sig, rgb, dts, ts, valid,
                                             m_cap)
    s, c = s.requires_grad_(True), c.requires_grad_(True)
    outs = fn(s, c, d, t, ends, counts, t0, threshold(thresh, device))
    _loss(outs, which).backward()
    scale = sigma_grad_scale(t, d, c.detach(), idx // valid.shape[1], t0,
                             which)
    return [o.detach() for o in outs], _grad(s), _grad(c), scale


def _grad(x):
    """x's gradient, zeros where no output reached it."""
    return torch.zeros_like(x) if x.grad is None else x.grad
