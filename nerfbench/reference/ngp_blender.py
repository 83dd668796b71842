"""Plain reference of NeRF training at `configs/ngp_blender.json`: the
occupancy refresh, the train-path march, the Instant-NGP network, the
volume-rendering composite, the MSE on a random background, the backward,
Adam with its learning-rate decay and the EMA of the parameters.

It follows the program's first steps from the same start: the weights the
harness drew, the batches the harness fed, and the program's random draws
(the march's perturbation, the background colours, the refresh's cell
jitter), which it reads as inputs. `refresh` recomputes the refresh
(density grid, untrained-cell marks, threshold) and the march uses the
reference's own bits, `grid > threshold`. Only for the cells whose density
lies within a rounding of the threshold (`occupancy_bits`' band: an
untrained network puts many cells there) does it take the bits the
program marched with; a sound program's bits agree with the reference's
everywhere else. The march's stepping rule (one event a
sample or a jump over the chebyshev skip field, on the dt lattice) is a
frozen copy of the published single-cascade march as the program lays it
out (`laenerf_tpu_torch/ops/raymarch.py`), because its sample positions
depend on every float operation of the stepping.
"""

import torch

from .common import Adam, grid_encode, grid_spec, mlp, no_tf32, sh_encode

SQRT3 = 1.7320508075688772
SKIP_LEVELS = 7
MARCH_BLOCK = 32


class Net:
    """The network's leaves, in the program's `named_parameters` order."""

    LEAVES = ("encoder", "sigma_net.layers.0.weight",
              "sigma_net.layers.1.weight", "color_net.layers.0.weight",
              "color_net.layers.1.weight", "color_net.layers.2.weight")

    def __init__(self, cfg, leaves, precision):
        self.cfg = cfg
        self.spec = grid_spec(cfg)
        self.p = {k: leaves[k].clone().requires_grad_(True)
                  for k in self.LEAVES}
        self.precision = precision

    def density(self, x):
        c = self.cfg
        feats = grid_encode(self.p["encoder"], x, self.spec, c["bound"],
                            self.precision)
        h = mlp([self.p["sigma_net.layers.0.weight"],
                 self.p["sigma_net.layers.1.weight"]], feats, self.precision)
        return trunc_exp(h[:, 0]), h[:, 1:]

    def forward(self, x, d):
        sigma, geo = self.density(x)
        h = torch.cat([sh_encode(d, self.cfg["sh_degree"]), geo], dim=-1)
        rgb = torch.sigmoid(mlp([self.p[f"color_net.layers.{i}.weight"]
                                 for i in range(3)], h, self.precision))
        return sigma, rgb


class _TruncExp(torch.autograd.Function):
    """exp(x); the backward clamps x to [-15, 15] (Instant-NGP's
    trunc_exp)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)


def rays(pose, intrinsics, inds, W):
    fx, fy, cx, cy = intrinsics
    row = (inds // W).float() + 0.5
    col = (inds % W).float() + 0.5
    d = torch.stack([(col - cx) / fx, (row - cy) / fy, torch.ones_like(col)],
                    dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rays_d = d @ pose[:3, :3].T
    return pose[:3, 3].expand(rays_d.shape), rays_d


def near_far(o, d, bound, min_near):
    inv = 1.0 / d
    t1 = (-bound - o) * inv
    t2 = (bound - o) * inv
    near = torch.amax(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    miss = near > far
    big = torch.finfo(torch.float32).max
    near = torch.where(miss, big, torch.clamp(near, min=min_near))
    far = torch.where(miss, big, far)
    return near, far


def skip_field(occ):
    """Chebyshev skip field of one cascade [H, H, H]: 0 where occupied,
    k >= 1 where every cell within 2^(k-1) - 1 cells is free."""
    blocked = (occ > 0).to(torch.int8)
    field = torch.where(blocked > 0, 0, 1).to(torch.int8)
    d = blocked
    for j in range(SKIP_LEVELS - 1):
        r = 1 << j
        for axis in (0, 1, 2):
            n = d.shape[axis]
            rr = min(r, n)
            pad = list(d.shape)
            pad[axis] = rr
            z = torch.zeros(pad, dtype=torch.int8, device=d.device)
            lo = torch.cat([d.narrow(axis, rr, n - rr), z], dim=axis)
            hi = torch.cat([z, d.narrow(axis, 0, n - rr)], dim=axis)
            d = torch.maximum(d, torch.maximum(lo, hi))
        field = torch.where((d == 0) & (field > 0),
                            torch.tensor(j + 2, dtype=torch.int8,
                                         device=d.device), field)
    return field


@torch.no_grad()
def march(o, d, occ, nears, fars, noises, c):
    """Up to march_iters events a ray: ts, dts [N, S], valid [N, S], t0."""
    H = c["grid_size"]
    bound = c["bound"]
    dt_min = 2.0 * SQRT3 / c["max_steps"]
    dt_max = 2.0 * SQRT3 / H
    skip = skip_field(occ[0]).reshape(-1)
    t0 = nears + torch.clamp(nears * 0.0, dt_min, dt_max) * noises
    N, S = o.shape[0], c["march_iters"]
    rd = 1.0 / d
    face = 0.5 + 0.5 * torch.sign(d)
    mb = min(1.0, bound)
    scale = 0.5 * H / mb
    cell_world = (2.0 / H) * mb
    ts = torch.zeros((N, S), device=o.device)
    dts = torch.zeros_like(ts)
    valid = torch.zeros((N, S), dtype=torch.bool, device=o.device)
    blk = MARCH_BLOCK if S % MARCH_BLOCK == 0 and S > MARCH_BLOCK else S
    t = t0
    for i in range(S):
        if i % blk == 0 and blk < S and not bool(torch.any(t < fars)):
            break
        x = torch.clamp(o[:, 0] + t * d[:, 0], -bound, bound)
        y = torch.clamp(o[:, 1] + t * d[:, 1], -bound, bound)
        z = torch.clamp(o[:, 2] + t * d[:, 2], -bound, bound)
        dt = torch.full_like(t, dt_min)
        n = [torch.clamp((v + mb) * scale, 0.0, H - 1.0).to(torch.int32)
             for v in (x, y, z)]
        f = skip[((n[0] * H + n[1]) * H + n[2]).long()].to(torch.int32)
        occupied = f == 0
        pos = torch.stack([x, y, z], dim=-1)
        cc = torch.stack(n, dim=-1).to(torch.float32)
        tv = (((cc + face) * (2.0 / H) - 1.0) * mb - pos) * rd
        tt_fine = t + torch.clamp(torch.amin(tv, dim=-1), min=0.0)
        m = ((torch.ones_like(f) << (f - 1).clamp(min=0)) - 1).to(
            torch.float32)
        tt = torch.maximum(tt_fine, t + m * cell_world)
        n_skip = torch.floor((tt - t) / dt) + 1.0
        t_next = torch.where(occupied, t + dt,
                             t + torch.clamp(n_skip, min=1.0) * dt)
        done = t >= fars
        ts[:, i] = t
        dts[:, i] = dt
        valid[:, i] = occupied & ~done
        t = torch.where(done, t, t_next)
    return ts, dts, valid, t0


def render(net, o, d, occ, noises, bg, c):
    """Image [N, 3] of the train path: march, evaluate the first
    N * m_cap_per_ray samples in (ray, slot) order, composite."""
    bound = c["bound"]
    nears, fars = near_far(o, d, bound, c["min_near"])
    ts, dts, valid, t0 = march(o, d, occ, nears, fars, noises, c)
    N, S = valid.shape
    cap = max(N * c["m_cap_per_ray"], 2048)
    flat = valid.reshape(-1)
    order = torch.cumsum(flat.long(), 0) - 1
    keep = flat & (order < cap)
    src = torch.nonzero(keep).squeeze(1)
    pos = torch.clamp(o[:, None, :] + ts[..., None] * d[:, None, :],
                      -bound, bound).reshape(-1, 3)
    dirs = d[:, None, :].expand(N, S, 3).reshape(-1, 3)
    sigma_c, rgb_c = net.forward(pos[src], dirs[src])
    sigma = torch.zeros(N * S, device=o.device).index_put(
        (src,), sigma_c * c["density_scale"]).reshape(N, S)
    rgb = torch.zeros((N * S, 3), device=o.device).index_put(
        (src,), rgb_c).reshape(N, S, 3)
    ok = keep.reshape(N, S)
    sd = torch.where(ok, sigma * dts, 0.0)
    csum = torch.cumsum(sd, dim=1)
    T_incl = torch.exp(-csum)
    weights = (1.0 - torch.exp(-sd)) * torch.exp(-(csum - sd))
    prev_T = torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]], 1)
    weights = weights * (prev_T >= c["t_thresh"]).float()
    image = (weights[..., None] * rgb).sum(dim=1)
    return image + (1.0 - weights.sum(dim=1))[:, None] * bg


def loss_of(net, step, c, fault=None):
    """The step's MSE against the pixels composited on its background."""
    inds, pixels = step["inds"], step["pixels"]
    bg, noises = step["bg"], step["noises"]
    if fault == "half_batch":
        h = inds.shape[0] // 2
        inds, pixels, bg, noises = inds[:h], pixels[:h], bg[:h], noises[:h]
    o, d = rays(step["pose"], step["intrinsics"], inds, step["W"])
    gt = pixels[:, :3] * pixels[:, 3:] + bg * (1.0 - pixels[:, 3:])
    image = render(net, o, d, step["occupancy"], noises, bg, c)
    return torch.mean(torch.mean((image - gt) ** 2, dim=-1))


@torch.no_grad()
def mark_untrained(poses, intrinsics, c):
    """Cells seen by no camera (or in front of one closer than min_near)
    marked -1, as Instant-NGP's mark_untrained_grid: [H, H, H]."""
    H = c["grid_size"]
    fx, fy, cx, cy = intrinsics
    bound = min(1.0, c["bound"])
    half = bound / H
    r = torch.arange(H, device=poses.device)
    g = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    pts = (2.0 * g.float() / (H - 1) - 1.0) * (bound - half)
    count = torch.zeros(pts.shape[0], dtype=torch.int64, device=poses.device)
    close = torch.zeros_like(count)
    for pose in poses:
        cam = (pts - pose[:3, 3]) @ pose[:3, :3]
        z = cam[:, 2]
        vis = ((z > 0) & (cam[:, 0].abs() < cx / fx * z + half * 2)
               & (cam[:, 1].abs() < cy / fy * z + half * 2))
        count += vis.long()
        close += (vis & (z < c["min_near"])).long()
    return torch.where((count == 0) | (close > 0), -1.0, 0.0).reshape(H, H, H)


@torch.no_grad()
def refresh(net, jitter, marks, c, chunk=1 << 16):
    """The first (full) refresh from the zero grid: density at each cell's
    jittered centre, the untrained marks kept, and the occupancy threshold
    min(mean density, density_thresh). Returns (grid [H, H, H], threshold)."""
    H = c["grid_size"]
    bound = min(1.0, c["bound"])
    half = bound / H
    r = torch.arange(H, device=jitter.device)
    g = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    xyz = (2.0 * g.float() / (H - 1) - 1.0) * (bound - half) + jitter
    sig = torch.cat([net.density(xyz[s:s + chunk])[0]
                     for s in range(0, xyz.shape[0], chunk)])
    sig = (sig * c["density_scale"]).reshape(H, H, H)
    grid = torch.where((marks >= 0) & (sig >= 0),
                       torch.maximum(marks * 0.95, sig), marks)
    mean = torch.clamp(grid, min=0.0).mean()
    return grid, torch.clamp(mean, max=c["density_thresh"])


def occupancy_bits(grid, thresh, band_rel):
    """The reference's bits `grid > thresh` [H, H, H] and the band of cells
    within band_rel of the grid's largest magnitude from the threshold,
    where a rounding of the density or of the threshold may flip a bit."""
    band = (grid - thresh).abs() <= band_rel * grid.abs().max()
    return grid > thresh, band


def train(leaves, steps, refresh_in, c, precision="bf16", fault=None,
          band_rel=0.0):
    """Follow the program's first len(steps) steps.

    Args:
      leaves: the start's parameters by name (the EMA starts equal).
      steps: per step the pose, intrinsics, inds, pixels, W, the program's
        draws bg and noises, and the occupancy bits it marched with (read
        only inside the band).
      refresh_in: poses, intrinsics and the first refresh's jitter.
      precision: "bf16" as configured, "fp8" for the control.
      fault: None, or "half_batch" / "frozen" to plant a fault.
      band_rel: the band's width (`occupancy_bits`).
    Returns dict: losses [n], grad1 (first step's gradient by leaf),
      params and ema after the last step by leaf, grid and threshold of
      the first refresh, band_cells (cells in the band).
    """
    no_tf32()
    net = Net(c, leaves, precision)
    names = list(Net.LEAVES)
    params = [net.p[k] for k in names]
    ema = {k: leaves[k].clone() for k in names}
    opt = Adam(params, [c["lr"]] * len(params), (0.9, 0.99), 1e-15)
    marks = mark_untrained(refresh_in["poses"], refresh_in["intrinsics"], c)
    grid, thresh = refresh(net, refresh_in["jitter"], marks, c)
    bits, band = occupancy_bits(grid, thresh, band_rel)
    out = {"losses": [], "grid": grid, "threshold": thresh,
           "band_cells": int(band.sum())}
    for k, step in enumerate(steps):
        prog_bits = step["occupancy"][0] > 0
        step = dict(step, occupancy=torch.where(band, prog_bits, bits)[None]
                    .to(torch.uint8))
        loss = loss_of(net, step, c, fault)
        grads = torch.autograd.grad(loss, params)
        if k == 0:
            out["grad1"] = {n: g.detach() for n, g in zip(names, grads)}
        out["losses"].append(float(loss.detach()))
        if fault != "frozen":
            opt.step([g.detach() for g in grads],
                     0.1 ** min(k / c["iters"], 1.0))
            with torch.no_grad():
                for n, p in zip(names, params):
                    ema[n].mul_(0.95).add_(p, alpha=0.05)
    out["params"] = {n: p.detach() for n, p in zip(names, params)}
    out["ema"] = ema
    return out
