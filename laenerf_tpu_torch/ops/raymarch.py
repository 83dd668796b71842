"""Occupancy-grid ray marching (counterpart of laenerf_tpu/ops/raymarch.py).

Same design as the JAX package: a fixed budget of "march events" per ray,
vectorized over all rays; each event either takes a sample (the occupancy
grid is hit) or jumps past empty space using the chebyshev skip field. The
JAX `lax.scan` becomes a Python loop over events, in blocks of 32 with an
"any ray alive" check between blocks; exiting early changes no numbers and
bounds the host syncs. Every event is a handful of small tensor ops, so on
the card this loop is launch-bound; a march kernel is later work.

Zero direction components rely on IEEE 1/0 = inf, as in the JAX package.
"""

import dataclasses

import torch

SQRT3 = 1.7320508075688772
SKIP_LEVELS = 7  # max safe jump = 2^(SKIP_LEVELS-1) - 1 = 63 cells
MARCH_BLOCK = 32  # events between "any ray alive" checks


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static marching configuration."""

    bound: float = 1.0
    cascades: int = 1
    grid_size: int = 128
    dt_gamma: float = 0.0
    max_steps: int = 1024  # sets dt_min = 2*sqrt(3)/max_steps
    # event budget == padded sample-grid width S
    march_iters: int = 256

    @property
    def dt_min(self) -> float:
        return 2.0 * SQRT3 / self.max_steps

    @property
    def dt_max(self) -> float:
        return 2.0 * SQRT3 * (2 ** (self.cascades - 1)) / self.grid_size


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.2):
    """Ray/AABB slab test. aabb: [6] (xmin, ymin, zmin, xmax, ymax, zmax).
    Returns nears, fars [N]; missing rays get near == far == float32 max."""
    rdir = 1.0 / rays_d  # inf where a component is 0 is fine for slab tests
    t1 = (aabb[:3] - rays_o) * rdir
    t2 = (aabb[3:] - rays_o) * rdir
    near = torch.amax(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    miss = near > far
    big = torch.finfo(rays_o.dtype).max
    near = torch.clamp(near, min=min_near)
    near = torch.where(miss, big, near)
    far = torch.where(miss, big, far)
    return near, far


def _mip_level(x, y, z, dt, cfg: MarchConfig):
    """max(mip_from_pos, mip_from_dt) clamped to [0, cascades-1]; frexp's
    exponent equals floor(log2(v)) + 1 for v > 0."""
    mx_pos = torch.maximum(x.abs(), torch.maximum(y.abs(), z.abs()))
    mx_dt = dt * cfg.grid_size * 0.5

    def frexp_exp(v):
        return torch.floor(torch.log2(v.clamp(min=1e-30))).to(torch.int32) + 1

    lvl = torch.maximum(frexp_exp(mx_pos), frexp_exp(mx_dt))
    return lvl.clamp(0, cfg.cascades - 1)


def _cross_level_blocked(occ):
    """Union of all cascades' occupancy expressed in each level's cells:
    blocked[l, c] == 1 iff level l's cell c is occupied at level l or its
    world region overlaps an occupied cell of any other level."""
    CAS, H = occ.shape[0], occ.shape[1]
    out = []
    for lv in range(CAS):
        b = occ[lv].clone()
        for lp in range(CAS):
            k = abs(lv - lp)
            f = 1 << k
            if lp == lv or f > H:
                continue
            m = H // f
            pad = (H - m) // 2
            if lp < lv:
                # finer level covers the central m^3 cells: max-pool by f
                small = occ[lp].reshape(m, f, m, f, m, f).amax(dim=(1, 3, 5))
                region = b[pad:pad + m, pad:pad + m, pad:pad + m]
                b[pad:pad + m, pad:pad + m, pad:pad + m] = torch.maximum(
                    region, small)
            else:
                # coarser level: its central m^3 cells span this level's
                # whole extent — upsample by repetition
                center = occ[lp][pad:pad + m, pad:pad + m, pad:pad + m]
                big = (center.repeat_interleave(f, 0)
                       .repeat_interleave(f, 1).repeat_interleave(f, 2))
                b = torch.maximum(b, big)
        out.append(b)
    return torch.stack(out)


def build_skip_field(occupancy, bound=None):
    """Chebyshev distance-to-surface field, int8 [CAS, H, H, H].

    field[c] == 0: cell c is occupied (sample there); field[c] == k >= 1:
    every cell within L-inf radius 2^(k-1) - 1 is free, so a ray may advance
    that many cell widths in one event. Built by doubling dilation. At
    cascades > 1 the distances use the cross-level union (power-of-two
    bounds) or degrade to single-cell steps.
    """
    occ = (occupancy > 0).to(torch.int8)
    CAS, H = occ.shape[0], occ.shape[1]
    multi = CAS > 1
    exact = (bound is not None and float(bound) == float(2 ** (CAS - 1))
             and (H & (H - 1)) == 0
             and all((1 << k) <= H for k in range(CAS)))
    one = torch.ones((), dtype=torch.int8, device=occ.device)
    zero = torch.zeros((), dtype=torch.int8, device=occ.device)
    if multi and exact:
        blocked = _cross_level_blocked(occ)
    elif multi:
        return torch.where(occ > 0, zero, one)
    else:
        blocked = occ
    field = torch.where(blocked > 0, zero, one)

    # out-of-grid padding: free (0) for the top level, blocked (1) for inner
    # levels, whose boundary is interior space covered by coarser grids
    if multi:
        edge = torch.tensor([1] * (CAS - 1) + [0], dtype=torch.int8,
                            device=occ.device)

        def pad_block(shape):
            return edge.reshape(CAS, 1, 1, 1).expand(shape)
    else:
        def pad_block(shape):
            return torch.zeros(shape, dtype=torch.int8, device=occ.device)

    def dilate_axis(d, axis, r):
        r = min(r, d.shape[axis])  # shift >= H pushes everything out
        pad_shape = [s if a != axis else r for a, s in enumerate(d.shape)]
        n = d.shape[axis]
        lo = torch.cat([d.narrow(axis, r, n - r), pad_block(pad_shape)],
                       dim=axis)
        hi = torch.cat([pad_block(pad_shape), d.narrow(axis, 0, n - r)],
                       dim=axis)
        return torch.maximum(d, torch.maximum(lo, hi))

    d = blocked
    for j in range(SKIP_LEVELS - 1):
        r = 1 << j
        for axis in (1, 2, 3):
            d = dilate_axis(d, axis, r)
        lvl = torch.full((), j + 2, dtype=torch.int8, device=occ.device)
        field = torch.where((d == 0) & (field > 0), lvl, field)
    if multi:
        # cells blocked only by another level advance one cell, never sample
        field = torch.where((occ == 0) & (field == 0), one, field)
    return field


def make_march_event(rays_o, rays_d, skip_flat, cfg: MarchConfig):
    """Per-event march closure with per-ray invariants hoisted.

    Returns event(t) -> (t_next, (ts, dt, occ)), all [N]: one skip-field
    lookup per event; occupied cells take a sample and advance dt, empty ones
    jump on the dt lattice.
    """
    H = cfg.grid_size
    bound = cfg.bound
    dt_min, dt_max = cfg.dt_min, cfg.dt_max
    gamma = cfg.dt_gamma
    single_level = cfg.cascades == 1

    rd = 1.0 / rays_d
    sgn = torch.sign(rays_d)
    ox, oy, oz = rays_o[:, 0], rays_o[:, 1], rays_o[:, 2]
    dx, dy, dz = rays_d[:, 0], rays_d[:, 1], rays_d[:, 2]
    face = 0.5 + 0.5 * sgn  # exit-face bias per axis

    def event(t):
        x = torch.clamp(ox + t * dx, -bound, bound)
        y = torch.clamp(oy + t * dy, -bound, bound)
        z = torch.clamp(oz + t * dz, -bound, bound)

        if gamma == 0.0:
            dt = torch.full_like(t, dt_min)
        else:
            dt = torch.clamp(t * gamma, dt_min, dt_max)

        if single_level:
            mb = min(1.0, bound)
            scale = 0.5 * H / mb

            def cell(v):
                return torch.clamp((v + mb) * scale, 0.0, H - 1.0).to(
                    torch.int32)

            nx, ny, nz = cell(x), cell(y), cell(z)
            flat_idx = (nx * H + ny) * H + nz
            mip_mul = mb
        else:
            level = _mip_level(x, y, z, dt, cfg)
            mip_bound = torch.clamp(torch.exp2(level.to(torch.float32)),
                                    max=bound)
            inv_mb = 1.0 / mip_bound

            def cell(v):
                return torch.clamp(0.5 * (v * inv_mb + 1.0) * H, 0.0,
                                   H - 1.0).to(torch.int32)

            nx, ny, nz = cell(x), cell(y), cell(z)
            flat_idx = ((level * H + nx) * H + ny) * H + nz
            mip_mul = mip_bound

        f = skip_flat[flat_idx.long()].to(torch.int32)
        occ = f == 0

        pos = torch.stack([x, y, z], dim=-1)
        c = torch.stack([nx, ny, nz], dim=-1).to(torch.float32)
        if single_level:
            tv = (((c + face) * (2.0 / H) - 1.0) * mip_mul - pos) * rd
        else:
            tv = (((c + face) * (2.0 / H) - 1.0) * mip_mul[:, None]
                  - pos) * rd
        tt_fine = t + torch.clamp(torch.amin(tv, dim=-1), min=0.0)

        # field level f guarantees 2^(f-1) - 1 free cells in every direction
        m = ((torch.ones_like(f) << (f - 1).clamp(min=0)) - 1).to(
            torch.float32)
        cell_world = (2.0 / H) * mip_mul
        tt = torch.maximum(tt_fine, t + m * cell_world)

        # jump on the dt lattice
        n_skip = torch.floor((tt - t) / dt) + 1.0
        t_skip = t + torch.clamp(n_skip, min=1.0) * dt

        t_next = torch.where(occ, t + dt, t_skip)
        return t_next, (t, dt, occ)

    return event


def march_rays_train(rays_o, rays_d, occupancy, nears, fars, noises,
                     cfg: MarchConfig):
    """March all rays into fixed-shape padded sample grids.

    Args:
      rays_o, rays_d: [N, 3] float32.
      occupancy: [CAS, H, H, H] uint8.
      nears, fars: [N] from near_far_from_aabb.
      noises: [N] in [0, 1) (zeros when not perturbing).
    Returns dict: ts, dts [N, S] float32 (sample start t and dt), valid
      [N, S] bool, t0 [N] perturbed origin, n_samples [N] int32.
    """
    skip_flat = build_skip_field(occupancy, bound=cfg.bound).reshape(-1)
    t0 = nears + torch.clamp(nears * cfg.dt_gamma, cfg.dt_min,
                             cfg.dt_max) * noises

    N = rays_o.shape[0]
    S = cfg.march_iters
    event = make_march_event(rays_o, rays_d, skip_flat, cfg)
    blk = MARCH_BLOCK if S % MARCH_BLOCK == 0 and S > MARCH_BLOCK else S

    ts_l, dts_l, occ_l = [], [], []
    t = t0
    for i in range(S):
        if i % blk == 0 and blk < S and not bool(torch.any(t < fars)):
            break
        t_next, (ts, dt, occ) = event(t)
        done = t >= fars
        ts_l.append(ts)
        dts_l.append(dt)
        occ_l.append(occ & ~done)
        t = torch.where(done, t, t_next)

    n_run = len(ts_l)
    ts = torch.zeros((N, S), dtype=torch.float32, device=rays_o.device)
    dts = torch.zeros_like(ts)
    valid = torch.zeros((N, S), dtype=torch.bool, device=rays_o.device)
    if n_run:
        ts[:, :n_run] = torch.stack(ts_l, dim=1)
        dts[:, :n_run] = torch.stack(dts_l, dim=1)
        valid[:, :n_run] = torch.stack(occ_l, dim=1)
    return {
        "ts": ts,
        "dts": dts,
        "valid": valid,
        "t0": t0,
        "n_samples": valid.sum(dim=1).to(torch.int32),
    }


def sample_positions(rays_o, rays_d, ts, bound: float):
    """Clamped sample positions [N, S, 3] from t values [N, S]."""
    p = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    return torch.clamp(p, -bound, bound)
