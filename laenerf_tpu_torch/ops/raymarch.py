"""Occupancy-grid ray marching (counterpart of laenerf_tpu/ops/raymarch.py).

Same design as the JAX package: a fixed budget of "march events" per ray;
each event either takes a sample (the occupancy grid is hit) or jumps past
empty space using the chebyshev skip field. On the card the train path's
march is kernel K8 (csrc/raymarch.cu), a thread a ray. Its plain version,
`march_rays_train_plain`, runs the JAX `lax.scan` as a Python loop over
events vectorized over all rays, in blocks of 32 with an "any ray alive"
check between blocks; the wrapper takes it for CPU tensors only. The
inference and distill renders (models/renderer.py) call `make_march_event`
in one round loop of their own.

Zero direction components rely on IEEE 1/0 = inf, as in the JAX package.
"""

import dataclasses

import torch

from ..utils.timers import TRACER, count, span
from .cuda_build import F32, I32, P, launch, on_cpu

SQRT3 = 1.7320508075688772
SKIP_LEVELS = 7  # max safe jump = 2^(SKIP_LEVELS-1) - 1 = 63 cells
MARCH_BLOCK = 32  # events between "any ray alive" checks
_SOURCE = "raymarch.cu"


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


def sph_from_ray(rays_o, rays_d, radius: float):
    """Where each ray leaves the background sphere of `radius`, as [N, 2]
    (theta, phi) scaled to [-1, 1], y up."""
    a = torch.sum(rays_d * rays_d, dim=-1)
    b = torch.sum(rays_o * rays_d, dim=-1)
    c = torch.sum(rays_o * rays_o, dim=-1) - radius * radius
    t = (-b + torch.sqrt(torch.clamp(b * b - a * c, min=0.0))) / a
    p = rays_o + t[..., None] * rays_d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)  # [0, pi)
    phi = torch.atan2(z, x)  # [-pi, pi)
    return torch.stack([2.0 * theta / torch.pi - 1.0, phi / torch.pi],
                       dim=-1)


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
        count("sync.skip_edge")
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


def make_march_event(rays_o, rays_d, skip_flat, cfg: MarchConfig,
                     edit_flat=None):
    """Per-event march closure with per-ray invariants hoisted.

    Returns event(t) -> (t_next, (ts, dt, occ, edit_occ)), all [N]: one
    skip-field lookup per event; occupied cells take a sample and advance
    dt, empty ones jump on the dt lattice. edit_occ says whether the event's
    cell is set in the flat edit grid `edit_flat` (the distill path), and is
    None without one.
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

        flat_idx = flat_idx.long()
        f = skip_flat[flat_idx].to(torch.int32)
        occ = f == 0
        edit_occ = None if edit_flat is None else edit_flat[flat_idx] > 0

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
        return t_next, (t, dt, occ, edit_occ)

    return event


def _march_block(S):
    """Events between the plain loop's alive checks (S: no check)."""
    return MARCH_BLOCK if S % MARCH_BLOCK == 0 and S > MARCH_BLOCK else S


def march_origin(nears, noises, cfg: MarchConfig):
    """The perturbed march origins t0 [N]: nears plus noises [N] in [0, 1)
    of the first step."""
    return nears + torch.clamp(nears * cfg.dt_gamma, cfg.dt_min,
                               cfg.dt_max) * noises


def _march_inputs(occupancy, nears, noises, cfg: MarchConfig):
    """The flat skip field and the perturbed origins t0 [N]."""
    with span("march.skip_field"):
        skip_flat = build_skip_field(occupancy, bound=cfg.bound).reshape(-1)
    return skip_flat, march_origin(nears, noises, cfg)


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

    On CUDA tensors this launches K8 (with, where S is whole blocks of
    MARCH_BLOCK events, a one-block pass for rays whose t or far is NaN)
    and counts the call in `march_rays_train.launches`; on CPU tensors it
    runs
    `march_rays_train_plain`. The two agree bit for bit on ts and dts
    wherever valid is set, and on valid, t0 and n_samples everywhere; where
    valid is not set, K8 holds each ray's last t and its dt, the plain
    loop zeros after its last block. The counters `march.events` (the
    events the plain loop runs) and `march.slots` (N times that) mean the
    same on both; on the card they cost one host wait, made only while the
    tracer records.
    """
    if rays_o.device.type == "cpu":
        return march_rays_train_plain(rays_o, rays_d, occupancy, nears, fars,
                                      noises, cfg)
    skip_flat, t0 = _march_inputs(occupancy, nears, noises, cfg)
    with span("march.kernel"):
        out, live = _march_rays_cuda(rays_o, rays_d, skip_flat, t0, fars,
                                     cfg)
    if TRACER.recording:
        # the plain loop runs whole blocks until no ray is alive
        N, S = rays_o.shape[0], cfg.march_iters
        blk = _march_block(S)
        n_run = S
        if blk < S:
            count("sync.march_events")
            longest = int(live.max()) if N else 0
            n_run = min(S, -(-longest // blk) * blk)
        count("march.events", n_run)
        count("march.slots", N * n_run)
    return out


def _march_rays_cuda(rays_o, rays_d, skip_flat, t0, fars, cfg):
    """K8's launch: the march's result and each ray's live events [N]
    int32 (events whose t was < far)."""
    if rays_o.dtype != torch.float32 or rays_d.dtype != torch.float32 \
            or fars.dtype != torch.float32:
        raise TypeError("march_rays_train: rays and fars must be float32")
    # the train batch's origins are one camera position expanded
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    on_cpu("march_rays_train", rays_o, rays_d, skip_flat, t0, fars)
    N, S, H = rays_o.shape[0], cfg.march_iters, cfg.grid_size
    dev = rays_o.device
    ts = torch.empty((N, S), dtype=torch.float32, device=dev)
    dts = torch.empty_like(ts)
    valid = torch.empty((N, S), dtype=torch.bool, device=dev)
    n_samples = torch.empty((N,), dtype=torch.int32, device=dev)
    live = torch.empty_like(n_samples)
    if N and S:
        # the plain loop's Python scalars, rounded to float as PyTorch
        # rounds them against a float32 tensor
        mb = min(1.0, cfg.bound)
        launch(_SOURCE, "march_rays_train", [P] * 10 + [I32] * 4 + [F32] * 11,
               rays_o, rays_d, skip_flat, t0, fars, ts, dts, valid,
               n_samples, live, N, S, H, cfg.cascades, cfg.bound,
               cfg.dt_min, cfg.dt_max, cfg.dt_gamma, mb, 0.5 * H / mb,
               (2.0 / H) * mb, 2.0 / H, H - 1.0, float(H), 1e-30)
        march_rays_train.launches += 1
    return {"ts": ts, "dts": dts, "valid": valid, "t0": t0,
            "n_samples": n_samples}, live


march_rays_train.launches = 0


def march_rays_train_plain(rays_o, rays_d, occupancy, nears, fars, noises,
                           cfg: MarchConfig):
    """Plain PyTorch version of K8 (`march_rays_train`'s arguments and
    result): the events as a Python loop over all rays, in blocks of
    MARCH_BLOCK with an alive check between them."""
    skip_flat, t0 = _march_inputs(occupancy, nears, noises, cfg)

    N = rays_o.shape[0]
    S = cfg.march_iters
    event = make_march_event(rays_o, rays_d, skip_flat, cfg)
    blk = _march_block(S)

    ts_l, dts_l, occ_l = [], [], []
    t = t0
    while len(ts_l) < S:
        if blk < S:
            with span("march.alive"):
                count("sync.march_alive")
                alive = bool(torch.any(t < fars))
            if not alive:
                break
        with span("march.block", events=blk):
            for _ in range(blk):
                t_next, (ts, dt, occ, _) = event(t)
                done = t >= fars
                ts_l.append(ts)
                dts_l.append(dt)
                occ_l.append(occ & ~done)
                t = torch.where(done, t, t_next)

    n_run = len(ts_l)
    count("march.events", n_run)
    count("march.slots", N * n_run)
    with span("march.pack"):
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
    """Clamped sample positions [..., 3] from t values [...]: rays_o and
    rays_d [..., 3] broadcast against them (rays [N, 3] with ts [N, S]
    take rays_o[:, None]; packed samples [M] their rays' rows)."""
    p = rays_o + ts[..., None] * rays_d
    return torch.clamp(p, -bound, bound)
