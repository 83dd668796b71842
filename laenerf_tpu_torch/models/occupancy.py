"""Occupancy (density) grid state and its update rules (counterpart of
laenerf_tpu/models/occupancy.py).

Cascaded H^3 density grid in plain (cascade, x, y, z) layout; EMA updates
(full recompute for the first 16 updates, then the partial update: a
rotating 2x2x2 sub-lattice sweep plus a rotating at-most-once window over
the occupied cells); threshold min(mean_density, density_thresh); and
mark_untrained_grid camera-visibility culling.

Cell jitter: every update takes an optional `jitter`, a list with one
[n, 3] tensor per cascade of world-space offsets in [-half, half) (half =
cell half-width), so tests can inject the JAX package's draws. Without it
the offsets come from the given torch.Generator.
"""

import dataclasses

import torch

from ..ops.compaction import packed_sample_indices


@dataclasses.dataclass
class OccupancyState:
    density_grid: torch.Tensor  # [CAS, H, H, H] f32; -1 marks untrained cells
    occupancy: torch.Tensor  # [CAS, H, H, H] uint8 (unpacked bitfield)
    mean_density: torch.Tensor  # scalar f32
    iter_density: int  # number of updates so far (host counter)


def occupancy_init(cascades: int, grid_size: int = 128, *,
                   device) -> OccupancyState:
    H = grid_size
    return OccupancyState(
        density_grid=torch.zeros((cascades, H, H, H), dtype=torch.float32,
                                 device=device),
        occupancy=torch.zeros((cascades, H, H, H), dtype=torch.uint8,
                              device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=0,
    )


def _cell_half(cas: int, bound: float, grid_size: int) -> float:
    return min(2.0 ** cas, bound) / grid_size


def _cell_world_coords(coords, cas: int, bound: float, grid_size: int,
                       noise):
    """Grid coords [n, 3] -> world positions of a cascade, plus noise."""
    H = grid_size
    cas_bound = min(2.0 ** cas, bound)
    half = cas_bound / H
    xyz = 2.0 * coords.to(torch.float32) / (H - 1) - 1.0
    return xyz * (cas_bound - half) + noise


def _draw_jitter(n, cas, bound, grid_size, generator, device):
    half = _cell_half(cas, bound, grid_size)
    u = torch.rand((n, 3), generator=generator, device=device)
    return u * (2.0 * half) - half


def _all_coords(grid_size: int, device):
    r = torch.arange(grid_size, dtype=torch.int64, device=device)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                       dim=-1)


def _eval_density(density_fn, xyz, density_scale, chunk):
    return torch.cat([density_fn(xyz[s:s + chunk]) * density_scale
                      for s in range(0, xyz.shape[0], chunk)])


def _finish_update(state: OccupancyState, tmp_grid, density_thresh: float,
                   decay: float) -> OccupancyState:
    """EMA + threshold + re-threshold the bitfield."""
    grid = state.density_grid
    valid = (grid >= 0) & (tmp_grid >= 0)
    grid = torch.where(valid, torch.maximum(grid * decay, tmp_grid), grid)
    mean_density = torch.mean(torch.clamp(grid, min=0.0))
    thresh = torch.clamp(mean_density, max=density_thresh)
    return OccupancyState(
        density_grid=grid,
        occupancy=(grid > thresh).to(torch.uint8),
        mean_density=mean_density,
        iter_density=state.iter_density + 1,
    )


@torch.no_grad()
def update_occupancy_full(state: OccupancyState, density_fn, *, bound: float,
                          density_scale: float = 1.0,
                          density_thresh: float = 0.01, decay: float = 0.95,
                          chunk: int = 2 ** 16, generator=None,
                          jitter=None) -> OccupancyState:
    """Recompute density for every cell of every cascade.

    density_fn: x [M, 3] -> sigma [M].
    """
    cas_n, H = state.density_grid.shape[0], state.density_grid.shape[1]
    dev = state.density_grid.device
    coords = _all_coords(H, dev)
    tmp = []
    for cas in range(cas_n):
        noise = (jitter[cas] if jitter is not None else
                 _draw_jitter(coords.shape[0], cas, bound, H, generator, dev))
        xyz = _cell_world_coords(coords, cas, bound, H, noise)
        tmp.append(_eval_density(density_fn, xyz, density_scale,
                                 chunk).reshape(H, H, H))
    return _finish_update(state, torch.stack(tmp), density_thresh, decay)


@torch.no_grad()
def update_occupancy_partial(state: OccupancyState, density_fn, *,
                             bound: float, density_scale: float = 1.0,
                             density_thresh: float = 0.01,
                             decay: float = 0.95, chunk: int = 2 ** 16,
                             generator=None, jitter=None) -> OccupancyState:
    """Partial update: one of the 8 interleaved 2x2x2 sub-lattices (rotating
    with iter_density, H^3/8 cells) plus a rotating window of at most H^3/16
    occupied cells, each visited at most once.

    Cells in both parts are written twice and the window's value wins: the
    sweep is written first, then the window, in two ordered writes (a single
    write with duplicate indices is unordered on the card). The jitter of
    cascade c has H^3/8 + H^3/16 rows: sweep cells, then window slots.
    """
    cas_n, H = state.density_grid.shape[0], state.density_grid.shape[1]
    dev = state.density_grid.device
    n_cells = H ** 3
    cap_o = max(n_cells // 16, 8)
    tmp_grid = -torch.ones_like(state.density_grid)

    phase = state.iter_density % 8
    dx, dy, dz = phase & 1, (phase >> 1) & 1, (phase >> 2) & 1
    r = torch.arange(H // 2, dtype=torch.int64, device=dev)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    sweep_coords = torch.stack(
        [2 * gx.reshape(-1) + dx, 2 * gy.reshape(-1) + dy,
         2 * gz.reshape(-1) + dz], dim=-1)  # [H^3/8, 3]
    sweep_flat = ((sweep_coords[:, 0] * H + sweep_coords[:, 1]) * H
                  + sweep_coords[:, 2])
    n_sweep = sweep_coords.shape[0]

    for cas in range(cas_n):
        occ_mask = state.density_grid[cas].reshape(-1) > 0
        rank = torch.cumsum(occ_mask.to(torch.int64), dim=0) - 1
        total = torch.clamp(rank[-1] + 1, min=1)
        start = (state.iter_density * cap_o) % total
        win = occ_mask & (torch.remainder(rank - start, total) < cap_o)
        occ_flat = packed_sample_indices(win, cap_o)
        n_occ = occ_flat.shape[0]
        occ_coords = torch.stack(
            [occ_flat // (H * H), (occ_flat // H) % H, occ_flat % H], dim=-1)

        n_rows = n_sweep + cap_o
        noise = (jitter[cas] if jitter is not None else
                 _draw_jitter(n_rows, cas, bound, H, generator, dev))
        coords = torch.cat([sweep_coords, occ_coords], dim=0)
        xyz = _cell_world_coords(coords, cas, bound, H,
                                 noise[:n_sweep + n_occ])
        sig = _eval_density(density_fn, xyz, density_scale, chunk)
        tmp_cas = torch.full((n_cells,), -1.0, dtype=tmp_grid.dtype,
                             device=dev)
        tmp_cas[sweep_flat] = sig[:n_sweep]
        tmp_cas[occ_flat] = sig[n_sweep:]
        tmp_grid[cas] = tmp_cas.reshape(H, H, H)

    return _finish_update(state, tmp_grid, density_thresh, decay)


def update_occupancy(state: OccupancyState, density_fn, *, bound: float,
                     full: bool, **kw) -> OccupancyState:
    """Dispatch full/partial on a host-side flag (the trainer runs full
    updates while iter_density < 16)."""
    if full:
        return update_occupancy_full(state, density_fn, bound=bound, **kw)
    return update_occupancy_partial(state, density_fn, bound=bound, **kw)


@torch.no_grad()
def mark_untrained_grid(density_grid, poses, intrinsics, *, bound: float,
                        cascades: int, grid_size: int = 128,
                        min_near: float = 0.2,
                        filter_close_point: bool = False,
                        chunk: int = 2 ** 15):
    """Mark cells invisible from every training camera as -1.

    Args:
      density_grid: [CAS, H, H, H]; poses: [B, 4, 4] cam2world;
      intrinsics: (fx, fy, cx, cy) floats.
    Returns the updated density_grid.
    """
    H = grid_size
    fx, fy, cx, cy = intrinsics
    dev = density_grid.device
    world = 2.0 * _all_coords(H, dev).to(torch.float32) / (H - 1) - 1.0
    rot = poses[:, :3, :3]
    trans = poses[:, :3, 3]

    new_grid = []
    for cas in range(cascades):
        cas_bound = min(2.0 ** cas, bound)
        half = cas_bound / H
        pts = world * (cas_bound - half)
        count = []
        for s in range(0, pts.shape[0], chunk):
            rel = pts[None, s:s + chunk, :] - trans[:, None, :]  # [B, c, 3]
            # rel @ R (not R^T), as the JAX package contracts it
            cam = torch.einsum("bcd,bde->bce", rel, rot)
            z = cam[..., 2]
            vis = ((z > 0)
                   & (cam[..., 0].abs() < cx / fx * z + half * 2)
                   & (cam[..., 1].abs() < cy / fy * z + half * 2))
            close = vis & (z < min_near)
            if filter_close_point:
                close = close | (torch.linalg.norm(cam, dim=-1) < min_near)
            count.append(vis.sum(dim=0) * (close.sum(dim=0) == 0))
        count = torch.cat(count).reshape(H, H, H)
        new_grid.append(torch.where(count == 0, -1.0, density_grid[cas]))
    return torch.stack(new_grid)
