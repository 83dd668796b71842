"""3D edit-region selection grid (a copy of the JAX package's numpy-only
laenerf_tpu/editing/editgrid.py, so the port imports nothing of it).

A multi-mip selection grid in the density grid's layout (uint8 [CAS, H,
H, H] on the host), built by voxelizing clicked ray-termination points and
grown by a density-guided breadth-first flood fill over queue batches, with
xor/and algebra for carving and a morphological dilation.
"""

from collections import deque

import numpy as np


def EDIT_GRIDSIZE() -> int:
    return 128


_NEIGHBORS = np.array(
    [(-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 1), (0, 1, 0), (1, 0, 0)],
    dtype=np.int32,
)


def mip_from_pos(pts, cascades: int):
    """Cascade level per point (editgrid.py:23-26 / raymarching.cu:42-47)."""
    mx = np.max(np.abs(pts), axis=-1)
    exp = np.frexp(np.maximum(mx, 1e-30))[1]
    return np.clip(exp, 0, cascades - 1).astype(np.int32)


def voxelize_points(pts, cascades: int, bound: float, grid_size: int = 128):
    """World points -> (level, cell coords) (editgrid.py:87-92)."""
    H = grid_size
    level = mip_from_pos(pts, cascades)
    mip_bound = np.minimum(np.exp2(level.astype(np.float64)), bound)
    coords = np.clip(
        0.5 * (pts / mip_bound[:, None] + 1.0) * H, 0, H - 1
    ).astype(np.int32)
    return level, coords


def cell_world_pos(coords, level, bound: float, grid_size: int = 128):
    """Inverse of voxelize_points: cell centers in world space.

    (The reference's get_cell_pos_ keeps an instant-ngp [0,1] convention
    that does not invert its own voxelization; here we return the actual
    world-space center so downstream consumers need no correction.)
    """
    H = grid_size
    mip_bound = np.minimum(np.exp2(level.astype(np.float64)), bound)
    return ((coords.astype(np.float64) + 0.5) / H * 2.0 - 1.0) * mip_bound[:, None]


class EditGrid:
    """Multi-mip selection grid with density-guided growing."""

    def __init__(self, cascades: int = 1, grid_size: int = 128):
        self.cascades = cascades
        self.grid_size = grid_size
        self.grid = None  # uint8 [CAS, H, H, H]
        self.growing_queue = deque()
        self.pts = None

    # -- algebra (editgrid.py:66-78) -----------------------------------

    def xor(self, negative_grid):
        """Remove the negative region: grid &= grid ^ negative."""
        self.grid = self.grid & (self.grid ^ negative_grid)

    def and_(self, other_grid):
        """Union (the reference's and_ is actually a bitwise or)."""
        self.grid = self.grid | other_grid

    def bw_and(self, other_grid):
        """Intersect (used to clip the selection to occupied space)."""
        self.grid = self.grid & other_grid

    def reset(self):
        self.grid = None
        self.pts = None
        self.growing_queue = deque()

    def _empty(self):
        H = self.grid_size
        return np.zeros((self.cascades, H, H, H), np.uint8)

    # -- construction (editgrid.py:80-137) ------------------------------

    def new_from_points(self, pts, bound: float = 1.0):
        """Voxelize clicked x_term points and seed the growing queue with
        their 6-neighborhoods."""
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        self.grid = self._empty()
        level, coords = voxelize_points(pts, self.cascades, bound,
                                        self.grid_size)
        self.grid[level, coords[:, 0], coords[:, 1], coords[:, 2]] = 1
        for i in range(pts.shape[0]):
            nb = coords[i][None, :] + _NEIGHBORS
            ok = np.all((nb >= 0) & (nb < self.grid_size), axis=-1)
            for c in nb[ok]:
                self.growing_queue.append((c, int(level[i])))

    # -- growing (editgrid.py:274-340) ----------------------------------

    def grow_region_queue(self, density_grid, density_thresh: float,
                          grow_iterations: int = 5000, batch: int = 32):
        """BFS flood fill: accept queued cells whose density passes the
        threshold and are not yet selected; enqueue their neighbors.

        Args:
          density_grid: [CAS, H, H, H] float (our layout; -1 = untrained).
          density_thresh: acceptance threshold (min(mean_density, thresh)).
          grow_iterations: max queue pops this call.
          batch: cells popped per vectorized step (reference uses 32; any
            value preserves the accept condition, only the FIFO batching
            granularity differs).
        """
        density_grid = np.asarray(density_grid)
        H = self.grid_size
        ctr = 0
        while ctr < grow_iterations and self.growing_queue:
            n = min(batch, len(self.growing_queue), grow_iterations - ctr)
            coords = np.empty((n, 3), np.int32)
            lvls = np.empty((n,), np.int32)
            for i in range(n):
                coords[i], lvls[i] = self.growing_queue.popleft()
            d = density_grid[lvls, coords[:, 0], coords[:, 1], coords[:, 2]]
            sel = self.grid[lvls, coords[:, 0], coords[:, 1], coords[:, 2]]
            accept = (d >= density_thresh) & (sel == 0)
            if accept.any():
                ac, al = coords[accept], lvls[accept]
                self.grid[al, ac[:, 0], ac[:, 1], ac[:, 2]] = 1
                nb = (ac[:, None, :] + _NEIGHBORS[None]).reshape(-1, 3)
                nl = np.repeat(al, 6)
                ok = np.all((nb >= 0) & (nb < H), axis=-1)
                for c, l in zip(nb[ok], nl[ok]):
                    self.growing_queue.append((c, int(l)))
            ctr += n

    def grid_from_growing_queue(self, other: "EditGrid", density_grid,
                                density_thresh: float):
        """Build a transition-shell grid from another grid's remaining
        queue: one expansion ring of density-passing, not-yet-selected
        cells (editgrid.py:232-271). Used as the 'grow grid' for smooth
        edit boundaries."""
        density_grid = np.asarray(density_grid)
        self.grid = self._empty()
        self.growing_queue = deque()
        H = self.grid_size
        for coords, lvl in list(other.growing_queue):
            c = np.asarray(coords, np.int32)
            l = int(lvl)
            d = density_grid[l, c[0], c[1], c[2]]
            if d >= density_thresh and self.grid[l, c[0], c[1], c[2]] == 0:
                self.grid[l, c[0], c[1], c[2]] = 1
                nb = c[None, :] + _NEIGHBORS
                ok = np.all((nb >= 0) & (nb < H), axis=-1)
                for cc in nb[ok]:
                    self.growing_queue.append((cc, l))

    def morphological(self):
        """Dilate the selection by its 6-neighborhood (editgrid.py:145-164)."""
        g = np.pad(self.grid, ((0, 0), (1, 1), (1, 1), (1, 1)))
        out = self.grid.copy()
        out |= g[:, 2:, 1:-1, 1:-1] | g[:, :-2, 1:-1, 1:-1]
        out |= g[:, 1:-1, 2:, 1:-1] | g[:, 1:-1, :-2, 1:-1]
        out |= g[:, 1:-1, 1:-1, 2:] | g[:, 1:-1, 1:-1, :-2]
        self.grid = out

    # -- extraction / io -------------------------------------------------

    def get_selection_points(self, bound: float = 1.0):
        """World-space centers of all selected cells (editgrid.py:343-368)."""
        if self.pts is not None:
            return self.pts
        lvl, x, y, z = np.nonzero(self.grid)
        coords = np.stack([x, y, z], axis=-1).astype(np.int32)
        return cell_world_pos(coords, lvl.astype(np.int32), bound,
                              self.grid_size).astype(np.float32)

    def save(self, path):
        np.savez_compressed(path, grid=self.grid, cascades=self.cascades,
                            grid_size=self.grid_size)

    @classmethod
    def load(cls, path):
        data = np.load(path)
        eg = cls(int(data["cascades"]), int(data["grid_size"]))
        eg.grid = data["grid"].astype(np.uint8)
        return eg
