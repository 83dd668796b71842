"""March inputs shared by the CPU tests of the plain march against the JAX
package (tests/test_torch_ops.py) and the card tests of K8 against the
plain march (tests/test_torch_cuda.py). numpy only, no JAX.

A case is (name, MarchConfig fields as a dict, occupancy [CAS, H, H, H]
uint8, rays_o [N, 3], rays_d [N, 3], noises [N]) as numpy arrays; the
fields take MarchConfig's defaults where a case leaves them out.
"""

import numpy as np


def blob_grid(seed, cas, H, p=0.97):
    rng = np.random.RandomState(seed)
    occ = (rng.rand(cas, H, H, H) > p).astype(np.uint8)
    occ[:, H // 4:H // 2, H // 4:H // 2, H // 3:H // 2] = 1  # a solid block
    return occ


def camera_rays(seed, n, bound):
    rng = np.random.RandomState(seed)
    eye = np.array([0.3, -0.4, -2.6], np.float32) * bound
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32) * bound
    rd = tgt - eye
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.broadcast_to(eye, rd.shape).copy()
    return ro, rd, rng.rand(n).astype(np.float32)


def march_cases():
    """The march fixtures of test_torch_ops.py: full, empty, miss, half,
    blobs, cascade2."""
    out = []
    z_o = np.array([[0.0, 0.0, -3.0]], np.float32)
    z_d = np.array([[0.0, 0.0, 1.0]], np.float32)
    zero = np.zeros(1, np.float32)
    cfg = dict(bound=1.0, cascades=1, grid_size=16, max_steps=64,
               march_iters=64)
    out.append(("full", cfg, np.ones((1, 16, 16, 16), np.uint8), z_o, z_d,
                zero))
    out.append(("empty", cfg, np.zeros((1, 16, 16, 16), np.uint8), z_o, z_d,
                zero))
    out.append(("miss", cfg, np.ones((1, 16, 16, 16), np.uint8),
                np.array([[0.0, 5.0, -3.0]], np.float32), z_d, zero))
    half = np.zeros((1, 16, 16, 16), np.uint8)
    half[0, :, :, 8:] = 1
    out.append(("half", dict(bound=1.0, grid_size=16, max_steps=128,
                             march_iters=160), half, z_o, z_d, zero))
    ro, rd, nz = camera_rays(4, 512, 1.0)
    out.append(("blobs", dict(bound=1.0, grid_size=32, max_steps=128,
                              march_iters=128), blob_grid(5, 1, 32), ro, rd,
                nz))
    ro, rd, nz = camera_rays(6, 256, 2.0)
    out.append(("cascade2", dict(bound=2.0, cascades=2, grid_size=16,
                                 max_steps=64, march_iters=128),
                blob_grid(7, 2, 16, p=0.9), ro, rd, nz))
    return out


def kernel_cases():
    """The march fixtures, and the edges K8 must meet as the plain loop
    does: dt_gamma > 0 (one cascade and two), zero direction components
    (some origins on a cell centre, where the exit distance is 0 * inf),
    a batch where some rays miss the box (near == far == float max)
    beside rays that hit it, and S off the 32-event blocks. In
    zero_dir_corner the corner cell a NaN t falls in is occupied, so rays
    whose t went NaN take samples until the plain loop stops."""
    out = march_cases()
    ro, rd, nz = camera_rays(8, 300, 1.0)
    out.append(("gamma", dict(bound=1.0, grid_size=32, dt_gamma=1 / 64,
                              max_steps=256, march_iters=128),
                blob_grid(9, 1, 32), ro, rd, nz))
    ro, rd, nz = camera_rays(10, 200, 2.0)
    out.append(("gamma_cascade2", dict(bound=2.0, cascades=2, grid_size=16,
                                       dt_gamma=1 / 128, max_steps=128,
                                       march_iters=96),
                blob_grid(11, 2, 16, p=0.9), ro, rd, nz))
    out.append(("zero_dir",) + zero_dir_case())
    out.append(("zero_dir_corner",) + zero_dir_case(corner=True))
    ro, rd, nz = camera_rays(12, 96, 1.0)
    ro[::3] += np.array([0.0, 4.0, 0.0], np.float32)  # a third miss
    out.append(("misses", dict(bound=1.0, grid_size=32, max_steps=128,
                               march_iters=128), blob_grid(13, 1, 32), ro,
                rd, nz))
    ro, rd, nz = camera_rays(14, 70, 1.0)
    out.append(("ragged_s", dict(bound=1.0, grid_size=32, max_steps=128,
                                 march_iters=100), blob_grid(15, 1, 32), ro,
                rd, nz))
    return out


def zero_dir_case(corner=False):
    """Axis-aligned and plane-parallel rays through a blob grid of 16^3
    cells: every ray has one or two zero direction components; a quarter of
    the origins sit on a cell centre along a zero component (0 * inf in
    that axis's exit distance), one of them signed -0. corner occupies
    cell (0, 0, 0), where a NaN coordinate's cell lands."""
    rng = np.random.RandomState(16)
    H, n = 16, 128
    rd = np.zeros((n, 3), np.float32)
    ro = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    axis = rng.randint(0, 3, n)
    for k in range(n):
        a = axis[k]
        if k % 2:  # in a plane: one more axis moves
            b = (a + 1) % 3
            v = rng.randn(2)
            rd[k, [a, b]] = v / np.linalg.norm(v)
        else:
            rd[k, a] = 1.0 if rng.rand() < 0.5 else -1.0
        ro[k, a] = -2.5 * np.sign(rd[k, a])
        if k % 4 == 0:  # on a cell centre along the zero components
            for c in range(3):
                if rd[k, c] == 0.0:
                    ro[k, c] = (rng.randint(0, H) + 0.5) * (2.0 / H) - 1.0
    rd[2, (axis[2] + 1) % 3] = -0.0
    cfg = dict(bound=1.0, grid_size=H, max_steps=64, march_iters=96)
    occ = blob_grid(17, 1, H, p=0.9)
    occ[0, 0, 0, 0] = corner
    return cfg, occ, ro, rd, rng.rand(n).astype(np.float32)


def ngp_blender_case(seed=0):
    """The NeRF cell's march shape: 8,192 rays from one camera, a 128^3
    blob grid, 1,024 events (march_iters of ngp_blender)."""
    ro, rd, nz = camera_rays(seed, 8192, 1.0)
    cfg = dict(bound=1.0, grid_size=128, max_steps=1024, march_iters=1024)
    return ("ngp_blender", cfg, blob_grid(seed + 1, 1, 128, p=0.995), ro,
            rd, nz)
