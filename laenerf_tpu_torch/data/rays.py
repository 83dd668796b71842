"""Ray generation from camera poses (counterpart of laenerf_tpu/data/rays.py).

`d @ pose[:3, :3].T` is a float32 matrix product; it runs in full float32
because the port never enables TF32 (torch.backends.cuda.matmul.allow_tf32
stays False, its default).
"""

import numpy as np
import torch


def get_rays(pose, intrinsics, inds, H: int, W: int, dir_offset=None):
    """Rays through the given flat pixel indices.

    Args:
      pose: [4, 4] cam2world.
      intrinsics: (fx, fy, cx, cy) tensor [4].
      inds: [N] integer flat pixel indices, row-major (row = inds // W).
      H, W: image size.
      dir_offset: optional [2] anti-aliasing jitter subtracted from the pixel
        center.
    Returns:
      rays_o, rays_d: [N, 3] float32.
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    row = (inds // W).to(torch.float32) + 0.5  # j (vertical)
    col = (inds % W).to(torch.float32) + 0.5  # i (horizontal)
    if dir_offset is not None:
        col = col - dir_offset[0]
        row = row - dir_offset[1]
    xs = (col - cx) / fx
    ys = (row - cy) / fy
    d = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rays_d = d @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def pixel_rays(pose, intrinsics, H: int, W: int, dir_offset=None):
    """Rays for every pixel of an HxW image (eval path)."""
    inds = torch.arange(H * W, dtype=torch.int64, device=pose.device)
    return get_rays(pose, intrinsics, inds, H, W, dir_offset)


def tile_raster_order(H: int, W: int, tile: int = 128):
    """Pixel permutation grouping HxW into tile x tile blocks (row-major
    within and across tiles), so each render chunk is spatially coherent and
    retires early. Returns (order, inverse) int64 numpy arrays of length
    H*W."""
    idx = np.arange(H * W, dtype=np.int64).reshape(H, W)
    blocks = [idx[ty:ty + tile, tx:tx + tile].reshape(-1)
              for ty in range(0, H, tile) for tx in range(0, W, tile)]
    order = np.concatenate(blocks)
    inv = np.empty_like(order)
    inv[order] = np.arange(H * W, dtype=np.int64)
    return order, inv
