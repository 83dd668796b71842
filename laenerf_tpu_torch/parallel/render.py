"""Data-parallel full-image rendering (counterpart of
laenerf_tpu/parallel/render.py): the frame's pixels, padded to a multiple
of the world size, are split into equal shards; each rank renders its own
with the inference path and an all_gather assembles the frame."""

import numpy as np
import torch

from ..data.rays import pixel_rays
from ..models.nerf import gather_table_for
from ..models.renderer import build_march_tables, render_rays_infer
from .mesh import Mesh, _all_gather


@torch.no_grad()
def dp_render_image(mesh: Mesh, net, occupancy, pose, intrinsics, H: int,
                    W: int, *, render_cfg, bg_color=1.0, chunk: int = 16384):
    """Render one H x W frame with its rays sharded over the ranks, each
    shard in chunks of at most `chunk` rays. Every rank returns the whole
    frame as numpy (image [H, W, 3], depth [H, W])."""
    dev = mesh.device
    rays_o, rays_d = pixel_rays(
        torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(intrinsics), dtype=torch.float32,
                        device=dev), H, W)
    n = H * W
    pad = (-n) % mesh.world_size
    if pad:
        rays_o = torch.cat([rays_o, rays_o[:pad]])
        rays_d = torch.cat([rays_d, rays_d[:pad]])
    k = (n + pad) // mesh.world_size
    lo = mesh.rank * k
    rays_o, rays_d = rays_o[lo:lo + k], rays_d[lo:lo + k]
    skip_flat = build_march_tables(occupancy, render_cfg=render_cfg)
    gather_table = gather_table_for(net)
    imgs, depths = [], []
    for s in range(0, k, chunk):
        out = render_rays_infer(net, occupancy, rays_o[s:s + chunk],
                                rays_d[s:s + chunk], render_cfg=render_cfg,
                                bg_color=bg_color, skip_flat=skip_flat,
                                gather_table=gather_table)
        imgs.append(out["image"])
        depths.append(out["depth"])
    image = _all_gather(mesh, torch.cat(imgs))[:n].reshape(H, W, 3)
    depth = _all_gather(mesh, torch.cat(depths))[:n].reshape(H, W)
    return image.cpu().numpy(), depth.cpu().numpy()
