"""Training engine (counterpart of laenerf_tpu/train/trainer.py): Adam(0.9,
0.99, eps=1e-15) with LambdaLR decay to 0.1*lr at the last step, EMA(0.95)
of the parameters, per-pixel random background compositing for RGBA
targets, an occupancy refresh every 16 steps (full while fewer than 16
updates ran, partial after), and chunked tile-ordered full-image rendering
with the EMA parameters.

Randomness comes from one torch.Generator per Trainer (seeded by `seed`);
every draw can be injected instead (`bg`, `noises`, occupancy `jitter`).
Distillation, NPR and CLIP steps, evaluation and checkpoints are not ported
yet.
"""

import copy

import numpy as np
import torch

from ..data.rays import get_rays, pixel_rays, tile_raster_order
from ..models.nerf import NeRFConfig, gather_table_for, nerf_density, nerf_init
from ..models.occupancy import (mark_untrained_grid, occupancy_init,
                                update_occupancy)
from ..models.renderer import (RenderConfig, build_march_tables,
                               render_rays_infer, render_rays_train)


def configure_matmul_precision():
    """bf16 products accumulate and reduce in f32 (the JAX package's
    preferred_element_type=f32); f32 products stay full f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_optimizer(params, lr: float, iters: int):
    """Adam + LambdaLR 0.1**min(step/iters, 1). Returns (optimizer,
    scheduler); step the scheduler once after every optimizer step."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-15)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** min(step / iters, 1.0))
    return opt, sched


def train_step(net, ema_net, optimizer, scheduler, occupancy, pose,
               intrinsics, inds, pixels, *, render_cfg: RenderConfig,
               ema_decay: float, has_alpha: bool, bg_white: bool, H: int,
               W: int, bg=None, noises=None, generator=None):
    """One optimization step.

    Args:
      net, ema_net: the trained network and its EMA copy (updated in place).
      pixels: [N, 3|4] ground-truth pixels.
      bg: optional [N, 3] random background in [0, 1) for RGBA targets
        (drawn from `generator` when not given).
      noises: optional [N] march perturbation in [0, 1).
    Returns:
      aux dict: loss (0-d tensor), per_ray_error [N], n_samples [N]. The
      step's gradients stay in each parameter's .grad.
    """
    rays_o, rays_d = get_rays(pose, intrinsics, inds, H, W)
    N = inds.shape[0]
    if has_alpha and not bg_white:
        if bg is None:
            bg = torch.rand((N, 3), generator=generator, device=pose.device)
    else:
        bg = torch.ones((N, 3), dtype=torch.float32, device=pose.device)
    if has_alpha:
        gt = pixels[:, :3] * pixels[:, 3:] + bg * (1.0 - pixels[:, 3:])
    else:
        gt = pixels[:, :3]

    optimizer.zero_grad(set_to_none=True)
    out = render_rays_train(net, occupancy, rays_o, rays_d,
                            render_cfg=render_cfg, bg_color=bg, perturb=True,
                            noises=noises, generator=generator)
    per_ray = torch.mean((out["image"] - gt) ** 2, dim=-1)
    loss = torch.mean(per_ray)
    loss.backward()
    optimizer.step()
    scheduler.step()
    with torch.no_grad():
        for e, p in zip(ema_net.parameters(), net.parameters()):
            e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
    return {"loss": loss.detach(), "per_ray_error": per_ray.detach(),
            "n_samples": out["n_samples"]}


def occ_update(net, occ_state, *, bound: float, full: bool,
               density_scale: float = 1.0, density_thresh: float = 0.01,
               generator=None, jitter=None):
    """Occupancy refresh with the network's density."""
    def density_fn(x):
        return nerf_density(net, x)["sigma"]

    return update_occupancy(occ_state, density_fn, bound=bound, full=full,
                            density_scale=density_scale,
                            density_thresh=density_thresh,
                            generator=generator, jitter=jitter)


class Trainer:
    """Host-side training orchestration for the NeRF main path."""

    def __init__(self, model_cfg: NeRFConfig, render_cfg: RenderConfig, *,
                 device="cuda", lr: float = 1e-2, iters: int = 30000,
                 ema_decay: float = 0.95, update_interval: int = 16,
                 bg_white: bool = False, eval_chunk: int = 16384,
                 seed: int = 0):
        configure_matmul_precision()
        self.device = torch.device(device)
        self.model_cfg = model_cfg
        self.render_cfg = render_cfg
        self.iters = iters
        self.ema_decay = ema_decay
        self.update_interval = update_interval
        self.bg_white = bg_white
        self.eval_chunk = eval_chunk
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.net = nerf_init(model_cfg, device=self.device,
                             generator=self.generator)
        self.ema_net = copy.deepcopy(self.net).requires_grad_(False)
        self.optimizer, self.scheduler = make_optimizer(
            self.net.parameters(), lr, iters)
        self.occ_state = occupancy_init(render_cfg.cascades,
                                        render_cfg.grid_size,
                                        device=self.device)
        self.global_step = 0

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def mark_untrained(self, dataset):
        self.occ_state.density_grid = mark_untrained_grid(
            self.occ_state.density_grid, self._tensor(dataset.poses),
            tuple(float(v) for v in dataset.intrinsics),
            bound=self.render_cfg.bound, cascades=self.render_cfg.cascades,
            grid_size=self.render_cfg.grid_size,
            min_near=self.render_cfg.min_near,
        )

    def maybe_update_occupancy(self):
        if self.global_step % self.update_interval != 0:
            return
        self.occ_state = occ_update(
            self.net, self.occ_state, bound=self.render_cfg.bound,
            full=self.occ_state.iter_density < 16,
            density_scale=self.render_cfg.density_scale,
            density_thresh=self.render_cfg.density_thresh,
            generator=self.generator,
        )

    def train_one_batch(self, batch, has_alpha: bool):
        self.maybe_update_occupancy()
        aux = train_step(
            self.net, self.ema_net, self.optimizer, self.scheduler,
            self.occ_state.occupancy, self._tensor(batch["pose"]),
            self._tensor(batch["intrinsics"]),
            self._tensor(batch["inds"], torch.int64),
            self._tensor(batch["pixels"]), render_cfg=self.render_cfg,
            ema_decay=self.ema_decay, has_alpha=has_alpha,
            bg_white=self.bg_white, H=batch["H"], W=batch["W"],
            generator=self.generator,
        )
        self.global_step += 1
        return aux

    @torch.no_grad()
    def render_image(self, pose, intrinsics, H: int, W: int, bg_color=1.0,
                     use_ema: bool = True):
        """Render a full image with the inference path in eval_chunk-ray
        chunks of tile-ordered pixels. The encoder table is rounded to the
        gather dtype and the skip field built once per frame. Returns numpy
        (image [H, W, 3], depth [H, W])."""
        net = self.ema_net if use_ema else self.net
        gather_table = gather_table_for(net)
        skip_flat = build_march_tables(self.occ_state.occupancy,
                                       render_cfg=self.render_cfg)
        rays_o, rays_d = pixel_rays(self._tensor(pose),
                                    self._tensor(intrinsics), H, W)
        n = H * W
        chunk = self.eval_chunk
        order, inv = tile_raster_order(H, W)
        order = torch.as_tensor(order, device=self.device)
        rays_o, rays_d = rays_o[order], rays_d[order]
        pad = (-n) % chunk
        if pad:
            rays_o = torch.cat([rays_o, rays_o[:pad]])
            rays_d = torch.cat([rays_d, rays_d[:pad]])
        imgs, depths = [], []
        for s in range(0, n + pad, chunk):
            out = render_rays_infer(
                net, self.occ_state.occupancy, rays_o[s:s + chunk],
                rays_d[s:s + chunk], render_cfg=self.render_cfg,
                bg_color=bg_color, skip_flat=skip_flat,
                gather_table=gather_table)
            imgs.append(out["image"])
            depths.append(out["depth"])
        inv = torch.as_tensor(inv, device=self.device)
        img = torch.cat(imgs)[:n][inv].reshape(H, W, 3)
        depth = torch.cat(depths)[:n][inv].reshape(H, W)
        return img.cpu().numpy(), depth.cpu().numpy()
