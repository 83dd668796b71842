"""Training engine (counterpart of laenerf_tpu/train/trainer.py): Adam(0.9,
0.99, eps=1e-15) with LambdaLR decay to 0.1*lr at the last step, EMA(0.95)
of the parameters, per-pixel random background compositing for RGBA
targets, an occupancy refresh every 16 steps (full while fewer than 16
updates ran, partial after), chunked tile-ordered full-image rendering
with the EMA parameters, the distillation fine-tune step (with optional
depth supervision) and full-frame distill renders, the patch-LPIPS term
of patch-sampled batches, the epoch loop with error-map updates,
evaluation with PSNR, SSIM and LPIPS, checkpoints in the JAX package's npz
layout, and tensorboard scalars where tensorboardX imports.

Randomness comes from one torch.Generator per Trainer (seeded by `seed`);
every draw can be injected instead (`bg`, `noises`, occupancy `jitter`).
The NPR fine-tune step (train_step_npr) and the CLIP-guided step
(train_step_clip) are here too.
"""

import copy
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..data.rays import get_rays, pixel_rays, tile_raster_order
from ..models.nerf import NeRFConfig, gather_table_for, nerf_density, nerf_init
from ..models.occupancy import (OccupancyState, mark_untrained_grid,
                                occupancy_init, update_occupancy)
from ..models.renderer import (RenderConfig, build_march_tables,
                               render_rays_distill, render_rays_infer,
                               render_rays_train)
from ..utils.timers import count, span
from .checkpoints import CheckpointManager, load_pytree
from .metrics import LPIPSMeter, psnr_meter, ssim_meter


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
               W: int, bg=None, noises=None, generator=None,
               distill: bool = False, depth_target=None,
               depth_weight: float = 1e-3, patch_lpips_fn=None,
               patch_size: int = 1):
    """One optimization step.

    Args:
      net, ema_net: the trained network and its EMA copy (updated in place).
      pixels: [N, 3|4] ground-truth pixels.
      bg: optional [N, 3] random background in [0, 1) for RGBA targets
        (drawn from `generator` when not given).
      noises: optional [N] march perturbation in [0, 1).
      distill: the fine-tune on distilled images; with a depth_target [N]
        (absolute ray depth, 0 where unsupervised) it adds
        depth_weight * mean(((depth - (target - near)) * [target > 0])^2).
      patch_lpips_fn, patch_size: with patch_size > 1 and a batched LPIPS
        (editing/vgg.py::lpips_fn), the rays are N / patch_size^2
        independent patches and the loss adds 1e-3 * the mean LPIPS over
        the [patch_size, patch_size, 3] patch pairs.
    Returns:
      aux dict: loss (0-d tensor), per_ray_error [N], n_samples [N]. The
      step's gradients stay in each parameter's .grad.
    """
    optimizer.zero_grad(set_to_none=True)
    loss, per_ray, out = train_loss(
        net, occupancy, pose, intrinsics, inds, pixels,
        render_cfg=render_cfg, has_alpha=has_alpha, bg_white=bg_white, H=H,
        W=W, bg=bg, noises=noises, generator=generator, distill=distill,
        depth_target=depth_target, depth_weight=depth_weight,
        patch_lpips_fn=patch_lpips_fn, patch_size=patch_size)
    _apply_step(net, ema_net, optimizer, scheduler, loss, ema_decay)
    return {"loss": loss.detach(), "per_ray_error": per_ray.detach(),
            "n_samples": out["n_samples"]}


def train_loss(net, occupancy, pose, intrinsics, inds, pixels, *,
               render_cfg: RenderConfig, has_alpha: bool, bg_white: bool,
               H: int, W: int, bg=None, noises=None, generator=None,
               distill: bool = False, depth_target=None,
               depth_weight: float = 1e-3, patch_lpips_fn=None,
               patch_size: int = 1):
    """train_step's forward: (loss, per_ray [N], the render's outputs)."""
    with span("train.inputs"):
        rays_o, rays_d = get_rays(pose, intrinsics, inds, H, W)
        N = inds.shape[0]
        if has_alpha and not bg_white:
            if bg is None:
                bg = torch.rand((N, 3), generator=generator,
                                device=pose.device)
        else:
            bg = torch.ones((N, 3), dtype=torch.float32, device=pose.device)
        if has_alpha:
            gt = pixels[:, :3] * pixels[:, 3:] + bg * (1.0 - pixels[:, 3:])
        else:
            gt = pixels[:, :3]

    out = render_rays_train(net, occupancy, rays_o, rays_d,
                            render_cfg=render_cfg, bg_color=bg, perturb=True,
                            noises=noises, generator=generator)
    with span("render.composite"):
        per_ray = torch.mean((out["image"] - gt) ** 2, dim=-1)
        loss = torch.mean(per_ray)
        if distill and depth_target is not None:
            dw = (depth_target > 0).to(torch.float32)
            loss = loss + depth_weight * torch.mean(
                ((out["depth"] - (depth_target - out["nears"])) * dw) ** 2)
        if patch_lpips_fn is not None and patch_size > 1:
            ps = patch_size
            loss = loss + 1e-3 * torch.mean(patch_lpips_fn(
                out["image"].reshape(-1, ps, ps, 3),
                gt.reshape(-1, ps, ps, 3)))
    return loss, per_ray, out


def _apply_step(net, ema_net, optimizer, scheduler, loss, ema_decay):
    """Backward, Adam step, LR schedule step and the EMA update."""
    with span("train.backward"):
        loss.backward()
    with span("train.optimizer"):
        optimizer.step()
        scheduler.step()
        _ema_update(net, ema_net, ema_decay)


@torch.no_grad()
def _ema_update(net, ema_net, ema_decay):
    for e, p in zip(ema_net.parameters(), net.parameters()):
        e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)


def train_step_npr(net, ema_net, optimizer, scheduler, occupancy, pose,
                   intrinsics, inds, target, style_img, target_weights,
                   depth_target, depth_weights, *, render_cfg: RenderConfig,
                   ema_decay: float, H: int, W: int,
                   style_weight_d: float = 0.5, depth_weight_d: float = 1e-3,
                   bg=None, noises=None, generator=None):
    """The NPR fine-tune step: the target_weights-weighted MSE toward the
    registration image, plus style_weight_d times the (1 - w / 2)-weighted
    MSE toward the stylized image, plus depth_weight_d times the masked
    depth MSE (depth_target absolute, against depth + near).

    Args:
      target, style_img: [N, 4] RGBA rows of the sampled pixels, composited
        on the random background bg [N, 3] (drawn from `generator` when
        not given). noises as in train_step.
    Returns aux {"loss"} (0-d tensor).
    """
    rays_o, rays_d = get_rays(pose, intrinsics, inds, H, W)
    if bg is None:
        bg = torch.rand((inds.shape[0], 3), generator=generator,
                        device=pose.device)
    gt_rgb = target[:, :3] * target[:, 3:] + bg * (1.0 - target[:, 3:])
    gt_style = style_img[:, :3] * style_img[:, 3:] \
        + bg * (1.0 - style_img[:, 3:])
    w = target_weights[:, None]

    optimizer.zero_grad(set_to_none=True)
    out = render_rays_train(net, occupancy, rays_o, rays_d,
                            render_cfg=render_cfg, bg_color=bg, perturb=True,
                            noises=noises, generator=generator)
    pred = out["image"]
    loss = torch.mean((w * (pred - gt_rgb)) ** 2)
    loss = loss + style_weight_d * torch.mean(
        ((1.0 - w / 2.0) * (gt_style - pred)) ** 2)
    loss = loss + depth_weight_d * torch.mean(
        (depth_weights * (out["depth"] - (depth_target - out["nears"])))
        ** 2)
    _apply_step(net, ema_net, optimizer, scheduler, loss, ema_decay)
    return {"loss": loss.detach()}


def train_step_clip(net, ema_net, optimizer, scheduler, occupancy,
                    clip_model, text_z, pose, intrinsics, *,
                    render_cfg: RenderConfig, ema_decay: float, H: int,
                    W: int, noises=None, generator=None):
    """The CLIP-guided step: render all H x W rays of one camera through
    the training path (perturbed; white, or the background network's,
    behind the scene) and minimise -(CLIP image embedding . text
    embedding) through the frozen tower (models/clip_vit.py); gradients
    reach only the NeRF. noises [H * W] as in train_step.
    Returns aux {"loss"} (0-d tensor)."""
    from ..models.clip_vit import clip_similarity_loss

    inds = torch.arange(H * W, device=pose.device)
    rays_o, rays_d = get_rays(pose, intrinsics, inds, H, W)
    optimizer.zero_grad(set_to_none=True)
    out = render_rays_train(net, occupancy, rays_o, rays_d,
                            render_cfg=render_cfg, bg_color=None,
                            perturb=True, noises=noises, generator=generator)
    loss = clip_similarity_loss(clip_model, out["image"].reshape(1, H, W, 3),
                                text_z)
    _apply_step(net, ema_net, optimizer, scheduler, loss, ema_decay)
    return {"loss": loss.detach()}


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
    """Host-side training orchestration: the NeRF main path, the distill
    fine-tune, evaluation and (with a `workspace`) checkpoints and a log."""

    def __init__(self, model_cfg: NeRFConfig, render_cfg: RenderConfig, *,
                 device="cuda", lr: float = 1e-2, iters: int = 30000,
                 ema_decay: float = 0.95, update_interval: int = 16,
                 bg_white: bool = False, eval_chunk: int = 16384,
                 seed: int = 0, workspace=None, name: str = "ngp",
                 max_keep_ckpt: int = 2, patch_size: int = 1):
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
        self.stats = {"loss": [], "psnr": [], "lpips": []}
        self._lpips_meter = None  # built by the first evaluate
        self.workspace = workspace
        self.ckpt = None
        self.writer = None
        if workspace is not None:
            os.makedirs(workspace, exist_ok=True)
            self.ckpt = CheckpointManager(workspace, name=name,
                                          max_keep=max_keep_ckpt)
            try:
                from tensorboardX import SummaryWriter
            except ImportError:  # optional, as in the JAX package
                pass
            else:
                self.writer = SummaryWriter(os.path.join(workspace, "run"))
        # the patch-LPIPS term needs patch-sampled batches and local VGG-16
        # weights; without the weights training runs without it
        self.patch_size = patch_size
        self.patch_lpips_fn = None
        if patch_size > 1:
            from ..editing.vgg import lpips_fn

            try:
                self.patch_lpips_fn = lpips_fn(device=self.device)
            except RuntimeError:
                self.log("[warn] patch LPIPS loss disabled "
                         "(no local VGG16 weights)")

    def log_scalar(self, tag, value, step=None):
        if self.writer is not None:
            self.writer.add_scalar(tag, value,
                                   self.global_step if step is None else step)

    def log(self, msg):
        print(msg, flush=True)
        if self.workspace is not None:
            with open(os.path.join(self.workspace, "log.txt"), "a") as f:
                f.write(msg + "\n")

    def _tensor(self, a, dtype=torch.float32):
        if isinstance(a, torch.Tensor):
            if a.device.type != self.device.type:
                count("sync.host_copy")
            return a.to(device=self.device, dtype=dtype)
        count("sync.host_copy")
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
        full = self.occ_state.iter_density < 16
        with span("occupancy.refresh", full=full):
            self.occ_state = occ_update(
                self.net, self.occ_state, bound=self.render_cfg.bound,
                full=full, density_scale=self.render_cfg.density_scale,
                density_thresh=self.render_cfg.density_thresh,
                generator=self.generator,
            )

    def _step(self, batch, has_alpha: bool, **kw):
        with span("train.step", step=self.global_step):
            self.maybe_update_occupancy()
            with span("train.inputs"):
                pose = self._tensor(batch["pose"])
                intrinsics = self._tensor(batch["intrinsics"])
                inds = self._tensor(batch["inds"], torch.int64)
                pixels = self._tensor(batch["pixels"])
            aux = train_step(
                self.net, self.ema_net, self.optimizer, self.scheduler,
                self.occ_state.occupancy, pose, intrinsics, inds, pixels,
                render_cfg=self.render_cfg, ema_decay=self.ema_decay,
                has_alpha=has_alpha, bg_white=self.bg_white, H=batch["H"],
                W=batch["W"], generator=self.generator,
                patch_lpips_fn=self.patch_lpips_fn,
                patch_size=self.patch_size, **kw,
            )
            self.global_step += 1
        return aux

    def train_one_batch(self, batch, has_alpha: bool):
        return self._step(batch, has_alpha)

    def train_one_batch_distill(self, batch, has_alpha: bool,
                                depth_sup: bool = False, bg=None,
                                noises=None):
        """Fine-tune step on distilled images; with depth_sup, the batch's
        "depth" (absolute ray depth of the edit, 0 elsewhere) supervises
        the rendered depth. bg and noises may be given as in train_step."""
        depth_target = None
        if depth_sup and "depth" in batch:
            depth_target = self._tensor(batch["depth"])
        return self._step(batch, has_alpha, distill=True,
                          depth_target=depth_target, bg=bg, noises=noises)

    def train_one_batch_npr(self, dataset, npr_view, num_rays: int = 4096,
                            inds=None, bg=None, noises=None):
        """One NPR fine-tune step on a baked supervision view
        (editing/npr_trainer.py::build_npr_nerf_dataset) at num_rays
        random pixels of it. inds [num_rays], bg and noises are drawn from
        the trainer's generator unless given."""
        self.maybe_update_occupancy()
        H, W = dataset.H, dataset.W
        idx = int(npr_view["view_index"])
        if inds is None:
            inds = torch.randint(0, H * W, (num_rays,),
                                 generator=self.generator, device=self.device)
        inds = torch.as_tensor(inds, dtype=torch.int64, device=self.device)

        def rows(key, width):
            return self._tensor(npr_view[key]).reshape(H * W, width)[inds]

        aux = train_step_npr(
            self.net, self.ema_net, self.optimizer, self.scheduler,
            self.occ_state.occupancy, self._tensor(dataset.poses[idx]),
            self._tensor(dataset.intrinsics), inds, rows("target", 4),
            rows("style_img", 4), rows("target_weights", 1)[:, 0],
            rows("depth", 1)[:, 0], rows("depth_weights", 1)[:, 0],
            render_cfg=self.render_cfg, ema_decay=self.ema_decay, H=H, W=W,
            bg=bg, noises=noises, generator=self.generator)
        self.global_step += 1
        return aux

    def train_one_batch_clip(self, clip_model, text_z, pose, intrinsics,
                             H: int, W: int, noises=None):
        """One CLIP-guided step on a camera with no ground truth (such as
        data/provider.py::rand_poses draws): clip_model from
        models/clip_vit.py::load_clip_vision, text_z the fixed [512] text
        embedding (train/clip_guidance.py::text_embedding, or any vector).
        noises [H * W] are drawn from the trainer's generator unless
        given."""
        self.maybe_update_occupancy()
        aux = train_step_clip(
            self.net, self.ema_net, self.optimizer, self.scheduler,
            self.occ_state.occupancy, clip_model, self._tensor(text_z),
            self._tensor(pose), self._tensor(intrinsics),
            render_cfg=self.render_cfg, ema_decay=self.ema_decay, H=H, W=W,
            noises=noises, generator=self.generator)
        self.global_step += 1
        return aux

    def train(self, dataset, max_steps=None, valid_dataset=None,
              eval_interval: int = 0, log_every: int = 100):
        """Train until global_step reaches max_steps (iters by default):
        epochs of shuffled views, one batch each; the error map takes each
        step's per-ray errors; with a valid_dataset, evaluate every
        eval_interval epochs; save a checkpoint at the end."""
        max_steps = max_steps or self.iters
        has_alpha = dataset.images.shape[-1] == 4
        self.mark_untrained(dataset)
        t_start = time.time()
        epoch = 0
        while self.global_step < max_steps:
            epoch += 1
            for idx in dataset.epoch_indices():
                if self.global_step >= max_steps:
                    break
                batch = dataset.get_batch(int(idx))
                aux = self.train_one_batch(batch, has_alpha)
                if "inds_coarse" in batch:
                    dataset.update_error_map(
                        int(idx), batch["inds_coarse"],
                        aux["per_ray_error"].cpu().numpy())
                if self.global_step % log_every == 0:
                    loss = float(aux["loss"])
                    self.stats["loss"].append(loss)
                    self.log_scalar("train/loss", loss)
                    self.log(
                        f"step {self.global_step}/{max_steps} "
                        f"loss={loss:.6f} "
                        f"psnr={-10 * np.log10(max(loss, 1e-12)):.2f} "
                        f"samples/ray="
                        f"{float(aux['n_samples'].float().mean()):.1f} "
                        f"({time.time() - t_start:.1f}s)")
            # every eval_interval epochs, not every epoch
            if (eval_interval and valid_dataset is not None
                    and epoch % eval_interval == 0):
                self.evaluate(valid_dataset)
        self.save_checkpoint()

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

    @torch.no_grad()
    def render_distill_frame(self, edit_grid, pose, intrinsics, H: int,
                             W: int, grow_grid: bool = False, chunk=None,
                             net=None, dir_offset=None):
        """Full-frame distill-path render in raster order, in pieces of at
        most chunk rays (eval_chunk by default; the last one shorter, no
        padding), with the EMA network unless `net` is given; dir_offset
        [2] jitters every ray off its pixel centre (get_rays). The skip
        field (of the edit grid when grow_grid, else of the density grid)
        and the gather table are built once per frame.
        Returns numpy arrays [H*W, ...] (image, depth, depth_edit, weights,
        weights_edit, x_term, nears) and the float min_near."""
        net = self.ema_net if net is None else net
        chunk = chunk or self.eval_chunk
        egrid = torch.as_tensor(np.asarray(edit_grid), dtype=torch.uint8,
                                device=self.device)
        march_src = egrid if grow_grid else self.occ_state.occupancy
        skip_flat = build_march_tables(march_src, render_cfg=self.render_cfg)
        gather_table = gather_table_for(net)
        rays_o, rays_d = pixel_rays(
            self._tensor(pose), self._tensor(intrinsics), H, W,
            None if dir_offset is None else self._tensor(dir_offset))
        n = H * W
        keys = ("image", "depth", "depth_edit", "weights", "weights_edit",
                "x_term", "nears")
        outs = {k: [] for k in keys}
        min_near = []
        for s in range(0, n, chunk):
            out = render_rays_distill(
                net, self.occ_state.occupancy, egrid, rays_o[s:s + chunk],
                rays_d[s:s + chunk], render_cfg=self.render_cfg,
                grow_grid=grow_grid, skip_flat=skip_flat,
                gather_table=gather_table)
            for k in keys:
                outs[k].append(out[k])
            min_near.append(out["min_near"])
        res = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        res["min_near"] = float(torch.stack(min_near).min())
        return res

    def evaluate(self, dataset, max_views=None):
        """PSNR, SSIM and (with local VGG-16 weights) LPIPS over a split's
        views (white background). The LPIPS meter is built once and kept.
        Returns the mean PSNR."""
        if self._lpips_meter is None:
            self._lpips_meter = LPIPSMeter(device=self.device)
        pm, sm, lm = psnr_meter(), ssim_meter(), self._lpips_meter
        lm.clear()
        n = len(dataset) if max_views is None else min(max_views,
                                                       len(dataset))
        for i in range(n):
            img, _ = self.render_image(dataset.poses[i], dataset.intrinsics,
                                       dataset.H, dataset.W)
            gt = dataset.images[i]
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
            for m in (pm, sm, lm):
                m.update(img, gt)
        self.log(f"[eval] {pm.report()} | {sm.report()} | {lm.report()}")
        self.stats["psnr"].append(pm.measure())
        self.log_scalar("eval/psnr", pm.measure())
        self.log_scalar("eval/ssim", sm.measure())
        if lm.available:
            self.stats["lpips"].append(lm.measure())
            self.log_scalar("eval/lpips", lm.measure())
            self.log(f"eval/lpips {lm.measure():.6f}")
        return pm.measure()

    # -- checkpoints -------------------------------------------------------

    def _ckpt_tree(self):
        """The JAX package's checkpoint tree ({"state": TrainState, "occ":
        OccupancyState}, optax Adam moments under opt_state) as numpy."""
        from ..convert import params_to_numpy, tree_from_state_dict

        states = {n: self.optimizer.state.get(p, {})
                  for n, p in self.net.named_parameters()}
        mom = {k: {n: st.get(k, torch.zeros_like(p))
                   for (n, st), p in zip(states.items(),
                                         self.net.parameters())}
               for k in ("exp_avg", "exp_avg_sq")}
        count = int(states["encoder"].get("step", 0))  # one for every leaf
        adam = SimpleNamespace(count=np.int32(count),
                               mu=tree_from_state_dict(mom["exp_avg"]),
                               nu=tree_from_state_dict(mom["exp_avg_sq"]))
        occ = self.occ_state
        return {
            "state": SimpleNamespace(
                params=params_to_numpy(self.net),
                opt_state=(adam, SimpleNamespace(count=np.int32(count))),
                ema_params=params_to_numpy(self.ema_net),
                step=np.int32(self.global_step)),
            "occ": SimpleNamespace(
                density_grid=occ.density_grid, occupancy=occ.occupancy,
                mean_density=occ.mean_density,
                iter_density=np.int32(occ.iter_density)),
        }

    def save_checkpoint(self, best_metric=None):
        """Save the weights, EMA, Adam state and occupancy state under
        <workspace>/checkpoints (rolling); with best_metric, also the best
        one. Returns the path."""
        if self.ckpt is None:
            raise ValueError("save_checkpoint needs a Trainer workspace")
        meta = {"global_step": self.global_step}
        tree = self._ckpt_tree()
        path = self.ckpt.save(self.global_step, tree, meta)
        if best_metric is not None:
            self.ckpt.save_best(best_metric, tree, meta)
        return path

    def load_checkpoint(self, mode="latest"):
        """Load scratch / latest / best / <path>; a JAX Trainer's
        checkpoint loads the same way. Returns False when there is none."""
        from ..convert import params_from_jax

        path = (self.ckpt.resolve(mode) if self.ckpt is not None else
                (mode if os.path.exists(str(mode)) else None))
        if path is None:
            self.log(f"[ckpt] no checkpoint for mode={mode}, from scratch")
            return False
        tree, meta = load_pytree(path, self._ckpt_tree())
        st = tree["state"]
        self.net.load_state_dict(params_from_jax(st.params))
        self.ema_net.load_state_dict(params_from_jax(st.ema_params))
        adam = st.opt_state[0]
        count = int(adam.count)
        mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
        for name, p in self.net.named_parameters():
            self.optimizer.state.pop(p, None)
            if count > 0:
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu[name].to(self.device),
                    "exp_avg_sq": nu[name].to(self.device)}
        sched = self.scheduler
        sched.last_epoch = int(st.opt_state[1].count)
        for group, base, lam in zip(self.optimizer.param_groups,
                                    sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * lam(sched.last_epoch)
        sched._last_lr = [g["lr"] for g in self.optimizer.param_groups]
        occ = tree["occ"]
        self.occ_state = OccupancyState(
            density_grid=self._tensor(occ.density_grid),
            occupancy=self._tensor(occ.occupancy, torch.uint8),
            mean_density=self._tensor(occ.mean_density),
            iter_density=int(occ.iter_density))
        self.global_step = int(meta.get("global_step", int(st.step)))
        self.log(f"[ckpt] loaded {path} at step {self.global_step}")
        return True
