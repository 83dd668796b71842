"""Headless recolor / style / NPR pipeline driver (counterpart of
laenerf_tpu/pipeline/driver.py).

Recolor and style (EditPipeline): on a trained NeRF and a selected region,
the phases run in order: init (the edit dataset; with style_weight > 0
the style image and its VGG-19 StyleNetwork), LAENeRF training with
palette pruning (the Gram loss past warm-up in the style mode),
distillation into the train images with the user's palette, the NeRF
fine-tune on the distilled images (depth-supervised in the style mode),
and evaluation. Each writes the JAX package's artifacts: hparams.json,
opt.json, edit_grid.npz, grow_grid.npz, style_image.png, style_enc.npz,
palet_og.npz, palet_mod.npz, palette_eval.json, timings.json,
results_psnr_train.json, and render_*/ and masks/*/ PNGs.

NPR (run_npr_pipeline): from one stylized reference view, the
registration dataset, LAENeRF training on its targets, the baked
supervision images and the NeRF fine-tune (train_one_batch_npr).
"""

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..convert import laenerf_params_from_jax, laenerf_params_to_numpy
from ..data.rays import get_rays
from ..editing.distill import distill_dataset
from ..editing.edit_dataset import EditDataset
from ..editing.editgrid import EditGrid
from ..editing.laenerf import LAENeRFConfig
from ..editing.style import StyleNetwork
from ..editing.style_trainer import LAENeRFTrainer, StyleLossWeights
from ..models.renderer import render_rays_distill
from ..train.checkpoints import load_pytree, save_pytree
from ..utils.images import to_u8, write_png
from ..utils.timers import PhaseTimer
from ..utils.video import write_video


@dataclasses.dataclass
class PipelineConfig:
    """Editing-pipeline settings (the JAX package's fields)."""

    mode: str = "recolor"  # recolor | style
    train_steps_style: int = 3000
    train_steps_distill: int = 3000
    distill_palette_steps: int = 1500
    num_palette_bases: int = 4
    style_image: Optional[str] = None
    style_layers: Sequence[int] = (10, 12, 14)
    crop_size: int = 256
    preserve_color: bool = False
    depth_diff: float = 0.5
    use_error_maps: bool = False
    no_bg: bool = False
    blend_thresh: float = 0.5
    weights: StyleLossWeights = dataclasses.field(
        default_factory=StyleLossWeights)
    # the user's palette edit, applied at distillation
    palette_mod: Optional[np.ndarray] = None
    palette_weights: Optional[np.ndarray] = None
    palette_biases: Optional[np.ndarray] = None
    style_lg: int = 19  # log2 of the LAENeRF encoder's hashed level size
    # reload a trained LAENeRF (+ palette) and skip its training
    style_enc_path: Optional[str] = None
    palette_path: Optional[str] = None
    load_edit_dataset: Optional[str] = None


@torch.no_grad()
def project_points(trainer, pose, intrinsics, pixels_xy, H, W):
    """Pixel (x, y) coordinates -> their rays' termination points [n, 3]:
    the distill path's absolute-depth x_term, with an empty edit grid and
    the EMA network."""
    pixels_xy = np.asarray(pixels_xy).reshape(-1, 2)
    inds = (pixels_xy[:, 1] * W + pixels_xy[:, 0]).astype(np.int64)
    rays_o, rays_d = get_rays(trainer._tensor(pose),
                              trainer._tensor(intrinsics),
                              trainer._tensor(inds, torch.int64), H, W)
    occ = trainer.occ_state.occupancy
    out = render_rays_distill(trainer.ema_net, occ, torch.zeros_like(occ),
                              rays_o, rays_d,
                              render_cfg=trainer.render_cfg)
    return out["x_term"].cpu().numpy()


class EditPipeline:
    """Runs the recolor or style workflow's phases on a trained NeRF (the
    port's Trainer), on the trainer's device."""

    def __init__(self, trainer, dataset, cfg: PipelineConfig, workspace: str,
                 edit_grid: EditGrid, grow_grid: Optional[EditGrid] = None,
                 seed: int = 0):
        self.trainer = trainer
        self.dataset = dataset
        self.cfg = cfg
        self.workspace = workspace
        os.makedirs(workspace, exist_ok=True)
        self.edit_grid = edit_grid
        self.grow_grid = grow_grid
        self.timer = PhaseTimer()
        self.seed = seed
        self.style_trainer: Optional[LAENeRFTrainer] = None
        self.edit_dataset: Optional[EditDataset] = None
        self.original_palette = None
        self.laenerf_cfg = LAENeRFConfig(
            bound=trainer.model_cfg.bound,
            num_palette_bases=cfg.num_palette_bases,
            log2_hashmap_size=cfg.style_lg)

    def _path(self, name):
        return os.path.join(self.workspace, name)

    # -- init: the edit dataset ------------------------------------------

    def init_phase(self):
        cfg = self.cfg
        self.timer.start("edit_dataset")
        if cfg.load_edit_dataset and os.path.exists(cfg.load_edit_dataset):
            self.edit_dataset = EditDataset.load(cfg.load_edit_dataset)
        else:
            self.edit_dataset = EditDataset(
                self.trainer, self.dataset, self.edit_grid.grid,
                None if self.grow_grid is None else self.grow_grid.grid,
                depth_diff=cfg.depth_diff,
                smooth_transition=cfg.weights.smooth_trans_weight > 0,
                out_dir=self._path("styleenc_train_dataset"))
            self.edit_dataset.save(self._path("edataset.npz"))
        self.timer.stop("edit_dataset")

        style_network = None
        if cfg.weights.style_weight > 0:
            style_network = self._style_network()
        self.style_trainer = LAENeRFTrainer(
            self.laenerf_cfg, cfg.weights, self.edit_dataset,
            style_network=style_network, crop_size=cfg.crop_size,
            device=self.trainer.device, seed=self.seed)
        if cfg.style_enc_path and os.path.exists(cfg.style_enc_path):
            self._reload_style_enc()

        self.edit_grid.save(self._path("edit_grid.npz"))
        if self.grow_grid is not None and self.grow_grid.grid is not None:
            self.grow_grid.save(self._path("grow_grid.npz"))
        w = cfg.weights
        with open(self._path("hparams.json"), "w") as f:
            json.dump({
                "palette_losses": {
                    "weight_loss_uniform": w.weight_loss_uniform,
                    "weight_loss_non_uniform": w.weight_loss_non_uniform,
                    "offset_loss": w.offset_loss,
                    "palette_loss_valid": w.palette_loss_valid,
                    "palette_loss_distinct": w.palette_loss_distinct,
                    "num_palette_bases": cfg.num_palette_bases,
                },
                "style_losses": {
                    "style_image": cfg.style_image,
                    "style_weight": w.style_weight,
                    "style_layers": list(cfg.style_layers),
                    "tv_weight": w.tv_weight,
                    "depth_disc_weight": w.depth_disc_weight,
                    "tv_depth_guide": w.tv_depth_guide,
                    "smooth_trans_weight": w.smooth_trans_weight,
                    "train_steps_style": cfg.train_steps_style,
                    "train_steps_distill": cfg.train_steps_distill,
                    "preserve_color": cfg.preserve_color,
                    "warmup_iterations": w.warmup_iterations,
                    # False: random VGG filters (no local weights npz)
                    "vgg_pretrained": None if style_network is None
                    else bool(style_network.pretrained),
                },
            }, f, indent=2)
        with open(self._path("opt.json"), "w") as f:
            json.dump({k: str(v) for k, v in dataclasses.asdict(cfg).items()},
                      f, indent=2)

    def _style_network(self):
        """The style image (RGB, any alpha dropped), written to
        style_image.png, and its StyleNetwork; under preserve_color the
        Gram targets are colour-matched to the first edit view's GT
        colours."""
        cfg = self.cfg
        with Image.open(cfg.style_image) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
        write_png(self._path("style_image.png"),
                  (img * 255).astype(np.uint8))
        sn = StyleNetwork(np.moveaxis(img, -1, 0),
                          style_layers=cfg.style_layers, size=cfg.crop_size,
                          preserve_color=cfg.preserve_color,
                          device=self.trainer.device)
        if cfg.preserve_color:
            target = self.edit_dataset.get_batch(0, jitter=False)
            n = int(target["n_valid"])
            sn.set_color_target(target["targets"][:n].T[:, :, None])
        return sn

    def _reload_style_enc(self):
        """Load a trained LAENeRF (style_enc.npz of either package) and,
        with palette_path, its edited palette."""
        cfg, st = self.cfg, self.style_trainer
        like = {"params": laenerf_params_to_numpy(st.model),
                "active": st.active.cpu().numpy()}
        tree, meta = load_pytree(cfg.style_enc_path, like)
        if not meta.get("octo_gather", False):
            raise NotImplementedError(
                "only LAENeRF weights of the octo table layout load")
        st.model.load_state_dict(laenerf_params_from_jax(tree["params"]))
        st.active = torch.as_tensor(tree["active"], dtype=torch.bool,
                                    device=st.device)
        self.original_palette = np.asarray(tree["params"]["palette"])
        if cfg.palette_path and os.path.exists(cfg.palette_path):
            with torch.no_grad():
                st.model.palette.copy_(torch.as_tensor(
                    np.load(cfg.palette_path)["palette"]))

    # -- LAENeRF training ------------------------------------------------

    def train_laenerf_phase(self, log_every: int = 500, log_fn=print):
        cfg = self.cfg
        self.timer.start("train_style_enc")
        if cfg.style_enc_path:
            self.timer.stop("train_style_enc")
            return
        st = self.style_trainer
        prune_at = cfg.train_steps_style - cfg.distill_palette_steps
        done = 0
        while done < cfg.train_steps_style:
            chunk = min(log_every, cfg.train_steps_style - done)
            if done < prune_at < done + chunk:
                chunk = prune_at - done
            mse = st.train_steps(chunk)
            done += chunk
            log_fn(f"[laenerf] step {done}/{cfg.train_steps_style} "
                   f"mse={mse:.5f} psnr={-10 * np.log10(max(mse, 1e-9)):.2f}")
            if done == prune_at and cfg.distill_palette_steps > 0:
                active = st.prune()
                log_fn(f"[laenerf] pruned palette -> "
                       f"{int(active.sum())}/{cfg.num_palette_bases} active")
        self.timer.stop("train_style_enc")
        self.original_palette = st.model.palette.detach().cpu().numpy()
        # the table layout travels with the weights
        save_pytree(self._path("style_enc.npz"),
                    {"params": laenerf_params_to_numpy(st.model),
                     "active": st.active},
                    meta={"paired_gather": False,
                          "octo_gather": self.laenerf_cfg.octo_gather,
                          "gather_dtype": self.laenerf_cfg.gather_dtype})
        np.savez(self._path("palet_og.npz"), palette=self.original_palette,
                 active=st.active.cpu().numpy())

    # -- distillation ----------------------------------------------------

    def distill_phase(self, log_fn=print):
        cfg = self.cfg
        st = self.style_trainer
        self.timer.start("distill_dataset")
        palette = st.model.palette.detach().cpu().numpy()
        palet_og = (self.original_palette if self.original_palette is not None
                    else palette)
        palet_mod = cfg.palette_mod if cfg.palette_mod is not None else palette
        stats = distill_dataset(
            self.dataset, self.edit_dataset, st.model, st.active, palet_og,
            palet_mod, palet_weights=cfg.palette_weights,
            palet_biases=cfg.palette_biases, blend_thresh=cfg.blend_thresh,
            smooth_transition=cfg.weights.smooth_trans_weight > 0,
            no_bg=cfg.no_bg, use_error_maps=cfg.use_error_maps,
            out_dir=self.workspace, save_train_dataset=True)
        np.savez(self._path("palet_mod.npz"), palette=palet_mod,
                 active=st.active.cpu().numpy())
        self.timer.stop("distill_dataset")
        log_fn(f"[distill] {stats}")
        return stats

    # -- NeRF fine-tune ----------------------------------------------------

    def finetune_phase(self, log_fn=print):
        """train_steps_distill fine-tune steps over shuffled distilled
        views; saves a checkpoint when the trainer has a workspace.
        Returns the steps' losses (0-d tensors, not read back)."""
        cfg = self.cfg
        self.timer.start("distill_nerf")
        tr = self.trainer
        has_alpha = self.dataset.images.shape[-1] == 4
        losses = []
        while len(losses) < cfg.train_steps_distill:
            for idx in self.dataset.epoch_indices():
                if len(losses) >= cfg.train_steps_distill:
                    break
                aux = tr.train_one_batch_distill(
                    self.dataset.get_batch(int(idx)), has_alpha,
                    depth_sup=cfg.weights.style_weight > 0)
                losses.append(aux["loss"])
                if len(losses) % 500 == 0:
                    log_fn(f"[finetune] step {len(losses)}/"
                           f"{cfg.train_steps_distill} "
                           f"loss={float(aux['loss']):.5f}")
        self.timer.stop("distill_nerf")
        if tr.ckpt is not None:
            tr.save_checkpoint()
        return losses

    # -- evaluation and artifacts ----------------------------------------

    def render_edit_mask(self, pose, intrinsics, H, W, thresh=0.5,
                         chunk=32768):
        """The edit grid projected into a view: 1 where more than thresh of
        the ray's weight ends inside the region."""
        r = self.trainer.render_distill_frame(self.edit_grid.grid, pose,
                                              intrinsics, H, W, chunk=chunk)
        frac = (r["weights_edit"]
                / np.maximum(r["weights"], 1e-6)).reshape(H, W)
        return (frac > thresh).astype(np.float32)

    def eval_phase(self, val_dataset=None, test_dataset=None,
                   video_dataset=None, log_fn=print):
        tr = self.trainer
        psnrs = []
        for i in range(len(self.dataset)):
            img, _ = tr.render_image(self.dataset.poses[i],
                                     self.dataset.intrinsics,
                                     self.dataset.H, self.dataset.W)
            gt = self.dataset.images[i]
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + (1 - gt[..., 3:])
            psnrs.append(float(-10 * np.log10(
                max(np.mean((img - gt) ** 2), 1e-10))))
        results = {"psnr_train": float(np.mean(psnrs))}
        with open(self._path("results_psnr_train.json"), "w") as f:
            json.dump(results, f, indent=2)

        for name, ds in (("val", val_dataset), ("test", test_dataset)):
            if ds is None:
                continue
            out_dir = self._path(f"render_{name}")
            mask_dir = os.path.join(self.workspace, "masks", name)
            os.makedirs(out_dir, exist_ok=True)
            os.makedirs(mask_dir, exist_ok=True)
            for i in range(len(ds)):
                img, _ = tr.render_image(ds.poses[i], ds.intrinsics, ds.H,
                                         ds.W)
                write_png(os.path.join(out_dir, f"{i:03d}.png"), to_u8(img))
                # the region's mask in the G channel
                mask = self.render_edit_mask(ds.poses[i], ds.intrinsics,
                                             ds.H, ds.W)
                mimg = np.zeros(mask.shape + (3,), np.uint8)
                mimg[..., 1] = (mask * 255).astype(np.uint8)
                write_png(os.path.join(mask_dir, f"{i:03d}.png"), mimg)
        if video_dataset is not None:
            frames = [to_u8(tr.render_image(p, video_dataset.intrinsics,
                                            video_dataset.H,
                                            video_dataset.W)[0])
                      for p in video_dataset.poses]
            write_video(self._path("video.mp4"), frames)
        self.timer.save(self._path("timings.json"))
        log_fn(f"[eval] {results} timings={self.timer.summary()}")
        return results

    def run_all(self, val_dataset=None, test_dataset=None,
                video_dataset=None, log_fn=print):
        """init -> LAENeRF training -> distillation -> fine-tune -> eval."""
        self.init_phase()
        self.train_laenerf_phase(log_fn=log_fn)
        self.distill_phase(log_fn=log_fn)
        self.finetune_phase(log_fn=log_fn)
        return self.eval_phase(val_dataset, test_dataset, video_dataset,
                               log_fn=log_fn)


def run_npr_pipeline(trainer, dataset, ref_npr_config: str, workspace: str,
                     weights: StyleLossWeights, train_steps_style: int = 3000,
                     train_steps_distill: int = 3000,
                     num_palette_bases: int = 4, reg_max_dist: float = 2e-2,
                     tv_min_dist: float = 10e-2, min_tv_factor: float = 0.1,
                     cos_loss_factor: float = 2.5, mse_loss: float = 6.0,
                     color_patch_loss: float = 30.0, feature_size: int = 256,
                     num_rays: int = 4096, log_fn=print, seed: int = 0):
    """Single-view reference NPR stylization on the trainer's device:
    register the stylized reference view (ref_npr_config: its directory),
    train an LAENeRF without direction encoding on the NPR targets, bake
    the supervision images and fine-tune the NeRF with train_step_npr.
    Writes style_enc.npz (+ .json), styleenc_train_dataset/,
    nerf_retrain_dataset/ and timings.json under workspace, and a
    checkpoint when the trainer has a workspace.

    Returns the NPRTrainer; its finetune_losses holds the fine-tune steps'
    losses (0-d tensors, not read back)."""
    from ..editing.npr_dataset import SingleViewEditDataset
    from ..editing.npr_trainer import NPRTrainer, build_npr_nerf_dataset
    from ..editing.semantic import SemanticEncoder

    os.makedirs(workspace, exist_ok=True)
    timer = PhaseTimer()
    sem = SemanticEncoder(device=trainer.device)
    timer.start("edit_dataset")
    npr_ds = SingleViewEditDataset(
        trainer, dataset, ref_npr_config, sem, min_dist=reg_max_dist,
        max_dist=tv_min_dist, min_tv_factor=min_tv_factor,
        feature_size=feature_size,
        out_dir=os.path.join(workspace, "styleenc_train_dataset"), seed=seed)
    timer.stop("edit_dataset")

    # the NPR LAENeRF has no direction encoding
    lcfg = LAENeRFConfig(bound=trainer.model_cfg.bound,
                         num_palette_bases=num_palette_bases, dir_degree=0)
    npr_tr = NPRTrainer(lcfg, weights, npr_ds, sem, device=trainer.device,
                        mse_loss_w=mse_loss, cos_loss_w=cos_loss_factor,
                        color_patch_w=color_patch_loss, seed=seed)
    timer.start("train_style_enc")
    done = 0
    while done < train_steps_style:
        chunk = min(500, train_steps_style - done)
        mse = npr_tr.train_steps(chunk)
        done += chunk
        log_fn(f"[npr] step {done}/{train_steps_style} mse={mse:.5f}")
    timer.stop("train_style_enc")
    save_pytree(os.path.join(workspace, "style_enc.npz"),
                {"params": laenerf_params_to_numpy(npr_tr.model),
                 "active": npr_tr.active},
                meta={"paired_gather": False,
                      "octo_gather": lcfg.octo_gather,
                      "gather_dtype": lcfg.gather_dtype})

    timer.start("distill_dataset")
    npr_views = build_npr_nerf_dataset(
        npr_ds, npr_tr.model, npr_tr.active, dataset,
        out_dir=os.path.join(workspace, "nerf_retrain_dataset"))
    timer.stop("distill_dataset")

    timer.start("distill_nerf")
    rng = np.random.RandomState(seed)
    npr_tr.finetune_losses = []
    for step in range(train_steps_distill):
        view = npr_views[rng.randint(len(npr_views))]
        aux = trainer.train_one_batch_npr(dataset, view, num_rays=num_rays)
        npr_tr.finetune_losses.append(aux["loss"])
        if (step + 1) % 500 == 0:
            log_fn(f"[npr finetune] {step + 1}/{train_steps_distill} "
                   f"loss={float(aux['loss']):.5f}")
    timer.stop("distill_nerf")
    if trainer.ckpt is not None:
        trainer.save_checkpoint()
    timer.save(os.path.join(workspace, "timings.json"))
    return npr_tr
