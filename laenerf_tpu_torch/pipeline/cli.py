"""Command-line entry point of the port (counterpart of
laenerf_tpu/pipeline/cli.py), with the same flags and defaults:

  python -m laenerf_tpu_torch.pipeline.cli <data_path> --workspace ws [flags]

Three routes: --test renders the test split (a colmap scene's slerp
trajectory) from a workspace's checkpoint into <ws>/results/ with its video
(and with --save_mesh the density isosurface, <ws>/mesh.ply); -m nerf
trains (Trainer.train, error-map sampling with --error_map, the
patch-LPIPS term with --patch_size > 1 and VGG-16 weights) and evaluates
on the val split; -m recolor|style runs the editing pipeline
(EditPipeline.run_all) on the trained NeRF, training it first when the
workspace has no checkpoint.

It runs on the GPU. LAENERF_PLATFORM=cpu runs it on the CPU instead; any
other value, or no GPU without it, raises.
"""

import argparse
import json
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser("laenerf_tpu_torch")
    p.add_argument("path", type=str, help="dataset root (transforms*.json)")
    p.add_argument("-m", "--mode", type=str, default="nerf",
                   choices=["nerf", "recolor", "style"])
    p.add_argument("--test", action="store_true")
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)

    # training
    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--max_steps", type=int, default=1024)
    p.add_argument("--update_extra_interval", type=int, default=16)
    p.add_argument("--max_ray_batch", type=int, default=16384)
    p.add_argument("--patch_size", type=int, default=1)
    p.add_argument("--eval_interval", type=int, default=50)

    # dataset
    p.add_argument("--color_space", type=str, default="srgb")
    p.add_argument("--preload", action="store_true")
    p.add_argument("--bound", type=float, default=2.0)
    p.add_argument("--scale", type=float, default=0.33)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--dt_gamma", type=float, default=1 / 128)
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--density_thresh", type=float, default=10)
    p.add_argument("--bg_radius", type=float, default=-1)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--no_bg", action="store_true")
    p.add_argument("--error_map", action="store_true")
    p.add_argument("-O", action="store_true",
                   help="accepted for script compat; bf16 gathers and "
                        "occupancy marching are always on")
    p.add_argument("--fp16", action="store_true")
    p.add_argument("--cuda_ray", action="store_true",
                   help="accepted for script compat; marching is always on")
    p.add_argument("--ff", action="store_true",
                   help="accepted for script compat; one MLP backbone")
    p.add_argument("--tcnn", action="store_true",
                   help="accepted for script compat; same as --ff")

    # march and evaluation shapes
    p.add_argument("--march_iters", type=int, default=None,
                   help="march event budget; default = max_steps so rays always cover [near, far] (see docs/DESIGN.md)")
    p.add_argument("--m_cap_per_ray", type=int, default=32)
    p.add_argument("--infer_chunk_events", type=int, default=16)
    p.add_argument("--eval_chunk", type=int, default=16384)
    p.add_argument("--filter_close_point", action="store_true")

    # editing & stylization
    p.add_argument("--ablation_dir", type=str, default="ablation_")
    p.add_argument("--ablation_folder", type=str, default="test")
    p.add_argument("--tv_weight", type=float, default=0.0)
    p.add_argument("--depth_disc_weight", type=float, default=0.0)
    p.add_argument("--smooth_trans_weight", type=float, default=0.0)
    p.add_argument("--style_weight", type=float, default=0.0)
    p.add_argument("--style_layers", action="append", type=int)
    p.add_argument("--tv_depth_guide", action="store_true")
    p.add_argument("--intensity_weight", type=float, default=0.0)
    p.add_argument("--preserve_color", action="store_true")
    p.add_argument("--train_steps_style", type=int, default=3000)
    p.add_argument("--train_steps_distill", type=int, default=3000)
    p.add_argument("--style_image", type=str, default=None)
    p.add_argument("--offset_loss", type=float, default=0.0)
    p.add_argument("--weight_loss_non_uniform", type=float, default=0.0)
    p.add_argument("--weight_loss_uniform", type=float, default=0.0)
    p.add_argument("--palette_loss_valid", type=float, default=0.0)
    p.add_argument("--palette_loss_distinct", type=float, default=0.0)
    p.add_argument("--num_palette_bases", type=int, default=4)
    p.add_argument("--distill_palette_steps", type=int, default=1500)
    p.add_argument("--run_all", action="store_true")
    p.add_argument("--gui", action="store_true",
                   help="accepted for script compat; runs headless")
    p.add_argument("--warmup_iterations", type=int, default=1000)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--style_enc_path", type=str, default=None)
    p.add_argument("--palette_path", type=str, default=None)
    p.add_argument("--depth_diff", type=float, default=0.5)
    p.add_argument("--use_error_maps", action="store_true")
    p.add_argument("--load_edit_dataset", type=str, default=None)
    p.add_argument("--edit_grid_path", type=str, default=None,
                   help="edit_grid.npz from a previous/interactive session")
    p.add_argument("--grow_grid_path", type=str, default=None)
    p.add_argument("--select_pixel", type=int, nargs=2, default=None,
                   help="headless region selection: pixel (x y) in view 0")
    p.add_argument("--grow_iterations", type=int, default=50000)
    p.add_argument("--palette_mod", type=str, default=None,
                   help="npz with 'palette' [K,3]: user-recolored palette")

    # distributed training: the process group of a torchrun launch
    p.add_argument("--multihost", action="store_true",
                   help="join torch.distributed's process group from "
                        "torchrun's environment")

    # mesh
    p.add_argument("--save_mesh", action="store_true")
    p.add_argument("--mesh_resolution", type=int, default=256)
    p.add_argument("--mesh_threshold", type=float, default=10.0)
    return p


def make_configs(opt):
    """The CLI's model: the full 16-level C = 2 lg19 hash grid at the
    scene's bound, 1 + ceil(log2(bound)) cascades of 128^3."""
    import math

    from ..models import NeRFConfig, RenderConfig

    model_cfg = NeRFConfig(bound=opt.bound, bg_radius=opt.bg_radius)
    cascades = 1 + math.ceil(math.log2(max(opt.bound, 1.0)))
    render_cfg = RenderConfig(
        bound=opt.bound, cascades=cascades, grid_size=128,
        dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
        min_near=opt.min_near, density_thresh=opt.density_thresh,
        march_iters=opt.march_iters or opt.max_steps,
        m_cap_per_ray=opt.m_cap_per_ray,
        infer_chunk_events=opt.infer_chunk_events,
    )
    return model_cfg, render_cfg


def select_device():
    """The GPU, or the CPU where LAENERF_PLATFORM=cpu; never a fallback."""
    platform = os.environ.get("LAENERF_PLATFORM", "")
    if platform == "cpu":
        return torch.device("cpu")
    if platform:
        raise ValueError(f"LAENERF_PLATFORM={platform!r}: use cpu, or leave "
                         f"it unset for the GPU")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CLI runs on the GPU "
                           "(LAENERF_PLATFORM=cpu runs it on the CPU)")
    return torch.device("cuda")


def _save_mesh(trainer, opt):
    from ..utils.mesh import save_density_mesh

    save_density_mesh(trainer, os.path.join(opt.workspace, "mesh.ply"),
                      resolution=opt.mesh_resolution,
                      threshold=opt.mesh_threshold)


def main(argv=None):
    opt = build_parser().parse_args(argv)
    if opt.style_layers is None:
        opt.style_layers = [10, 12, 14]
    device = select_device()
    if opt.multihost:
        # join the process group torchrun describes (NCCL on the GPU, gloo
        # on the CPU), as the JAX CLI's jax.distributed.initialize()
        from ..parallel import make_mesh

        device = make_mesh(device).device

    from ..data import NeRFDataset
    from ..train import Trainer
    from ..utils.images import to_u8, write_png
    from ..utils.video import write_video

    model_cfg, render_cfg = make_configs(opt)
    workspace = opt.workspace
    trainer = Trainer(
        model_cfg, render_cfg, device=device, lr=opt.lr, iters=opt.iters,
        update_interval=opt.update_extra_interval, seed=opt.seed,
        eval_chunk=opt.eval_chunk, workspace=workspace,
        patch_size=opt.patch_size,
    )

    def load_split(split, required=True):
        try:
            return NeRFDataset(opt.path, split, downscale=opt.downscale,
                               scale=opt.scale, offset=opt.offset,
                               num_rays=opt.num_rays, error_map=opt.error_map,
                               patch_size=opt.patch_size, seed=opt.seed,
                               color_space=opt.color_space)
        except FileNotFoundError:
            if required:
                raise
            return None

    if opt.test:
        trainer.load_checkpoint(opt.ckpt)
        test_ds = load_split("test")
        out_dir = os.path.join(workspace, "results")
        os.makedirs(out_dir, exist_ok=True)
        frames = []
        for i in range(len(test_ds)):
            img, _ = trainer.render_image(test_ds.poses[i],
                                          test_ds.intrinsics, test_ds.H,
                                          test_ds.W)
            frames.append(to_u8(img))
            write_png(os.path.join(out_dir, f"{i:04d}.png"), frames[-1])
        write_video(os.path.join(out_dir, "video.mp4"), frames)
        if test_ds.has_gt:
            trainer.evaluate(test_ds)
        if opt.save_mesh:
            _save_mesh(trainer, opt)
        return

    train_ds = load_split("train")
    val_ds = load_split("val", required=False)

    if opt.mode == "nerf":
        trainer.load_checkpoint(opt.ckpt)
        trainer.train(train_ds, max_steps=opt.iters, valid_dataset=val_ds,
                      eval_interval=opt.eval_interval)
        if val_ds is not None:
            trainer.evaluate(val_ds)
        if opt.save_mesh:
            _save_mesh(trainer, opt)
        return

    # ---- recolor / style: the run_all pipeline ------------------------
    from ..editing import EditGrid, StyleLossWeights
    from .driver import EditPipeline, PipelineConfig, project_points

    if not trainer.load_checkpoint(opt.ckpt):
        print("[cli] no NeRF checkpoint found; training first")
        trainer.train(train_ds, max_steps=opt.iters)

    edit_ws = os.path.join(opt.ablation_dir, opt.ablation_folder)
    os.makedirs(edit_ws, exist_ok=True)

    # the region: saved grids, or grown from a pixel of view 0
    density = trainer.occ_state.density_grid.cpu().numpy()
    thresh = min(float(trainer.occ_state.mean_density), opt.density_thresh)
    if opt.edit_grid_path:
        eg = EditGrid.load(opt.edit_grid_path)
    else:
        px = opt.select_pixel or [train_ds.W // 2, train_ds.H // 2]
        pts = project_points(trainer, train_ds.poses[0], train_ds.intrinsics,
                             [px], train_ds.H, train_ds.W)
        eg = EditGrid(render_cfg.cascades, render_cfg.grid_size)
        eg.new_from_points(pts, bound=opt.bound)
        eg.grow_region_queue(density, thresh,
                             grow_iterations=opt.grow_iterations)
    grow = None
    if opt.grow_grid_path:
        grow = EditGrid.load(opt.grow_grid_path)
    elif opt.smooth_trans_weight > 0:
        grow = EditGrid(render_cfg.cascades, render_cfg.grid_size)
        grow.grid_from_growing_queue(eg, density, thresh)

    weights = StyleLossWeights(
        tv_weight=opt.tv_weight, depth_disc_weight=opt.depth_disc_weight,
        smooth_trans_weight=opt.smooth_trans_weight,
        style_weight=opt.style_weight if opt.mode == "style" else 0.0,
        intensity_weight=opt.intensity_weight, offset_loss=opt.offset_loss,
        weight_loss_non_uniform=opt.weight_loss_non_uniform,
        weight_loss_uniform=opt.weight_loss_uniform,
        palette_loss_valid=opt.palette_loss_valid,
        palette_loss_distinct=opt.palette_loss_distinct,
        tv_depth_guide=opt.tv_depth_guide,
        warmup_iterations=opt.warmup_iterations,
    )
    pal_mod = None
    if opt.palette_mod:
        pal_mod = np.load(opt.palette_mod)["palette"]
    pcfg = PipelineConfig(
        mode=opt.mode, train_steps_style=opt.train_steps_style,
        train_steps_distill=opt.train_steps_distill,
        distill_palette_steps=opt.distill_palette_steps,
        num_palette_bases=opt.num_palette_bases,
        style_image=opt.style_image, style_layers=tuple(opt.style_layers),
        crop_size=opt.crop_size, preserve_color=opt.preserve_color,
        depth_diff=opt.depth_diff, use_error_maps=opt.use_error_maps,
        no_bg=opt.no_bg, weights=weights, palette_mod=pal_mod,
        style_enc_path=opt.style_enc_path, palette_path=opt.palette_path,
        load_edit_dataset=opt.load_edit_dataset,
    )
    pipe = EditPipeline(trainer, train_ds, pcfg, edit_ws, eg, grow,
                        seed=opt.seed)
    test_ds = load_split("test", required=False)
    video_ds = load_split("video", required=False) or test_ds
    results = pipe.run_all(val_dataset=val_ds, test_dataset=test_ds,
                           video_dataset=video_ds)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
