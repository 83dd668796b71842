"""Recolor gate: the recolor (or style) pipeline end to end on the NeRF the
quality gate trained (counterpart of scripts/recolor_gate.py, same flags
and defaults).

Region selection, LAENeRF training, distillation, the NeRF fine-tune and
evaluation at the reference budgets, recording the phases' wall clock
(timings.json) and the background MSE outside the exported masks
(eval/mse_background.py), the edit's locality.

Region: the blue hollow sphere of the lego-class scene, selected headlessly
by seeding the edit grid with points just inside its surface (the scripted
counterpart of the reference's click and region-grow, gui.py:562-575,
543-553).

Usage (after laenerf_tpu_torch.scripts.quality_gate has trained a model):
  python -m laenerf_tpu_torch.scripts.recolor_gate --workspace /tmp/qgate2 \
      [--style_steps 10000 --distill_steps 7000]

Runs on the GPU (LAENERF_PLATFORM=cpu: on the CPU).
"""

import argparse
import json
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("laenerf_tpu_torch.scripts.recolor_gate")
    p.add_argument("--workspace", default="/tmp/qgate2")
    p.add_argument("--style_steps", type=int, default=10000)
    p.add_argument("--distill_steps", type=int, default=7000)
    p.add_argument("--palette_steps", type=int, default=1500)
    p.add_argument("--mode", default="recolor", choices=["recolor", "style"])
    p.add_argument("--style_lg", type=int, default=19,
                   help="editing-encoder log2_hashmap_size (18 halves "
                        "the style-step backward table)")
    p.add_argument("--grow_iterations", type=int, default=4000,
                   help="BFS region-growing budget; the density graph is "
                        "connected, so an unbounded grow floods from the "
                        "selected part into the whole object")
    # the NeRF's shape: must match the checkpoint the quality gate trained
    p.add_argument("--num_levels", type=int, default=8)
    p.add_argument("--level_dim", type=int, default=4)
    p.add_argument("--lg", type=int, default=19)
    p.add_argument("--max_steps", type=int, default=512)
    return p


def make_configs(args):
    from ..models import NeRFConfig, RenderConfig

    # the JAX gate also asks for paired_gather=True here; its octo layout
    # takes precedence over it (laenerf_tpu/ops/hashgrid.py:464-467), so
    # the encoder computes the same function, and the port has only the
    # octo layout
    model_cfg = NeRFConfig(bound=1.0, num_levels=args.num_levels,
                           level_dim=args.level_dim,
                           log2_hashmap_size=args.lg)
    render_cfg = RenderConfig(bound=1.0, cascades=1, grid_size=128,
                              max_steps=args.max_steps,
                              march_iters=384 if args.max_steps <= 512
                              else 512,
                              m_cap_per_ray=32, density_thresh=10.0,
                              infer_chunk_events=16, infer_compact_factor=4)
    return model_cfg, render_cfg


def shell_seeds(dataset, n: int = 200):
    """n points just inside the blue shell at blender-world (-0.28, 0.22,
    0.4), in the ngp model space the edit grid lives in: (x, y, z) ->
    (y, z, x) * scale + offset (data/provider.py nerf_matrix_to_ngp)."""
    rng = np.random.RandomState(0)
    u = rng.randn(n, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts_world = np.array([-0.28, 0.22, 0.4]) + 0.14 * u
    return (pts_world[:, [1, 2, 0]] * dataset.scale
            + np.asarray(dataset.offset)).astype(np.float32)


def wave_style_image(path, size: int = 256):
    """The procedural wave-pattern style image (the reference ships
    wave_style.png) as a PNG."""
    from ..utils.images import write_png

    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    wave = 0.5 + 0.5 * np.sin(12 * xx + 5 * np.sin(6 * yy))
    img = np.stack([wave, 0.4 + 0.5 * wave ** 2, 0.9 - 0.6 * wave], -1)
    write_png(path, (img * 255).astype(np.uint8))
    return path


def pipeline_config(args, ws):
    """The gate's PipelineConfig for args.mode (run_llff.sh:58-97's
    budgets and loss weights)."""
    from ..editing import StyleLossWeights
    from ..pipeline import PipelineConfig

    common = dict(train_steps_style=args.style_steps,
                  train_steps_distill=args.distill_steps,
                  distill_palette_steps=args.palette_steps,
                  num_palette_bases=8, depth_diff=0.5,
                  style_lg=args.style_lg)
    if args.mode == "style":
        return PipelineConfig(
            mode="style",
            style_image=wave_style_image(os.path.join(ws,
                                                      "style_image.png")),
            crop_size=256,
            weights=StyleLossWeights(
                offset_loss=5e-5, weight_loss_non_uniform=1e-7,
                palette_loss_valid=1.0, smooth_trans_weight=1e-3,
                tv_weight=1e-4, tv_depth_guide=True, depth_disc_weight=5e-4,
                style_weight=130.0, warmup_iterations=1000),
            **common)
    return PipelineConfig(
        mode="recolor",
        weights=StyleLossWeights(
            offset_loss=1e-4, weight_loss_uniform=1e-5,
            weight_loss_non_uniform=1e-5, palette_loss_valid=1e-4,
            palette_loss_distinct=1e-4, warmup_iterations=1000),
        **common)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data import NeRFDataset
    from ..editing import EditGrid
    from ..pipeline import EditPipeline
    from ..pipeline.cli import select_device
    from ..train import Trainer
    from .eval import mse_background

    device = select_device()
    ws = args.workspace
    scene_dir = os.path.join(ws, "scene")
    edit_ws = os.path.join(ws, f"{args.mode}_ws")

    model_cfg, render_cfg = make_configs(args)
    tr = Trainer(model_cfg, render_cfg, device=device, lr=1e-2, iters=30000,
                 eval_chunk=16384, workspace=os.path.join(ws, "ws"))
    if not tr.load_checkpoint("latest"):
        raise RuntimeError("no checkpoint: train with "
                           "laenerf_tpu_torch.scripts.quality_gate first")
    train_ds = NeRFDataset(scene_dir, "train", num_rays=4096)
    test_ds = NeRFDataset(scene_dir, "test")

    t_total = time.time()
    eg = EditGrid(cascades=render_cfg.cascades,
                  grid_size=render_cfg.grid_size)
    eg.new_from_points(shell_seeds(train_ds), bound=1.0)
    density = tr.occ_state.density_grid.cpu().numpy()
    thresh = min(float(tr.occ_state.mean_density), 0.01)
    eg.grow_region_queue(density, thresh,
                         grow_iterations=args.grow_iterations)
    print(f"# edit region: {int(eg.grid.sum())} voxels", flush=True)
    grow = EditGrid(render_cfg.cascades, render_cfg.grid_size)
    grow.grid_from_growing_queue(eg, density, thresh)

    cfg = pipeline_config(args, ws)
    pipe = EditPipeline(tr, train_ds, cfg, edit_ws, eg, grow)
    pipe.init_phase()
    print(f"# edit dataset: {len(pipe.edit_dataset)} views", flush=True)
    pipe.train_laenerf_phase(log_every=1000)
    if args.mode == "recolor":
        # recolor the blue sphere toward red
        pal = pipe.style_trainer.model.palette.detach().cpu().numpy()
        cfg.palette_mod = np.clip(pal * np.array([1.8, 0.4, 0.35]), 0, 1)
    pipe.distill_phase()
    pipe.finetune_phase()
    results = pipe.eval_phase(test_dataset=test_ds)
    wall = time.time() - t_total

    # bg-MSE outside the exported masks
    bg = mse_background.evaluate(
        results_dir=os.path.join(edit_ws, "render_test"),
        scene=os.path.basename(scene_dir),
        datatype=os.path.basename(os.path.dirname(scene_dir)),
        data_root=os.path.dirname(os.path.dirname(scene_dir)),
        masks_root=os.path.join(edit_ws, "masks", "test"),
        save_dir=os.path.join(edit_ws, "bg_mse"))

    timings = None
    if os.path.exists(os.path.join(edit_ws, "timings.json")):
        with open(os.path.join(edit_ws, "timings.json")) as f:
            timings = json.load(f)
    summary = {
        "wall_clock_s": round(wall, 1),
        "bg_mse": bg["mean"],
        "psnr_train_after": results.get("psnr_train"),
        "mode": args.mode,
        "style_steps": args.style_steps,
        "distill_steps": args.distill_steps,
        "timings": timings,
    }
    with open(os.path.join(edit_ws, f"{args.mode}_gate.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
