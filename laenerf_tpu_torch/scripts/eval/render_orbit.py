"""Render an orbit of frames from a trained workspace and run the
view-consistency metrics on them (counterpart of
scripts/eval/render_orbit.py, same flags and defaults): the artifact the
reference's scripts/eval/consistency_metrics.py protocol consumes
(README.md:131-140).

Usage:
  python -m laenerf_tpu_torch.scripts.eval.render_orbit --workspace ws \
      [--frames 30] [--H 400] [--step 1 --step 7] [--out_dir ws/frames]

Runs on the GPU (LAENERF_PLATFORM=cpu: on the CPU).
"""

import argparse
import json
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        "laenerf_tpu_torch.scripts.eval.render_orbit")
    p.add_argument("--workspace", required=True,
                   help="quality_gate-style workspace (scene/ + ws/)")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--H", type=int, default=400)
    p.add_argument("--arc", type=float, default=0.6,
                   help="orbit arc in radians across all frames (small ->"
                        " adjacent frames overlap, as a video does)")
    p.add_argument("--step", type=int, action="append", default=None,
                   help="consistency step(s); default [1, 7]")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--save_json", default=None)
    p.add_argument("--num_levels", type=int, default=8)
    p.add_argument("--level_dim", type=int, default=4)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--max_steps", type=int, default=512)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ...data import NeRFDataset
    from ...data.provider import _slerp
    from ...models import NeRFConfig, RenderConfig
    from ...pipeline.cli import select_device
    from ...train import Trainer
    from ...utils.images import to_u8, write_png
    from . import consistency_metrics

    device = select_device()
    model_cfg = NeRFConfig(bound=1.0, num_levels=args.num_levels,
                           level_dim=args.level_dim,
                           log2_hashmap_size=args.log2_hashmap_size)
    render_cfg = RenderConfig(bound=1.0, cascades=1, grid_size=128,
                              max_steps=args.max_steps, march_iters=384,
                              m_cap_per_ray=32, density_thresh=10.0,
                              infer_chunk_events=16, infer_compact_factor=4)
    tr = Trainer(model_cfg, render_cfg, device=device, lr=1e-2, iters=30000,
                 eval_chunk=16384,
                 workspace=os.path.join(args.workspace, "ws"))
    if not tr.load_checkpoint("latest"):
        raise RuntimeError("no checkpoint in workspace")

    H = W = args.H
    # camera path: slerp between consecutive TRAIN poses, so every frame is
    # in the dataset's (ngp-converted) camera convention and scale: the
    # protocol of the provider's video split
    train_ds = NeRFDataset(os.path.join(args.workspace, "scene"), "train")
    intr = train_ds.intrinsics * (H / train_ds.H)
    intr[2], intr[3] = W / 2, H / 2
    span = max(2, int(round(args.arc / (2 * np.pi) * len(train_ds))))
    anchors = [train_ds.poses[i % len(train_ds)] for i in range(span + 1)]

    out_dir = args.out_dir or os.path.join(args.workspace, "orbit_frames")
    os.makedirs(out_dir, exist_ok=True)
    for k in range(args.frames):
        x = (k / max(args.frames - 1, 1)) * span
        i, frac = int(min(x, span - 1e-6)), x - int(min(x, span - 1e-6))
        p0, p1 = np.asarray(anchors[i]), np.asarray(anchors[i + 1])
        pose = p0.copy()
        pose[:3, :3] = _slerp(p0[:3, :3], p1[:3, :3], frac)
        pose[:3, 3] = (1 - frac) * p0[:3, 3] + frac * p1[:3, 3]
        img, _ = tr.render_image(pose, intr, H, W)
        write_png(os.path.join(out_dir, f"f_{k:04d}.png"), to_u8(img))
        print(f"# frame {k + 1}/{args.frames}", flush=True)

    results = {"frames": args.frames, "H": H, "arc": args.arc}
    for step in (args.step or [1, 7]):
        results[f"step_{step}"] = consistency_metrics.evaluate(out_dir,
                                                               step=step)
    if args.save_json:
        with open(args.save_json, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
