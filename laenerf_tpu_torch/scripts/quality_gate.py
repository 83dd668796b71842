"""Quality gate: train the reference budget on the lego-class scene
(counterpart of scripts/quality_gate.py, same flags and defaults).

The reference's contract is 30k-iteration training on nerf_synthetic at
800x800 (scripts/configs_nerf_synthetic/lego.sh) to instant-ngp-class
PSNR. No dataset ships with the repository, so the gate renders the
procedural lego-class scene (data/synthetic.py::lego_class_scene: thin
shells, lattices, high-frequency textures), trains, and records the test
split's PSNR, SSIM and LPIPS (null without VGG-16 weights).

Usage:
  python -m laenerf_tpu_torch.scripts.quality_gate [--iters 30000] \
      [--workspace /tmp/qgate]
  python -m laenerf_tpu_torch.scripts.quality_gate --resume

Writes <workspace>/quality_gate.json. Runs on the GPU
(LAENERF_PLATFORM=cpu: on the CPU).
"""

import argparse
import json
import os
import subprocess
import time

import torch


def device_label(device) -> str:
    """The card's `name, power.limit` as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", f"--id={torch.cuda.current_device()}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def build_parser():
    p = argparse.ArgumentParser("laenerf_tpu_torch.scripts.quality_gate")
    p.add_argument("--workspace", default="/tmp/qgate")
    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--n_train", type=int, default=64)
    p.add_argument("--H", type=int, default=800)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--aa", type=int, default=2,
                   help="GT supersampling factor (aa^2 rays/pixel). "
                        "Default 2: the renderer integrates one ray per "
                        "pixel, so aliased (aa=1) GT puts a ~0.5 dB floor "
                        "of silhouette noise into the metric")
    p.add_argument("--min_psnr", type=float, default=0.0,
                   help="fail (exit 1) if test PSNR lands below this")
    p.add_argument("--render_aa", type=int, default=1,
                   help="supersample eval renders by this factor and "
                        "box-downsample (removes the silhouette-aliasing "
                        "term from the metric at aa^2 x render cost). "
                        "1 = reference protocol.")
    # model and march knobs
    p.add_argument("--num_levels", type=int, default=8)
    p.add_argument("--level_dim", type=int, default=4)
    p.add_argument("--lg", type=int, default=19, help="log2_hashmap_size")
    p.add_argument("--max_steps", type=int, default=512,
                   help="march dt = 2*sqrt(3)/this (reference: 1024)")
    return p


def march_budget(max_steps: int):
    """(march_iters, m_cap_per_ray) for max_steps: the march budget scales
    with the dt resolution, capped at 512/40 past 512 steps (the JAX gate's
    memory-bound choice, kept so both gates train the same model)."""
    if max_steps <= 512:
        return max(256, 384 * max_steps // 512), 32
    return 512, 40


def make_configs(args):
    from ..models import NeRFConfig, RenderConfig

    # NeRFConfig derives per_level_scale from a fixed finest resolution of
    # 2048, so num_levels alone sets the ladder's shape
    model_cfg = NeRFConfig(bound=1.0, num_levels=args.num_levels,
                           level_dim=args.level_dim,
                           log2_hashmap_size=args.lg)
    mi, mc = march_budget(args.max_steps)
    render_cfg = RenderConfig(bound=1.0, cascades=1, grid_size=128,
                              max_steps=args.max_steps, march_iters=mi,
                              m_cap_per_ray=mc, density_thresh=10.0,
                              infer_chunk_events=16, infer_compact_factor=4)
    return model_cfg, render_cfg


def evaluate_test(tr, test_ds, render_aa: int, device):
    """Test-split PSNR, SSIM and LPIPS meters over every view (white
    background), and the seconds per frame."""
    from ..train.metrics import LPIPSMeter, psnr_meter, ssim_meter

    pm, sm, lm = psnr_meter(), ssim_meter(), LPIPSMeter(device=device)
    t0 = time.time()
    for i in range(len(test_ds)):
        if render_aa > 1:
            a = render_aa
            intr_aa = test_ds.intrinsics * a
            intr_aa[2], intr_aa[3] = test_ds.W * a / 2, test_ds.H * a / 2
            img, _ = tr.render_image(test_ds.poses[i], intr_aa,
                                     test_ds.H * a, test_ds.W * a)
            img = img.reshape(test_ds.H, a, test_ds.W, a, 3).mean(
                axis=(1, 3))
        else:
            img, _ = tr.render_image(test_ds.poses[i], test_ds.intrinsics,
                                     test_ds.H, test_ds.W)
        gt = test_ds.images[i]
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1 - gt[..., 3:])
        pm.update(img, gt)
        sm.update(img, gt)
        lm.update(img, gt)
        print(f"# test view {i}: PSNR so far {pm.measure():.2f}", flush=True)
    return pm, sm, lm, (time.time() - t0) / len(test_ds)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data import NeRFDataset, generate_synthetic_scene
    from ..data.synthetic import lego_class_scene
    from ..pipeline.cli import select_device
    from ..train import Trainer

    device = select_device()
    ws = args.workspace
    scene_dir = os.path.join(ws, "scene")
    os.makedirs(ws, exist_ok=True)
    if not os.path.exists(os.path.join(scene_dir, "transforms_train.json")):
        print(f"# generating lego-class scene at {args.H}^2 "
              f"({args.n_train} train views)...", flush=True)
        t0 = time.time()
        generate_synthetic_scene(scene_dir, n_train=args.n_train, n_val=4,
                                 n_test=8, H=args.H, W=args.H,
                                 spheres=lego_class_scene(), aa=args.aa,
                                 device=device)
        print(f"# scene generated in {time.time() - t0:.0f}s", flush=True)

    train_ds = NeRFDataset(scene_dir, "train", num_rays=4096)
    test_ds = NeRFDataset(scene_dir, "test")

    # reference budget: 30k iters, 4096 rays, lr 1e-2
    # (configs_nerf_synthetic/lego.sh)
    model_cfg, render_cfg = make_configs(args)
    tr = Trainer(model_cfg, render_cfg, device=device, lr=1e-2,
                 iters=args.iters, eval_chunk=16384,
                 workspace=os.path.join(ws, "ws"))
    start = 0
    if args.resume or args.eval_only:
        if tr.load_checkpoint("latest"):
            start = tr.global_step

    if not args.eval_only:
        if start == 0:
            tr.mark_untrained(train_ds)
        t0 = time.time()
        last = t0
        for step in range(start, args.iters):
            aux = tr.train_one_batch(
                train_ds.get_batch(step % len(train_ds)), has_alpha=True)
            if (step + 1) % 1000 == 0:
                if device.type == "cuda":
                    torch.cuda.synchronize()
                now = time.time()
                occ = float(tr.occ_state.occupancy.float().mean())
                spr = float(aux["n_samples"].float().mean())
                print(f"# step {step + 1}/{args.iters} "
                      f"{1000 / (now - last):.1f} it/s occ {occ:.3f} "
                      f"samples/ray {spr:.1f} (cap "
                      f"{render_cfg.m_cap_per_ray})", flush=True)
                last = now
                # a checkpoint every 2000 steps bounds the work a lost
                # machine costs (--resume continues from it)
                if (step + 1) % 2000 == 0:
                    tr.save_checkpoint()
        if device.type == "cuda":
            torch.cuda.synchronize()
        train_time = time.time() - t0
        tr.save_checkpoint()
        print(f"# trained {args.iters - start} iters in {train_time:.0f}s",
              flush=True)

    pm, sm, lm, render_time = evaluate_test(tr, test_ds, args.render_aa,
                                            device)
    result = {
        "scene": f"procedural lego-class {args.H}x{args.H}",
        "iters": args.iters,
        "test_psnr": round(pm.measure(), 2),
        "test_ssim": round(sm.measure(), 4),
        "test_lpips": round(lm.measure(), 4) if lm.available else None,
        "render_s_per_frame": round(render_time, 2),
        "n_train_views": args.n_train,
        "render_aa": args.render_aa,
        "model": {"num_levels": args.num_levels,
                  "level_dim": args.level_dim, "lg": args.lg,
                  "max_steps": args.max_steps},
        "device": device_label(device),
    }
    if result["test_ssim"] > 1.0:
        raise RuntimeError(f"SSIM {result['test_ssim']} > 1: a broken meter")
    with open(os.path.join(ws, "quality_gate.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    if args.min_psnr and result["test_psnr"] < args.min_psnr:
        print(f"# FAIL: test PSNR {result['test_psnr']} < {args.min_psnr}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
