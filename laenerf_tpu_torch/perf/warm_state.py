"""Train chip_smoke.py's training cell from scratch and print the
occupancy grid's state on the way, with the hash-grid backward through K1
or through its plain version (index_add_).

    python -m laenerf_tpu_torch.perf.warm_state [--steps 1536]
        [--backward k1|plain] [--every 256]

The cell: the 16-view 100x100 procedural scene, NeRFConfig L8 C4 lg19,
RenderConfig grid 128 (bench.py's), 4096-ray batches. Every `--every`
steps it prints occ_frac, the grid's mean density and the mean loss of
the last 64 steps; at the end the train-view PSNR of view 0 at 100x100.
On the card by default (`--device cpu` runs the same on the host, slowly).
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from ..data import NeRFDataset, generate_synthetic_scene
from ..models import NeRFConfig, RenderConfig
from ..ops import hashgrid
from ..ops.scatter_add import scatter_add_rows_plain
from ..train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1536)
    ap.add_argument("--every", type=int, default=256)
    ap.add_argument("--backward", choices=("k1", "plain"), default="k1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.backward == "plain":
        hashgrid.scatter_add_rows = scatter_add_rows_plain
    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_scene(tmp, n_train=16, n_val=1, n_test=4, H=100,
                                 W=100, device=dev)
        ds = NeRFDataset(tmp, "train", num_rays=4096)
        tr = Trainer(
            NeRFConfig(bound=1.0, num_levels=8, level_dim=4,
                       log2_hashmap_size=19),
            RenderConfig(bound=1.0, cascades=1, grid_size=128, max_steps=256,
                         march_iters=256, m_cap_per_ray=16,
                         density_thresh=10.0, infer_chunk_events=16,
                         infer_compact_factor=4),
            device=dev, lr=1e-2, iters=2000, eval_chunk=16384)
        tr.mark_untrained(ds)
        t0, losses = time.perf_counter(), []
        for step in range(args.steps):
            aux = tr.train_one_batch(ds.get_batch(step % len(ds)),
                                     has_alpha=True)
            losses.append(aux["loss"])
            if (step + 1) % args.every == 0:
                occ = tr.occ_state
                print(f"{args.backward} step {step + 1}: occ_frac "
                      f"{float(occ.occupancy.float().mean()):.4f}, mean "
                      f"density {float(occ.mean_density):.4f}, loss "
                      f"{float(torch.stack(losses[-64:]).mean()):.5f}, "
                      f"{time.perf_counter() - t0:.0f} s", flush=True)
        img, _ = tr.render_image(ds.poses[0], ds.intrinsics, ds.H, ds.W)
        gt = ds.images[0]
        gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
        psnr = -10 * np.log10(max(float(np.mean((img - gt) ** 2)), 1e-10))
        print(f"{args.backward} train-view PSNR {psnr:.2f} dB", flush=True)


if __name__ == "__main__":
    main()
