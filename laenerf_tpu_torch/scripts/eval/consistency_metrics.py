"""Short- and long-range view-consistency metrics (the port's own copy of
scripts/eval/consistency_metrics.py; LPIPS through the port's VGG-16).

The reference's scripts/eval/consistency_metrics.py warps rendered video
frame t to t+step with RAFT optical flow (run inside a RAFT checkout,
README.md:131-140) and reports occlusion-masked MSE and LPIPS. RAFT and its
weights are not in the repository, so the flow is pluggable:
  * --flow_dir: precomputed flow .npy files ([H, W, 2] per frame pair) from
    any external RAFT run: the exact reference protocol.
  * otherwise a numpy coarse-to-fine block-matching flow (weaker flow; a
    documented deviation).

Occlusion mask: forward-backward consistency < 1px, as in the protocol.
LPIPS needs local VGG-16 weights (editing/vgg.py); without them
lpips_mean is null.
"""

import argparse
import json
import os

import numpy as np
from PIL import Image


def _load(path):
    with Image.open(path) as im:
        img = np.asarray(im, np.float32)[..., :3] / 255.0
    return img


def block_flow(a, b, radius=8, patch=8, stride=4):
    """Coarse block-matching flow a->b (fallback; RAFT preferred).

    Vectorized: for each of the (2*radius/2+1)^2 candidate displacements,
    the per-block SSD over every grid block comes from one integral image
    of the shifted squared difference: O(#disp * H * W) in all instead of
    the quadruple loop over (block, displacement)."""
    H, W, _ = a.shape
    gy = np.arange(0, H - patch, stride)
    gx = np.arange(0, W - patch, stride)
    best_d = np.full((len(gy), len(gx)), np.inf, np.float32)
    flow = np.zeros((len(gy), len(gx), 2), np.float32)
    oy, ox = np.meshgrid(gy, gx, indexing="ij")
    for dy in range(-radius, radius + 1, 2):
        for dx in range(-radius, radius + 1, 2):
            # b shifted by (-dy, -dx) so diff[y, x] = a[y, x] - b[y+dy, x+dx]
            ys, xs = max(dy, 0), max(dx, 0)
            ye, xe = H + min(dy, 0), W + min(dx, 0)
            diff = np.zeros((H, W), np.float32)
            d2 = a[ys - dy:ye - dy, xs - dx:xe - dx] - b[ys:ye, xs:xe]
            diff[ys - dy:ye - dy, xs - dx:xe - dx] = np.einsum(
                "ijc,ijc->ij", d2, d2)
            ii = np.zeros((H + 1, W + 1), np.float64)
            np.cumsum(np.cumsum(diff, 0), 1, out=ii[1:, 1:])
            ssd = (ii[oy + patch, ox + patch] - ii[oy, ox + patch]
                   - ii[oy + patch, ox] + ii[oy, ox]).astype(np.float32)
            # blocks whose shifted window leaves the image are invalid
            ok = ((oy + dy >= 0) & (ox + dx >= 0)
                  & (oy + dy + patch <= H) & (ox + dx + patch <= W))
            ssd = np.where(ok, ssd, np.inf)
            upd = ssd < best_d
            best_d = np.where(upd, ssd, best_d)
            flow[..., 0] = np.where(upd, dx, flow[..., 0])
            flow[..., 1] = np.where(upd, dy, flow[..., 1])
    # upsample to full res
    fx = np.asarray(Image.fromarray(flow[..., 0]).resize((W, H),
                                                         Image.BILINEAR))
    fy = np.asarray(Image.fromarray(flow[..., 1]).resize((W, H),
                                                         Image.BILINEAR))
    return np.stack([fx, fy], -1)


def warp(img, flow):
    """Backward-warp img by flow (bilinear)."""
    H, W, _ = img.shape
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    x = np.clip(gx + flow[..., 0], 0, W - 1)
    y = np.clip(gy + flow[..., 1], 0, H - 1)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    return (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
            + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)


def _lpips():
    """dist(a, b) of two [H, W, 3] numpy images through the port's LPIPS on
    the script's device; raises without VGG-16 weights or a device."""
    import torch

    from ...editing.vgg import lpips_fn
    from ...pipeline.cli import select_device

    device = select_device()
    fn = lpips_fn(device=device)

    def dist(a, b):
        with torch.no_grad():
            return float(fn(torch.as_tensor(a, dtype=torch.float32,
                                            device=device),
                            torch.as_tensor(b, dtype=torch.float32,
                                            device=device)))
    return dist


def evaluate(frames_dir, step=1, flow_dir=None, save_json=None):
    files = sorted(f for f in os.listdir(frames_dir)
                   if f.lower().endswith((".png", ".jpg")))
    mses, lpipss = [], []
    lpips = None
    try:
        lpips = _lpips()
    except Exception:  # no VGG-16 weights (or device): lpips_mean is null
        pass

    for i in range(len(files) - step):
        a = _load(os.path.join(frames_dir, files[i]))
        b = _load(os.path.join(frames_dir, files[i + step]))
        if flow_dir:
            fwd = np.load(os.path.join(flow_dir, f"flow_{i:04d}_{step}.npy"))
            bwd_p = os.path.join(flow_dir, f"flowb_{i:04d}_{step}.npy")
            bwd = np.load(bwd_p) if os.path.exists(bwd_p) else None
        else:
            fwd = block_flow(a, b)
            bwd = block_flow(b, a)
        warped = warp(b, fwd)
        if bwd is not None:
            # forward-backward occlusion check
            fb = fwd + warp(bwd, fwd)
            occ = (np.linalg.norm(fb, axis=-1) < 1.0)[..., None]
        else:
            occ = np.ones(a.shape[:2] + (1,), bool)
        denom = max(occ.sum() * 3, 1)
        mses.append(float((np.square(warped - a) * occ).sum() / denom))
        if lpips is not None:
            lpipss.append(lpips(a * occ, warped * occ))

    result = {
        "step": step,
        "mse_mean": float(np.mean(mses)) if mses else None,
        "lpips_mean": float(np.mean(lpipss)) if lpipss else None,
        "n_pairs": len(mses),
    }
    if save_json:
        with open(save_json, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(
        "laenerf_tpu_torch.scripts.eval.consistency_metrics")
    p.add_argument("--frames_dir", type=str, required=True,
                   help="rendered video frames")
    p.add_argument("--step", type=int, default=1,
                   help="1 = short-range, 7 = long-range (README.md:131-140)")
    p.add_argument("--flow_dir", type=str, default=None,
                   help="precomputed RAFT flows (exact protocol)")
    p.add_argument("--save_json", type=str, default=None)
    a = p.parse_args(argv)
    evaluate(a.frames_dir, a.step, a.flow_dir, a.save_json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
