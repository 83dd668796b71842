"""Distillation dataset extraction (counterpart of
laenerf_tpu/editing/edit_dataset.py).

Renders every training view through the dual-grid distill path and keeps
the rays whose edit weights are valid: the floater filter (|w_density -
w_edit| > depth_diff -> 0), the depth filter (depth < min_near -> 0), and
the survivors take the full density weight. Views with no such ray are
recorded as occluded. Each ray's smooth-transition distance factor comes
from the nearest termination point of the grow grid's render. Per view it
precomputes the crop-loss inputs: the GT cutout, the weight-gated depth-TV
edge maps |dDepth| * w * |dRGB| (w < 0.98 gated out) and the
smooth-transition cutout.

Every view's rays are padded to one size (a multiple of 4096) and the
crops to one crop size, with a validity mask the losses read. Views are
host numpy dicts; LAENeRFTrainer moves them to the device once.
"""

import os
from typing import Optional

import numpy as np
import torch

from ..utils.images import to_u8, write_png


def _round_up(x, m):
    return int(-(-x // m) * m)


class EditDataset:
    """Extracts and serves per-view distillation data.

    Args:
      trainer: the port's Trainer (its NeRF is frozen here).
      dataset: training NeRFDataset.
      edit_grid, grow_grid: uint8 [CAS, H, H, H] arrays (grow_grid optional).
      depth_diff: floater filter threshold.
      max_dist: smooth-transition distance clamp.
      num_steps: depth jitter divisor.
      out_dir: where to write the weight and depth PNGs of each view.
      eval_chunk: rays per distill-render chunk.
      seed: the numpy RandomState of get_batch's jitter and the shuffles.
    """

    def __init__(self, trainer, dataset, edit_grid, grow_grid=None,
                 depth_diff: float = 0.65, max_dist: float = 0.12,
                 num_steps: int = 512, smooth_transition: bool = True,
                 out_dir: Optional[str] = None, eval_chunk: int = 65536,
                 seed: int = 0):
        self.depth_diff = depth_diff
        self.max_dist = max_dist
        self.num_steps = num_steps
        self.rng = np.random.RandomState(seed)
        self.H, self.W = dataset.H, dataset.W
        self.views = []
        self.occluded = []
        smooth_transition = smooth_transition and grow_grid is not None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

        raw = []
        for i in range(len(dataset)):
            view = self._extract_view(trainer, dataset, i, edit_grid,
                                      grow_grid, smooth_transition,
                                      eval_chunk)
            if view is None:
                self.occluded.append(i)
                continue
            raw.append((i, view))
            if out_dir:
                self._write_maps(out_dir, i, view)
        if not raw:
            raise RuntimeError("edit region is occluded in every view")

        # one padded size and one crop size for every view
        self.n_pad = _round_up(max(v["mask_inds"].shape[0] for _, v in raw),
                               4096)
        self.crop_h = min(_round_up(
            max(v["bbox"][1] - v["bbox"][0] for _, v in raw), 8), self.H)
        self.crop_w = min(_round_up(
            max(v["bbox"][3] - v["bbox"][2] for _, v in raw), 8), self.W)
        for i, v in raw:
            self.views.append(self._pad_view(i, v))

    def _write_maps(self, out_dir, i, view):
        w_img = np.zeros(self.H * self.W, np.float32)
        w_img[view["mask_inds"]] = view["w8s"]
        write_png(os.path.join(out_dir, f"weights_{i:03d}.png"),
                  to_u8(w_img.reshape(self.H, self.W)))
        d_img = np.zeros(self.H * self.W, np.float32)
        d = view["depths"]
        if d.max() > d.min():
            d_img[view["mask_inds"]] = (d - d.min()) / (d.max() - d.min())
        write_png(os.path.join(out_dir, f"depth_{i:03d}.png"),
                  to_u8(d_img.reshape(self.H, self.W)))

    # ------------------------------------------------------------------

    def _extract_view(self, trainer, dataset, idx, edit_grid, grow_grid,
                      smooth_transition, chunk):
        H, W = self.H, self.W

        def run(grid, grow):
            return trainer.render_distill_frame(
                grid, dataset.poses[idx], dataset.intrinsics, H, W,
                grow_grid=grow, chunk=chunk)

        r = run(edit_grid, grow=False)
        w8s = r["weights_edit"].copy()
        # floater filter, depth validity, full-weight replacement
        w8s[np.abs(r["weights"] - w8s) > self.depth_diff] = 0
        w8s[r["depth"] < r["min_near"]] = 0
        w8s[w8s > 0] = r["weights"][w8s > 0]

        mask = np.nonzero(w8s)[0]
        if mask.size == 0:
            return None

        target = dataset.images[idx]
        if target.shape[-1] == 4:
            target = target[..., :3] * target[..., 3:]
        target = target.reshape(-1, 3)
        dirs = _pixel_dirs(trainer, dataset, idx, H, W)

        view = {
            "mask_inds": mask.astype(np.int32),
            "w8s": w8s[mask],
            "targets": target[mask],
            "x_term": r["x_term"][mask],
            "dirs": dirs[mask],
            "depths": r["depth"][mask],
            "pred_img": r["image"][mask],
            "w_density": r["weights"][mask],
            "w_edit": r["weights_edit"][mask],
            "full_w8s": w8s,
        }

        # smooth transition: distance to the grow grid's termination points
        if smooth_transition:
            g = run(grow_grid, grow=True)
            x_grow = g["x_term"][g["weights_edit"] > 0.99]
            if x_grow.shape[0] > 0:
                min_d = _min_dist(view["x_term"], x_grow, trainer.device)
                min_d = np.minimum(min_d, self.max_dist)
                dist_factor = 1.0 - min_d / max(min_d.max(), 1e-8)
            else:
                dist_factor = np.zeros(mask.shape[0], np.float32)
            view["dist_factor"] = dist_factor.astype(np.float32)
        else:
            view["dist_factor"] = np.zeros(mask.shape[0], np.float32)

        xs, ys = np.divmod(mask, W)
        view["bbox"] = (int(xs.min()), int(xs.max()) + 1,
                        int(ys.min()), int(ys.max()) + 1)
        view["depth_factor"] = float(
            (view["depths"].max() - view["depths"].min()) / self.num_steps)
        return view

    def _pad_view(self, idx, v):
        H, W = self.H, self.W
        n = v["mask_inds"].shape[0]
        P = self.n_pad

        def pad1(a, fill=0):
            out = np.full((P,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            return out

        x0, x1, y0, y1 = v["bbox"]
        # clamp a fixed-size crop window inside the image, covering the bbox
        cx = min(max(0, (x0 + x1 - self.crop_h) // 2), H - self.crop_h)
        cy = min(max(0, (y0 + y1 - self.crop_w) // 2), W - self.crop_w)

        full = np.zeros((H * W,), np.float32)
        full[v["mask_inds"]] = v["w8s"]
        w_map = full.reshape(H, W)[cx:cx + self.crop_h, cy:cy + self.crop_w]

        gt_map = np.zeros((H * W, 3), np.float32)
        gt_map[v["mask_inds"]] = v["targets"]
        cut_gt = gt_map.reshape(H, W, 3)[cx:cx + self.crop_h,
                                         cy:cy + self.crop_w]

        d_map = np.zeros((H * W,), np.float32)
        d_map[v["mask_inds"]] = v["depths"]
        cut_depth = d_map.reshape(H, W)[cx:cx + self.crop_h,
                                        cy:cy + self.crop_w]

        s_map = np.zeros((H * W,), np.float32)
        s_map[v["mask_inds"]] = v["dist_factor"]
        cut_smooth = s_map.reshape(H, W)[cx:cx + self.crop_h,
                                         cy:cy + self.crop_w]

        # weight-gated depth-TV edge maps (edit_dataset.py:204-225)
        w = w_map.copy()
        w[w < 0.98] = 0
        w_h = w[:-1, :] * w[1:, :]
        w_h[1:] = w_h[1:] * (w[:-2, :] * w[2:, :])
        w_v = w[:, :-1] * w[:, 1:]
        w_v[:, 1:] = w_v[:, 1:] * (w[:, :-2] * w[:, 2:])
        rgb_h = np.abs(cut_gt[:-1] - cut_gt[1:]).sum(-1)
        rgb_v = np.abs(cut_gt[:, :-1] - cut_gt[:, 1:]).sum(-1)
        tv_h = np.abs(cut_depth[:-1] - cut_depth[1:]) * w_h * rgb_h
        tv_v = np.abs(cut_depth[:, :-1] - cut_depth[:, 1:]) * w_v * rgb_v

        return {
            "view_index": idx,
            "n_valid": n,
            "inds": pad1(v["mask_inds"], fill=H * W),  # dumpster for padding
            "valid": np.arange(P) < n,
            "w8s": pad1(v["w8s"]),
            "targets": pad1(v["targets"]),
            "x_term": pad1(v["x_term"]),
            "dirs": pad1(v["dirs"]),
            "depths": pad1(v["depths"]),
            "dist_factor": pad1(v["dist_factor"]),
            "w_density": pad1(v["w_density"]),
            "w_edit": pad1(v["w_edit"]),
            "pred_img": pad1(v["pred_img"]),
            "crop_origin": np.array([cx, cy], np.int32),
            "cut_gt": cut_gt,
            "cut_smooth": cut_smooth.astype(np.float32),
            "tv_h": tv_h.astype(np.float32),
            "tv_v": tv_v.astype(np.float32),
            "depth_factor": v["depth_factor"],
        }

    # ------------------------------------------------------------------

    def __len__(self):
        return len(self.views)

    def get_batch(self, i: int, jitter: bool = True):
        """One view's padded batch; x_term re-jittered along the ray
        (edit_dataset.py:289-312)."""
        v = self.views[i]
        batch = dict(v)
        if jitter:
            d = (self.rng.rand(self.n_pad).astype(np.float32) - 0.5) \
                * v["depth_factor"]
            batch["x_term"] = v["x_term"] + d[:, None] * v["dirs"]
        return batch

    def epoch_indices(self, shuffle=True):
        idx = np.arange(len(self.views))
        if shuffle:
            self.rng.shuffle(idx)
        return idx

    # ------------------------------------------------------------------

    def save(self, path):
        """Cache like edataset.pth (edit_dataset.py:236-262), npz format."""
        flat = {}
        for k in self.views[0]:
            if k in ("view_index", "n_valid", "depth_factor"):
                flat[k] = np.array([v[k] for v in self.views])
            else:
                flat[k] = np.stack([v[k] for v in self.views])
        np.savez_compressed(
            path, occluded=np.array(self.occluded, np.int32),
            H=self.H, W=self.W, n_pad=self.n_pad, crop_h=self.crop_h,
            crop_w=self.crop_w, depth_diff=self.depth_diff,
            max_dist=self.max_dist, num_steps=self.num_steps, **flat,
        )

    @classmethod
    def load(cls, path):
        data = np.load(path)
        self = cls.__new__(cls)
        self.rng = np.random.RandomState(0)
        self.H, self.W = int(data["H"]), int(data["W"])
        self.n_pad = int(data["n_pad"])
        self.crop_h, self.crop_w = int(data["crop_h"]), int(data["crop_w"])
        self.depth_diff = float(data["depth_diff"])
        self.max_dist = float(data["max_dist"])
        self.num_steps = int(data["num_steps"])
        self.occluded = data["occluded"].tolist()
        n_views = data["inds"].shape[0]
        keys = [k for k in data.files
                if k not in ("occluded", "H", "W", "n_pad", "crop_h",
                             "crop_w", "depth_diff", "max_dist", "num_steps")]
        # decompress each array exactly once: indexing the NpzFile inside
        # the view loop re-decompresses the full stacked array per access
        # (measured: minutes instead of seconds for an 800x800 dataset)
        stacked = {k: data[k] for k in keys}
        self.views = []
        for i in range(n_views):
            v = {}
            for k in keys:
                arr = stacked[k][i]
                v[k] = arr.item() if arr.ndim == 0 else arr
            self.views.append(v)
        return self


def _pixel_dirs(trainer, dataset, idx, H, W):
    from ..data.rays import pixel_rays

    _, rays_d = pixel_rays(trainer._tensor(dataset.poses[idx]),
                           trainer._tensor(dataset.intrinsics), H, W)
    return rays_d.cpu().numpy()


@torch.no_grad()
def _min_dist(pts, others, device, block: int = 4096):
    """Distance from each of pts [n, 3] to its nearest point of others
    [m, 3], in blocks of `block` others, on `device`."""
    p = torch.as_tensor(pts, device=device)
    out = torch.full((p.shape[0],), torch.inf, device=device)
    for s in range(0, others.shape[0], block):
        o = torch.as_tensor(others[s:s + block], device=device)
        d = torch.linalg.norm(p[:, None, :] - o[None], dim=-1)
        out = torch.minimum(out, d.amin(dim=1))
    return out.cpu().numpy()
