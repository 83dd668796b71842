"""Single-view reference (Ref-NPR style) stylization dataset (counterpart
of laenerf_tpu/editing/npr_dataset.py).

A user-stylized reference view is registered against every training view
through shared ray-termination points (the reference view rendered three
times: at the pixel centres and twice with a random sub-pixel offset).
Each training ray takes the reference colour of its nearest reference
point within min_dist, weighted by the registration distance and by the
direction agreement of the two rays. Per view it also precomputes the
NN-replaced VGG-16 features of the view's crop, the colour-patch target
and the style-guided TV maps.

Every view's rays are padded to one size (a multiple of 4096, pad index
H*W) and the crops to one crop size, as in EditDataset. The renders run
through Trainer.render_distill_frame with the density grid as both grids
(grow_grid); the registration and the NN matching run on the trainer's
device; the views are host numpy dicts.
"""

import json
import os

import numpy as np
import torch
from PIL import Image

from ..data.rays import pixel_rays
from .semantic import COLOR_LAYERS, FEAT_LAYERS, SemanticEncoder


def _round_up(x, m):
    return int(-(-x // m) * m)


def read_rgb(path):
    """An image file as float32 [H, W, 3] in [0, 1]; an alpha channel is
    multiplied in (a black background)."""
    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA"):
            im = im.convert("RGBA" if "A" in im.getbands() else "RGB")
        img = np.asarray(im, np.float32) / 255.0
    if img.shape[-1] == 4:
        img = img[..., :3] * img[..., 3:]
    return img


def nearest_points(x, ref, chunk=8192):
    """For each row of x [n, 3], the nearest row of ref [m, 3] (euclidean,
    computed without the matrix-product shortcut), in chunks of ref's rows.
    Returns (argmin [n] int64, min distance [n] float32) as numpy."""
    min_d = torch.full((x.shape[0],), torch.inf, device=x.device)
    argmin = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    for s in range(0, ref.shape[0], chunk):
        d = torch.cdist(x, ref[s:s + chunk],
                        compute_mode="donot_use_mm_for_euclid_dist")
        dm, am = torch.min(d, dim=1)
        upd = dm < min_d
        argmin = torch.where(upd, am + s, argmin)
        min_d = torch.where(upd, dm, min_d)
    return argmin.cpu().numpy(), min_d.cpu().numpy()


class SingleViewEditDataset:
    """Registration targets and NPR supervision of every training view.

    Args:
      trainer: the port's Trainer (its EMA NeRF renders the views).
      dataset: the training NeRFDataset (RGBA: the alpha channel masks).
      config_dir: holds data_config.json ({"tmpl_idx_train": i}, the
        reference view's index) and the stylized reference image (the
        first .png/.jpg/.jpeg by name).
      semantic_encoder: the VGG-16 SemanticEncoder.
      min_dist / max_dist: the registration radius / the style guide's
        distance ramp; min_tv_factor the guide's floor.
      feature_size: the side the crops are resized to for VGG features.
      seed: the numpy RandomState of the reference's jitter, get_batch's
        depth jitter and the shuffles (the JAX package's draws).
    """

    def __init__(self, trainer, dataset, config_dir: str,
                 semantic_encoder: SemanticEncoder, num_steps: int = 512,
                 min_dist: float = 1e-2, max_dist: float = 10e-2,
                 min_tv_factor: float = 0.1, feature_size: int = 256,
                 out_dir=None, eval_chunk: int = 16384, seed: int = 0):
        self.sem = semantic_encoder
        self.num_steps = num_steps
        self.min_dist = min_dist
        self.max_dist = max_dist
        self.min_tv_factor = min_tv_factor
        self.feature_size = feature_size
        self.rng = np.random.RandomState(seed)
        self.H, self.W = dataset.H, dataset.W
        self.eval_chunk = eval_chunk
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

        with open(os.path.join(config_dir, "data_config.json")) as f:
            self.config = json.load(f)
        ref_files = [f for f in sorted(os.listdir(config_dir))
                     if f.lower().endswith((".png", ".jpg", ".jpeg"))]
        ref = read_rgb(os.path.join(config_dir, ref_files[0]))
        self.ref_img = np.moveaxis(ref, -1, 0)  # [3, H, W]

        self.views = []
        self._build(trainer, dataset)

    # ------------------------------------------------------------------

    def _render_view(self, trainer, dataset, idx, occ, dir_offset=None):
        """Full-frame distill render marching the density grid itself."""
        pose, intr = dataset.poses[idx], dataset.intrinsics
        r = trainer.render_distill_frame(occ, pose, intr, self.H, self.W,
                                         grow_grid=True,
                                         chunk=self.eval_chunk,
                                         dir_offset=dir_offset)
        res = {k: r[k] for k in ("image", "x_term", "weights", "depth")}
        _, rays_d = pixel_rays(
            trainer._tensor(pose), trainer._tensor(intr), self.H, self.W,
            None if dir_offset is None else trainer._tensor(dir_offset))
        res["rays_d"] = rays_d.cpu().numpy()
        return res

    def _build(self, trainer, dataset):
        H, W = self.H, self.W
        dev = self.sem.device
        ref_idx = int(self.config["tmpl_idx_train"])
        occ = trainer.occ_state.occupancy.cpu().numpy()

        # reference registration points: the base pass and 2 jittered ones;
        # the 4th channel is alpha only on RGBA datasets
        if dataset.images.shape[-1] == 4:
            alpha = dataset.images[ref_idx, ..., -1].reshape(-1)
        else:
            alpha = np.ones(H * W, np.float32)
        ref_mask = np.nonzero(alpha > 0)[0]
        ref_x, ref_rgb, ref_dirs = [], [], []
        for k in range(3):
            off = (self.rng.rand(2).astype(np.float32) - 0.5
                   if k > 0 else None)
            r = self._render_view(trainer, dataset, ref_idx, occ,
                                  dir_offset=off)
            ref_x.append(r["x_term"][ref_mask])
            ref_rgb.append(self.ref_img.reshape(3, -1).T[ref_mask])
            ref_dirs.append(r["rays_d"][ref_mask])
        ref_x = np.concatenate(ref_x)
        ref_rgb = np.concatenate(ref_rgb)
        ref_dirs = np.concatenate(ref_dirs)
        ref_x_dev = torch.as_tensor(ref_x, device=dev)

        # the reference crop's style, content and colour features
        xs, ys = np.divmod(ref_mask, W)
        x0, x1 = xs.min(), xs.max() + 1
        y0, y1 = ys.min(), ys.max() + 1
        ref_full = np.zeros((H * W, 3), np.float32)
        ref_full[ref_mask] = self.ref_img.reshape(3, -1).T[ref_mask]
        ref_chw = np.moveaxis(ref_full.reshape(H, W, 3), -1, 0)
        self.style_img = ref_chw[:, x0:x1, y0:y1]
        fs = (self.feature_size, self.feature_size)
        with torch.no_grad():
            self.style_feat = self.sem.encode_feats(self.style_img,
                                                    FEAT_LAYERS, fs)
            content_im = np.moveaxis(dataset.images[ref_idx][..., :3], -1, 0)
            self.content_feat = self.sem.encode_feats(
                content_im[:, x0:x1, y0:y1], FEAT_LAYERS, fs)
            self.color_feat_ref = self.sem.encode_feats(
                content_im, COLOR_LAYERS, size=None)
            self.patch_color = self.sem.get_mean_patch_color(
                torch.as_tensor(ref_chw, device=dev),
                size=self.color_feat_ref.shape[-2:])

        raw = []
        for i in range(len(dataset)):
            r = self._render_view(trainer, dataset, i, occ)
            alpha_i = dataset.images[i, ..., -1].reshape(-1)
            mask = np.nonzero(alpha_i > 0)[0]
            if mask.size == 0:
                continue
            x_term = r["x_term"][mask]

            # registration: the nearest reference point within min_dist
            argmin, min_d = nearest_points(
                torch.as_tensor(x_term, device=dev), ref_x_dev)
            reg = min_d < self.min_dist
            target = np.zeros((mask.shape[0], 3), np.float32)
            target[reg] = ref_rgb[argmin[reg]]
            tw = np.zeros(mask.shape[0], np.float32)
            if reg.any():
                td = min_d[reg]
                rng_d = max(td.max() - td.min(), 1e-8)
                w = 1.0 - (td - td.min()) / rng_d
                # direction agreement: cos clamped to [-1, -0.5] (the
                # reference's arithmetic, which zeroes same-direction
                # pairs)
                dirs_i = r["rays_d"][mask][reg]
                tdirs = ref_dirs[argmin[reg]]
                cos = np.sum(dirs_i * tdirs, -1) / (
                    np.linalg.norm(dirs_i, axis=-1)
                    * np.linalg.norm(tdirs, axis=-1) + 1e-8)
                factor = (np.clip(cos, -1, -0.5) + 1) / 0.5
                tw[reg] = np.clip(w * factor, 0, None)

            # the style guide from the registration distance
            ms = np.clip(min_d, self.min_dist, self.max_dist)
            ms = (ms - self.min_dist) / (self.max_dist - self.min_dist)
            style_guide_ray = np.maximum(ms, self.min_tv_factor)

            w8s = r["weights"][mask]
            target_gt = dataset.images[i][..., :3].reshape(-1, 3)[mask]
            if dataset.images.shape[-1] == 4:
                target_gt = (dataset.images[i][..., :3]
                             * dataset.images[i][..., 3:]).reshape(
                                 -1, 3)[mask]

            xs, ys = np.divmod(mask, W)
            bbox = (int(xs.min()), int(xs.max()) + 1,
                    int(ys.min()), int(ys.max()) + 1)
            depths = r["depth"][mask]
            raw.append({
                "view_index": i,
                "mask_inds": mask.astype(np.int32),
                "w8s": w8s, "targets": target, "targets_gt": target_gt,
                "target_weights": tw, "x_term": x_term,
                "dirs": r["rays_d"][mask], "depths": depths,
                "pred_img": r["image"][mask],
                "style_guide_ray": style_guide_ray.astype(np.float32),
                "bbox": bbox,
                "depth_factor": float((depths.max() - depths.min())
                                      / self.num_steps),
            })

        self.n_pad = _round_up(max(v["mask_inds"].shape[0] for v in raw),
                               4096)
        self.crop_h = min(_round_up(max(v["bbox"][1] - v["bbox"][0]
                                        for v in raw), 8), H)
        self.crop_w = min(_round_up(max(v["bbox"][3] - v["bbox"][2]
                                        for v in raw), 8), W)
        for v in raw:
            self.views.append(self._pad_view(v, dataset))

    @torch.no_grad()
    def _pad_view(self, v, dataset):
        H, W = self.H, self.W
        n = v["mask_inds"].shape[0]
        P = self.n_pad

        def pad1(a, fill=0):
            out = np.full((P,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            return out

        x0, x1, y0, y1 = v["bbox"]
        cx = min(max(0, (x0 + x1 - self.crop_h) // 2), H - self.crop_h)
        cy = min(max(0, (y0 + y1 - self.crop_w) // 2), W - self.crop_w)

        def cut(vals, channels=None):
            shape = (H * W,) + (() if channels is None else (channels,))
            m = np.zeros(shape, np.float32)
            m[v["mask_inds"]] = vals
            m = m.reshape((H, W) + (() if channels is None else (channels,)))
            return m[cx:cx + self.crop_h, cy:cy + self.crop_w]

        cut_gt = cut(v["targets_gt"], 3)
        cut_depth = cut(v["depths"])
        w_map = cut(v["w8s"])
        style_guide = cut(v["style_guide_ray"])

        w = w_map.copy()
        w[w < 0.98] = 0
        w_h = w[:-1, :] * w[1:, :]
        w_h[1:] *= w[:-2, :] * w[2:, :]
        w_v = w[:, :-1] * w[:, 1:]
        w_v[:, 1:] *= w[:, :-2] * w[:, 2:]
        rgb_h = np.abs(cut_gt[:-1] - cut_gt[1:]).sum(-1)
        rgb_v = np.abs(cut_gt[:, :-1] - cut_gt[:, 1:]).sum(-1)
        tv_h = np.abs(cut_depth[:-1] - cut_depth[1:]) * w_h * rgb_h
        tv_v = np.abs(cut_depth[:, :-1] - cut_depth[:, 1:]) * w_v * rgb_v

        # the view's NN-replaced supervision features
        fs = (self.feature_size, self.feature_size)
        sup = self.sem.encode_feats(np.moveaxis(cut_gt, -1, 0), FEAT_LAYERS,
                                    fs)
        sup_nn = self.sem.nn_feat_replace(sup, self.content_feat,
                                          self.style_feat)
        # the colour-patch target: this view's deep features matched against
        # the reference view's, taking the reference colours
        full_img = np.moveaxis(dataset.images[v["view_index"]][..., :3], -1,
                               0)
        col = self.sem.encode_feats(full_img, COLOR_LAYERS, size=None)
        col_nn = self.sem.nn_feat_replace_color(col, self.color_feat_ref,
                                                self.patch_color)

        return {
            "view_index": v["view_index"],
            "n_valid": n,
            "inds": pad1(v["mask_inds"], fill=H * W),
            "valid": np.arange(P) < n,
            "w8s": pad1(v["w8s"]),
            "targets": pad1(v["targets"]),
            "targets_gt": pad1(v["targets_gt"]),
            "target_weights": pad1(v["target_weights"]),
            "x_term": pad1(v["x_term"]),
            "dirs": pad1(v["dirs"]),
            "depths": pad1(v["depths"]),
            "pred_img": pad1(v["pred_img"]),
            "crop_origin": np.array([cx, cy], np.int32),
            "cut_gt": cut_gt,
            "style_guide": style_guide.astype(np.float32),
            "tv_h": tv_h.astype(np.float32),
            "tv_v": tv_v.astype(np.float32),
            "sup_feat": sup_nn.cpu().numpy().astype(np.float32),
            "col_patch": col_nn.cpu().numpy().astype(np.float32),
            "depth_factor": v["depth_factor"],
        }

    # ------------------------------------------------------------------

    def __len__(self):
        return len(self.views)

    def get_batch(self, i, jitter=True):
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
