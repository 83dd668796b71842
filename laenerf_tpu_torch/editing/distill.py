"""Training-set distillation: bake LAENeRF's re-paletted outputs into the
training images (counterpart of laenerf_tpu/editing/distill.py).

For every non-occluded view: re-evaluate LAENeRF at the cached termination
points, remap its palette weights with the user's per-base weights and
biases (clamped at 0, renormalized) and color them with the modified
palette; in the grow grid's transition shell interpolate toward the
original palette; blend over the original NeRF render by the edit weights
and write the result into the train image where the edit weight exceeds
blend_thresh. Also records each view's depths for the fine-tune's depth
supervision, optionally installs error maps from the edit weights (the
fine-tune then samples its rays by them), writes the palette images, and
returns (and writes as palette_eval.json) the weights' sparsity and TV
statistics.
"""

import json
import os

import numpy as np
import torch

from ..utils.images import to_u8, write_png
from ..utils.palette import palette_change_to_img, palette_to_img
from .laenerf import laenerf_forward_train


def _resize_128(img):
    """Nearest-neighbour downsample to 128x128 (error-map resolution)."""
    H, W = img.shape
    ys = (np.arange(128) * H // 128).clip(0, H - 1)
    xs = (np.arange(128) * W // 128).clip(0, W - 1)
    return img[ys][:, xs]


@torch.no_grad()
def distill_dataset(dataset, edit_dataset, model, active, palet_og,
                    palet_mod, palet_weights=None, palet_biases=None,
                    blend_thresh: float = 0.5, smooth_transition: bool = True,
                    no_bg: bool = False, use_error_maps: bool = False,
                    out_dir=None, save_train_dataset: bool = False):
    """Overwrite dataset.images with the distilled edit; returns the stats.

    Args:
      dataset: training NeRFDataset (images changed in place, depths set).
      edit_dataset: EditDataset with the cached per-view data.
      model, active: the trained LAENeRF and its [K] bool mask.
      palet_og / palet_mod: [K, 3] original / modified palettes.
      palet_weights / palet_biases: [K] per-base weight and bias of the
        user's remap; default 1 and 0.
      use_error_maps: set dataset.error_map to each view's edit weights,
        nearest-resized to 128x128, + 0.15, clipped to [0, 1] (1 for a
        view without edit rays).
    """
    dev = model.palette.device
    K = model.cfg.num_palette_bases
    pw_np = np.ones(K) if palet_weights is None else np.asarray(palet_weights)
    pb_np = np.zeros(K) if palet_biases is None else np.asarray(palet_biases)
    palette_changed = (not np.allclose(np.asarray(palet_og),
                                       np.asarray(palet_mod))
                       or not np.all(pw_np == 1) or not np.all(pb_np == 0))

    def dev_t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    p_og, p_mod, pw, pb = (dev_t(palet_og), dev_t(palet_mod), dev_t(pw_np),
                           dev_t(pb_np))
    H, W = dataset.H, dataset.W
    sp_losses, tv_losses = [], []
    dataset.depths = [np.zeros(H * W, np.float32) for _ in range(len(dataset))]
    if use_error_maps:
        dataset.error_map = np.ones((len(dataset), 128 * 128), np.float32)

    act = np.asarray(active.cpu() if isinstance(active, torch.Tensor)
                     else active)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        og, mod = np.asarray(palet_og)[act], np.asarray(palet_mod)[act]
        palette_to_img(og, out_dir, prefix="original")
        palette_to_img(mod, out_dir, prefix="modified")
        palette_change_to_img(og, mod, out_dir, prefix="mod")

    for v in edit_dataset.views:
        idx = int(v["view_index"])
        n = int(v["n_valid"])
        inds = v["inds"][:n]
        # the padded arrays, as the JAX package evaluates them
        _, weights_og, offsets = laenerf_forward_train(
            model, dev_t(v["x_term"]), dev_t(v["dirs"]), active)
        # the user's remap
        weights = torch.clamp(pb[None] + pw[None] * weights_og, min=0.0)
        weights = weights / torch.clamp(torch.sum(weights, -1, keepdim=True),
                                        min=1e-8)
        pred_colors = torch.clamp(offsets + weights @ p_mod, 0.0, 1.0)

        dist = dev_t(v["dist_factor"])
        if smooth_transition and palette_changed:
            # palette-space interpolation in the transition shell
            palet_interp = (dist[:, None, None] * p_og[None]
                            + (1 - dist[:, None, None]) * p_mod[None])
            weight_interp = (weights_og * dist[:, None]
                             + weights * (1 - dist[:, None]))
            interp_colors = torch.clamp(
                torch.einsum("bi,bik->bk", weight_interp, palet_interp)
                + offsets, 0.0, 1.0)
            pred_colors = torch.where((dist > 0)[:, None], interp_colors,
                                      pred_colors)

        pred_colors = pred_colors.cpu().numpy()[:n]
        w8s_edit = np.zeros(H * W, np.float32)
        w8s_edit[inds] = v["w8s"][:n]
        style_img = np.zeros((H * W, 3), np.float32)
        style_img[inds] = pred_colors
        pred_img = np.zeros((H * W, 3), np.float32)
        pred_img[inds] = v["pred_img"][:n]
        if no_bg:
            styled = w8s_edit[:, None] * style_img
        else:
            styled = ((1 - w8s_edit)[:, None] * pred_img
                      + w8s_edit[:, None] * style_img)

        train_img = dataset.images[idx][..., :3].reshape(-1, 3).copy()
        blend = w8s_edit > blend_thresh
        train_img[blend] = np.clip(styled[blend], 0, 1)
        dataset.images[idx][..., :3] = train_img.reshape(H, W, 3)

        # per-view depth for the fine-tune's depth supervision
        d_full = np.zeros(H * W, np.float32)
        d_full[inds] = v["depths"][:n]
        dataset.depths[idx] = d_full

        if use_error_maps:
            em = np.clip(_resize_128(w8s_edit.reshape(H, W)) + 0.15, 0, 1)
            dataset.error_map[idx] = em.reshape(-1)

        # palette sparsity and weight-TV statistics
        wnp = weights.cpu().numpy()[:n]
        sp_losses.append(float(np.mean(
            wnp.sum(-1) / np.maximum((wnp ** 2).sum(-1), 1e-8) - 1)))
        wimg = np.zeros((H * W, wnp.shape[-1]), np.float32)
        wimg[inds] = wnp
        wimg = wimg.reshape(H, W, -1)
        we = w8s_edit.reshape(H, W, 1)
        tv1 = np.sum(((wimg[1:] - wimg[:-1]) * we[1:] * we[:-1]) ** 2) / n
        tv2 = np.sum(((wimg[:, 1:] - wimg[:, :-1]) * we[:, 1:]
                      * we[:, :-1]) ** 2) / n
        tv_losses.append(float(tv1 + tv2))

        if out_dir and save_train_dataset:
            img = dataset.images[idx]
            if img.shape[-1] == 4:
                img = img[..., :3] * img[..., 3:] + (1 - img[..., 3:])
            write_png(os.path.join(out_dir, f"train_{idx:03d}.png"),
                      to_u8(img[..., :3]))
            write_png(os.path.join(out_dir, f"w8s_{idx:03d}.png"),
                      to_u8(w8s_edit.reshape(H, W)))

    stats = {
        "sparsity_loss": float(np.mean(sp_losses)) if sp_losses else 0.0,
        "tv_loss": float(np.mean(tv_losses)) if tv_losses else 0.0,
    }
    if out_dir:
        with open(os.path.join(out_dir, "palette_eval.json"), "w") as f:
            json.dump(stats, f, indent=2)
    return stats
