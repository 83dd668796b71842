"""Reference-based NPR stylization training (counterpart of
laenerf_tpu/editing/npr_trainer.py).

  * npr_train_step: one LAENeRF step on an NPR view, its loss the
    distance-weighted MSE to the registration targets, the NNFM cosine loss
    of the crop's VGG-16 features against the NN-replaced style features,
    the colour-patch MSE of the full frame, and the style-guided TV and
    depth-discontinuity losses, beside LAENeRF's regularizers.
  * NPRTrainer drives it over a SingleViewEditDataset.
  * build_npr_nerf_dataset bakes the registration colours and LAENeRF's
    predictions into per-view supervision images for the NeRF fine-tune
    (Trainer.train_one_batch_npr).
"""

import os

import numpy as np
import torch

from ..utils.images import resize_bilinear, to_u8, write_png
from .laenerf import (LAENeRFConfig, LAENeRFLosses, laenerf_forward_train,
                      laenerf_init)
from .semantic import FEAT_LAYERS, SemanticEncoder
from .style_trainer import StyleLossWeights, make_style_optimizer, scatter_crop
from .vgg import normalize_imagenet, vgg_features


def npr_train_step(model, optimizer, active, batch, sem: SemanticEncoder, *,
                   weights: StyleLossWeights, H: int, W: int, crop_h: int,
                   crop_w: int, feature_size: int, mse_loss_w: float,
                   cos_loss_w: float, color_patch_w: float,
                   crop_origin=None):
    """One NPR LAENeRF step on one padded view batch (tensors on the
    model's device, x_term already jittered). crop_origin: (row, col),
    batch["crop_origin"] when not given. Returns aux {"loss", "mse"} (0-d
    tensors); the model is updated."""
    valid = batch["valid"].to(torch.float32)
    optimizer.zero_grad(set_to_none=True)
    colors, w_hat, o_hat = laenerf_forward_train(model, batch["x_term"],
                                                 batch["dirs"], active)
    colors = colors * batch["w8s"][:, None]
    vm = valid[:, None]

    # the distance-weighted registration MSE
    tw = (batch["target_weights"] * valid)[:, None]
    denom = torch.clamp(torch.sum(tw) * 3, min=1.0)
    mse = torch.sum(((colors - batch["targets"]) ** 2) * tw) / denom
    loss = mse * mse_loss_w
    loss = loss + LAENeRFLosses.weights(
        w_hat, weights.weight_loss_uniform, weights.weight_loss_non_uniform,
        valid=valid)
    loss = loss + LAENeRFLosses.offsets(o_hat * vm, weights.offset_loss)
    loss = loss + LAENeRFLosses.palette(
        model.palette, active, weights.palette_loss_valid,
        weights.palette_loss_distinct)

    origin = batch["crop_origin"] if crop_origin is None else crop_origin
    full, img = scatter_crop(colors, vm > 0, batch["inds"], H, W, crop_h,
                             crop_w, origin)
    img_chw = torch.movedim(img, -1, 0)

    # the NNFM cosine feature loss
    x = resize_bilinear(img_chw, (feature_size, feature_size))
    feats = vgg_features(sem.params, sem.kinds, normalize_imagenet(x)[None],
                         FEAT_LAYERS)
    pred_feat = torch.stack([f[0] for f in feats]).reshape(
        len(FEAT_LAYERS), feats[0].shape[1], -1)
    loss = loss + SemanticEncoder.cos_loss(
        pred_feat, batch["sup_feat"].reshape(pred_feat.shape)) * cos_loss_w

    # the colour-patch loss on the full frame
    ph, pw = batch["col_patch"].shape[-2:]
    color_pred = resize_bilinear(torch.movedim(full, -1, 0), (ph, pw))
    loss = loss + torch.mean((color_pred - batch["col_patch"]) ** 2) \
        * color_patch_w

    # TV with the style-guide weighting, and depth discontinuity
    if weights.tv_weight > 0:
        if weights.tv_depth_guide:
            tv = LAENeRFLosses.tv_depth_weighted(
                img_chw, batch["tv_v"], batch["tv_h"],
                1.0 - batch["style_guide"])
        else:
            tv = LAENeRFLosses.tv(img_chw)
        loss = loss + weights.tv_weight * tv
    if weights.depth_disc_weight > 0:
        loss = loss + weights.depth_disc_weight * \
            LAENeRFLosses.depth_discontinuity(img_chw, batch["tv_v"],
                                              batch["tv_h"])
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach(), "mse": mse.detach()}


class NPRTrainer:
    """Drives NPR LAENeRF training over a SingleViewEditDataset on
    `device`. Initial weights and the depth re-jitter come from one
    torch.Generator seeded by `seed`; the view order from the dataset's
    numpy RandomState."""

    def __init__(self, cfg: LAENeRFConfig, weights: StyleLossWeights,
                 npr_dataset, semantic_encoder: SemanticEncoder, *,
                 device="cuda", lr: float = 1e-3, mse_loss_w: float = 6.0,
                 cos_loss_w: float = 2.5, color_patch_w: float = 30.0,
                 seed: int = 0):
        self.cfg = cfg
        self.weights = weights
        self.ds = npr_dataset
        self.sem = semantic_encoder
        self.mse_loss_w = mse_loss_w
        self.cos_loss_w = cos_loss_w
        self.color_patch_w = color_patch_w
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model, self.active = laenerf_init(cfg, device=self.device,
                                               generator=self.generator)
        self.optimizer = make_style_optimizer(self.model, lr)
        self.step = 0
        self.mse_history = []  # one float per step, read once per call
        self._dev_views = {}

    def _device_view(self, i: int):
        """A view's arrays on the device, moved there once; the crop origin
        stays on the host."""
        if i not in self._dev_views:
            v = self.ds.views[i]
            jb = {k: torch.as_tensor(a, device=self.device)
                  for k, a in v.items()
                  if isinstance(a, np.ndarray) and k != "crop_origin"}
            self._dev_views[i] = (jb, tuple(int(c) for c in v["crop_origin"]),
                                  float(v.get("depth_factor", 0.0)))
        return self._dev_views[i]

    def train_steps(self, n: int):
        """Run n steps over shuffled views; returns their mean MSE (read
        back once, at the end)."""
        mses = []
        order = self.ds.epoch_indices()
        oi = 0
        for _ in range(n):
            if oi >= len(order):
                order = self.ds.epoch_indices()
                oi = 0
            base, origin, depth_factor = self._device_view(int(order[oi]))
            oi += 1
            jb = dict(base)
            if depth_factor > 0:
                d = (torch.rand((jb["x_term"].shape[0],),
                                generator=self.generator, device=self.device)
                     - 0.5) * depth_factor
                jb["x_term"] = base["x_term"] + d[:, None] * base["dirs"]
            aux = npr_train_step(
                self.model, self.optimizer, self.active, jb, self.sem,
                weights=self.weights, H=self.ds.H, W=self.ds.W,
                crop_h=self.ds.crop_h, crop_w=self.ds.crop_w,
                feature_size=self.ds.feature_size,
                mse_loss_w=self.mse_loss_w, cos_loss_w=self.cos_loss_w,
                color_patch_w=self.color_patch_w, crop_origin=origin)
            self.step += 1
            mses.append(aux["mse"])
        if not mses:
            return float("nan")
        vals = torch.stack(mses).tolist()
        self.mse_history.extend(vals)
        return float(np.mean(vals))


@torch.no_grad()
def build_npr_nerf_dataset(npr_dataset, model, active, dataset,
                           out_dir=None):
    """Bake the NPR supervision images of every view.

    Returns per-view dicts for Trainer.train_one_batch_npr: target (the
    registration colours, alpha in channel 3), style_img (LAENeRF's
    predictions), target_weights (plus 1 - alpha: empty space is
    supervised too), depth and depth_weights, all [H, W(, 4)] numpy, and
    the view_index. With out_dir, writes style_img_<i>.png of each view.
    """
    H, W = npr_dataset.H, npr_dataset.W
    dev = model.palette.device
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    out = []
    for v in npr_dataset.views:
        idx = int(v["view_index"])
        n = int(v["n_valid"])
        inds = v["inds"][:n]
        alpha = dataset.images[idx][..., -1].reshape(-1) \
            if dataset.images.shape[-1] == 4 else np.ones(H * W, np.float32)

        tw = np.zeros(H * W, np.float32)
        tw[inds] = v["target_weights"][:n]
        tw += 1.0 - alpha

        ref_img = np.zeros((H * W, 4), np.float32)
        ref_img[:, 3] = alpha
        ref_img[inds, :3] = v["targets"][:n]

        colors, _, _ = laenerf_forward_train(
            model, torch.as_tensor(v["x_term"], device=dev),
            torch.as_tensor(v["dirs"], device=dev), active)
        style_img = np.zeros((H * W, 4), np.float32)
        style_img[inds, 3] = alpha[inds]
        style_img[inds, :3] = colors[:n].cpu().numpy()

        depth = np.zeros(H * W, np.float32)
        depth[inds] = v["depths"][:n]
        depth_w = np.zeros(H * W, np.float32)
        depth_w[inds] = 1.0

        out.append({
            "view_index": idx,
            "target": ref_img.reshape(H, W, 4),
            "style_img": style_img.reshape(H, W, 4),
            "target_weights": tw.reshape(H, W),
            "depth": depth.reshape(H, W),
            "depth_weights": depth_w.reshape(H, W),
        })
        if out_dir:
            write_png(os.path.join(out_dir, f"style_img_{idx}.png"),
                      to_u8(style_img[:, :3].reshape(H, W, 3)))
    return out
