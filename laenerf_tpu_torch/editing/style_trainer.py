"""LAENeRF training loop, the "style encoder" phase (counterpart of
laenerf_tpu/editing/style_trainer.py).

Per step, one view's padded rays go through LAENeRF; the loss is the masked
MSE against the frozen NeRF's colors plus the weight, offset and palette
regularizers, and after warmup_iterations the crop losses on the predicted
colors scattered into the view's crop window: the VGG-19 Gram style loss
(the crop resized to crop_size), (depth-guided) TV, smooth transition and
depth discontinuity. Adam(1e-3) with the palette at 2x lr, as two
parameter groups. Palette pruning runs at (train_steps_style -
distill_palette_steps), driven by pipeline/driver.py.
"""

import dataclasses

import numpy as np
import torch

from ..utils.images import resize_bilinear
from ..utils.timers import count, span
from .laenerf import (LAENeRFConfig, LAENeRFLosses, laenerf_forward_train,
                      laenerf_init, prune_palette)


@dataclasses.dataclass(frozen=True)
class StyleLossWeights:
    """Loss weights (the JAX package's defaults)."""

    tv_weight: float = 0.0
    depth_disc_weight: float = 0.0
    smooth_trans_weight: float = 0.0
    style_weight: float = 0.0
    intensity_weight: float = 0.0
    offset_loss: float = 0.0
    weight_loss_non_uniform: float = 0.0
    weight_loss_uniform: float = 0.0
    palette_loss_valid: float = 0.0
    palette_loss_distinct: float = 0.0
    tv_depth_guide: bool = False
    warmup_iterations: int = 1000


def make_style_optimizer(model, lr: float = 1e-3):
    """Adam with the palette at 2x lr (optax.adam's defaults)."""
    nets = [p for n, p in model.named_parameters() if n != "palette"]
    return torch.optim.Adam([{"params": nets, "lr": lr},
                             {"params": [model.palette], "lr": 2 * lr}],
                            betas=(0.9, 0.999), eps=1e-8)


def scatter_crop(colors, vm, inds, H, W, crop_h, crop_w, crop_origin):
    """Predictions scattered into the full image (the padded rows into a
    spare row H*W). Returns (full [H, W, 3], the crop window
    [crop_h, crop_w, 3])."""
    flat = torch.zeros((H * W + 1, 3), dtype=torch.float32,
                       device=colors.device)
    flat = flat.index_put((inds.long(),),
                          torch.where(vm, colors.float(), 0.0))
    full = flat[:H * W].reshape(H, W, 3)
    cx, cy = int(crop_origin[0]), int(crop_origin[1])
    return full, full[cx:cx + crop_h, cy:cy + crop_w]


def _crop_losses(colors, vm, batch, weights: StyleLossWeights, H, W,
                 crop_h, crop_w, crop_origin, style_network=None,
                 gram_targets=None, crop_size: int = 256):
    """The crop-loss block on the crop window of the scattered
    predictions; the Gram term runs when a style network is given."""
    with span("laenerf.crop"):
        _, img = scatter_crop(colors, vm, batch["inds"], H, W, crop_h,
                              crop_w, crop_origin)
        img_chw = torch.movedim(img, -1, 0)
        loss = 0.0
        if style_network is not None and weights.style_weight > 0:
            with span("laenerf.gram"):
                x = resize_bilinear(img_chw, (crop_size, crop_size))
                loss = loss + weights.style_weight * style_network.gram_loss(
                    x, gram_targets)
        if weights.tv_weight > 0:
            if weights.tv_depth_guide:
                tv = LAENeRFLosses.tv_depth_weighted(
                    img_chw, batch["tv_v"], batch["tv_h"],
                    batch["cut_smooth"] if weights.smooth_trans_weight > 0
                    else None)
            else:
                tv = LAENeRFLosses.tv(img_chw)
            loss = loss + weights.tv_weight * tv
        if weights.smooth_trans_weight > 0:
            loss = loss + weights.smooth_trans_weight * \
                LAENeRFLosses.smooth_transition(batch["cut_gt"], img,
                                                batch["cut_smooth"])
        if weights.depth_disc_weight > 0:
            loss = loss + weights.depth_disc_weight * \
                LAENeRFLosses.depth_discontinuity(img_chw, batch["tv_v"],
                                                  batch["tv_h"])
    return loss


def laenerf_train_step(model, optimizer, active, batch, *,
                       weights: StyleLossWeights, H: int, W: int,
                       crop_h: int, crop_w: int, past_warmup: bool,
                       crop_origin=None, style_network=None,
                       gram_targets=None, crop_size: int = 256):
    """One LAENeRF optimization step on one view's padded batch.

    Args:
      batch: EditDataset view as tensors on the model's device (x_term
        already jittered by the caller).
      crop_origin: (row, col) of the crop window; batch["crop_origin"]
        when not given.
      style_network, gram_targets: the Gram term's StyleNetwork and targets
        (style_weight > 0 and past warm-up); the crop is resized to
        crop_size for it.
    Returns aux {"loss", "mse"} (0-d tensors); the model is updated.
    """
    valid = batch["valid"]
    n_valid = torch.clamp(torch.sum(valid), min=1)
    optimizer.zero_grad(set_to_none=True)
    with span("laenerf.forward"):
        colors, w_hat, o_hat = laenerf_forward_train(
            model, batch["x_term"], batch["dirs"], active)
    with span("laenerf.loss"):
        vm = valid[:, None]
        mse = (torch.sum(((colors - batch["targets"]) ** 2) * vm)
               / (3 * n_valid))
        loss = mse + LAENeRFLosses.weights(
            w_hat, weights.weight_loss_uniform,
            weights.weight_loss_non_uniform, valid=valid.to(torch.float32))
        loss = loss + LAENeRFLosses.offsets(o_hat * vm, weights.offset_loss)
        loss = loss + LAENeRFLosses.palette(
            model.palette, active, weights.palette_loss_valid,
            weights.palette_loss_distinct)
        if weights.intensity_weight > 0:
            loss = loss + weights.intensity_weight * LAENeRFLosses.intensity(
                batch["targets"] * vm, colors * vm)
        if past_warmup and (weights.style_weight > 0 or weights.tv_weight > 0
                            or weights.smooth_trans_weight > 0
                            or weights.depth_disc_weight > 0):
            origin = (batch["crop_origin"] if crop_origin is None
                      else crop_origin)
            loss = loss + _crop_losses(colors, vm, batch, weights, H, W,
                                       crop_h, crop_w, origin, style_network,
                                       gram_targets, crop_size)
    with span("laenerf.backward"):
        loss.backward()
    with span("laenerf.optimizer"):
        optimizer.step()
    return {"loss": loss.detach(), "mse": mse.detach()}


class LAENeRFTrainer:
    """Drives the LAENeRF training phase over an EditDataset.

    Randomness (initial weights, depth re-jitter, pruning views) comes from
    one torch.Generator on `device`, seeded by `seed`. With a style_network
    (and style_weight > 0) the steps past warm-up add the Gram term at
    crop_size; gram_steps counts them.
    """

    def __init__(self, cfg: LAENeRFConfig, weights: StyleLossWeights,
                 edit_dataset, *, style_network=None, crop_size: int = 256,
                 device="cuda", lr: float = 1e-3, seed: int = 0):
        self.cfg = cfg
        self.weights = weights
        self.ds = edit_dataset
        self.style_network = style_network
        self.crop_size = crop_size
        self.gram_steps = 0
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model, self.active = laenerf_init(cfg, device=self.device,
                                               generator=self.generator)
        self.optimizer = make_style_optimizer(self.model, lr)
        self.step = 0
        self.mse_history = []  # one float per step, read once per chunk
        self._dev_views = {}

    def _device_view(self, i: int):
        """A view's arrays on the device, moved there once; the crop origin
        stays on the host."""
        if i not in self._dev_views:
            v = self.ds.views[i]
            jb = {k: torch.as_tensor(a, device=self.device)
                  for k, a in v.items()
                  if isinstance(a, np.ndarray) and k != "crop_origin"}
            count("sync.host_copy", len(jb))
            self._dev_views[i] = (jb, tuple(int(c) for c in v["crop_origin"]),
                                  float(v.get("depth_factor", 0.0)))
        return self._dev_views[i]

    def train_steps(self, n: int):
        """Run n steps over shuffled views; returns their mean MSE. The
        MSEs are read back once, at the end."""
        mses = []
        order = self.ds.epoch_indices()
        oi = 0
        for _ in range(n):
            if oi >= len(order):
                order = self.ds.epoch_indices()
                oi = 0
            with span("laenerf.step", step=self.step):
                base, origin, depth_factor = self._device_view(
                    int(order[oi]))
                oi += 1
                jb = dict(base)
                if depth_factor > 0:
                    # the x_term re-jitter along the ray
                    d = (torch.rand((jb["x_term"].shape[0],),
                                    generator=self.generator,
                                    device=self.device)
                         - 0.5) * depth_factor
                    jb["x_term"] = base["x_term"] + d[:, None] * base["dirs"]
                past_warmup = self.step > self.weights.warmup_iterations
                sn = self.style_network
                aux = laenerf_train_step(
                    self.model, self.optimizer, self.active, jb,
                    weights=self.weights, H=self.ds.H, W=self.ds.W,
                    crop_h=self.ds.crop_h, crop_w=self.ds.crop_w,
                    past_warmup=past_warmup, crop_origin=origin,
                    style_network=sn,
                    gram_targets=None if sn is None else sn.targets,
                    crop_size=self.crop_size)
                if past_warmup and sn is not None and \
                        self.weights.style_weight > 0:
                    self.gram_steps += 1
                self.step += 1
            mses.append(aux["mse"])
        if not mses:
            return float("nan")
        count("sync.mse_readback")
        vals = torch.stack(mses).tolist()
        self.mse_history.extend(vals)
        return float(np.mean(vals))

    def prune(self, n_views: int = 10, thresh: float = 0.025):
        """Palette pruning over n_views random views, padded rows masked
        out of the per-view means. Returns the new mask as numpy."""
        idx = torch.randint(0, len(self.ds), (n_views,),
                            generator=self.generator,
                            device=self.device).tolist()
        batches = [self._device_view(i)[0] for i in idx]
        self.active = prune_palette(
            self.model, self.active, [b["x_term"] for b in batches], thresh,
            valid_views=[b["valid"] for b in batches])
        return self.active.cpu().numpy()
