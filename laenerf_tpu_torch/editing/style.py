"""VGG-19 Gram-matrix style network (counterpart of
laenerf_tpu/editing/style.py): Gram targets from a randomly cropped style
image, the Gram loss of rendered images against them, and the covariance
colour matching of --preserve_color.
"""

from typing import Sequence

import numpy as np
import torch

from ..utils.images import resize_bilinear
from .vgg import normalize_imagenet, vgg_features, vgg_init


def gram_matrices(feats):
    """Per-layer Gram matrices normalised by c*h*w. feats: list of
    [1, C, H, W]."""
    outs = []
    for f in feats:
        _, c, h, w = f.shape
        flat = f[0].reshape(c, h * w)
        outs.append((flat @ flat.T) / (c * h * w))
    return outs


def match_color(style_img, target_img, eps=1e-5):
    """Transfer the target image's colour statistics onto the style image
    through covariance eigendecompositions (float64 numpy).

    Args:
      style_img, target_img: [3, H, W] arrays in [0, 1].
    Returns the matched style image [3, H, W] float32.
    """
    style_img = np.asarray(style_img, np.float64)
    target_img = np.asarray(target_img, np.float64)

    mu_t = style_img.mean(axis=(1, 2), keepdims=True)
    t = (style_img - mu_t).reshape(3, -1)
    Ct = t @ t.T / t.shape[1] + eps * np.eye(3)

    mu_s = target_img.mean(axis=(1, 2), keepdims=True).reshape(3, 1, 1)
    s = (target_img - target_img.mean(axis=(1, 2), keepdims=True)).reshape(
        3, -1)
    Cs = s @ s.T / s.shape[1] + eps * np.eye(3)

    eva_t, eve_t = np.linalg.eigh(Ct)
    Qt = eve_t @ np.diag(np.sqrt(np.maximum(eva_t, 0))) @ eve_t.T
    eva_s, eve_s = np.linalg.eigh(Cs)
    Qs = eve_s @ np.diag(np.sqrt(np.maximum(eva_s, 0))) @ eve_s.T
    ts = Qs @ np.linalg.inv(Qt) @ t

    matched = ts.reshape(style_img.shape) + mu_s
    return np.clip(matched, 0.0, 1.0).astype(np.float32)


class StyleNetwork:
    """Gram style loss against a style image, on `device`.

    Args:
      style_img: [3, H, W] float in [0, 1].
      style_layers: VGG-19 feature indices of the Gram matrices.
      size: the crop size; the style image is randomly cropped (padded
        first where smaller) to it, and rendered images resized to it.
      preserve_color: use the colour-matched Gram targets once
        set_color_target has made them.
      seed: the numpy RandomState of the crop (the JAX package's crop).
    """

    def __init__(self, style_img, style_layers: Sequence[int] = (10, 12, 14),
                 size: int = 256, preserve_color: bool = False,
                 seed: int = 0, *, device="cuda"):
        self.device = torch.device(device)
        self.params, self.kinds, self.pretrained = vgg_init(
            "vgg19", device=self.device)
        self.style_layers = tuple(sorted(style_layers))
        self.size = size
        self.preserve_color = preserve_color
        self.rng = np.random.RandomState(seed)
        self.image = np.asarray(style_img, np.float32)
        self.gram_style = self._target_grams(self.image, crop=True)
        self.gram_color = None

    def _random_crop(self, img):
        """A size x size window at a random origin, zero-padded (centred)
        first where the image is smaller."""
        c, h, w = img.shape
        if h < self.size or w < self.size:
            ph, pw = max(0, self.size - h), max(0, self.size - w)
            img = np.pad(img, ((0, 0), (ph // 2, ph - ph // 2),
                               (pw // 2, pw - pw // 2)))
            c, h, w = img.shape
        i = self.rng.randint(0, h - self.size + 1)
        j = self.rng.randint(0, w - self.size + 1)
        return img[:, i:i + self.size, j:j + self.size]

    def _features(self, img):
        return vgg_features(self.params, self.kinds,
                            normalize_imagenet(img)[None], self.style_layers)

    @torch.no_grad()
    def _target_grams(self, img, crop: bool):
        if crop:
            x = torch.as_tensor(np.ascontiguousarray(self._random_crop(img)),
                                device=self.device)
        else:
            x = resize_bilinear(torch.as_tensor(img, device=self.device),
                                (self.size, self.size))
        return gram_matrices(self._features(x))

    def set_color_target(self, target_img):
        """match_color the style image to target_img [3, H, W] and keep the
        matched image's Gram targets. Returns the matched image."""
        matched = match_color(self.image, target_img)
        self.gram_color = self._target_grams(matched, crop=False)
        return matched

    @property
    def targets(self):
        """The Gram targets in use: the colour-matched ones under
        preserve_color once made, else the style crop's."""
        if self.preserve_color and self.gram_color is not None:
            return self.gram_color
        return self.gram_style

    def gram_loss(self, img, targets):
        """Sum of squared Gram differences over every layer, over the total
        element count (one MSE over the stacked Grams). img: [3, h, w]
        in [0, 1], not resized."""
        grams = gram_matrices(self._features(img))
        total = sum(torch.sum((g - t) ** 2) for g, t in zip(grams, targets))
        return total / sum(g.numel() for g in grams)

    def __call__(self, img):
        """Gram loss of a rendered [3, H, W] image in [0, 1], resized (not
        cropped) to the style size."""
        return self.gram_loss(resize_bilinear(img, (self.size, self.size)),
                              self.targets)

    def guided_loss(self, img, guide, style_feats=None):
        """Guided Gram loss: the features of the rendered image and of the
        style image are both weighted by a spatial guide before their
        Grams; the mean squared difference per layer, averaged over the
        layers.

        Args:
          img: [3, H, W] rendered image; guide: [H, W] in [0, 1].
          style_feats: optional style features (the stored style image's at
            the style size by default).
        """
        img = resize_bilinear(img, (self.size, self.size))
        g = resize_bilinear(torch.as_tensor(guide, device=img.device)[None],
                            (self.size, self.size))
        feats_img = self._features(img)
        if style_feats is None:
            with torch.no_grad():
                style_feats = self._features(resize_bilinear(
                    torch.as_tensor(self.image, device=img.device),
                    (self.size, self.size)))
        loss = 0.0
        for fi, fs in zip(feats_img, style_feats):
            _, c, h, w = fi.shape
            gg = resize_bilinear(g, (h, w))[0]
            a = (fi[0] * gg).reshape(c, -1)
            b = (fs[0].detach() * gg).reshape(c, -1)
            Ga = a @ a.T / (c * h * w)
            Gb = b @ b.T / (c * h * w)
            loss = loss + torch.mean((Ga - Gb) ** 2)
        return loss / len(feats_img)
