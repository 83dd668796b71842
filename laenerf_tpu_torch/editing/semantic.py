"""Semantic feature encoder for reference-based NPR stylization
(counterpart of laenerf_tpu/editing/semantic.py): VGG-16 features, the
chunked cosine nearest-neighbour feature and colour replacement, the
cosine feature loss, and covariance colour matching.
"""

import numpy as np
import torch

from ..utils.images import resize_bilinear
from .vgg import normalize_imagenet, vgg_features, vgg_init

FEAT_LAYERS = (11, 13, 15)  # the relu3_x block
COLOR_LAYERS = (25, 27, 29)  # the relu5_x block


class SemanticEncoder:
    """VGG-16 feature matching on `device` (weights from a local npz if
    present, else the seeded random filters)."""

    def __init__(self, *, device="cuda"):
        self.device = torch.device(device)
        self.params, self.kinds, self.pretrained = vgg_init(
            "vgg16", device=self.device)

    def encode_feats(self, img, layers=FEAT_LAYERS, size=(256, 256)):
        """img [3, H, W] in [0, 1] (array or tensor), resized to size
        unless None -> stacked [L, C, h, w] features (the layers share
        their channel count)."""
        x = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        if size is not None:
            x = resize_bilinear(x, size)
        feats = vgg_features(self.params, self.kinds,
                             normalize_imagenet(x)[None], tuple(layers))
        return torch.stack([f[0] for f in feats], dim=0)

    # -- cosine nearest neighbours ---------------------------------------

    @staticmethod
    def cos_loss(a, b):
        """Mean (1 - cosine similarity) along the channel axis. a, b:
        [L, C, HW]."""
        an = a / (torch.sqrt(torch.sum(a * a, 1, keepdim=True)) + 1e-8)
        bn = b / (torch.sqrt(torch.sum(b * b, 1, keepdim=True)) + 1e-8)
        return torch.mean(1.0 - torch.sum(an * bn, dim=1))

    @staticmethod
    def _argmin_cos(a, b, chunk=4096):
        """Per-column nearest neighbour of a in b by cosine distance, in
        chunks of a's columns. a: [C, HW], b: [C, H2W2] -> (idx [HW],
        dist [HW])."""
        bn = b / (torch.sqrt(torch.sum(b * b, 0, keepdim=True) + 1e-8)
                  + 1e-8)
        idxs, dists = [], []
        for s in range(0, a.shape[-1], chunk):
            ac = a[:, s:s + chunk]
            an = ac / (torch.sqrt(torch.sum(ac * ac, 0, keepdim=True)
                                  + 1e-8) + 1e-8)
            d = 1.0 - an.T @ bn  # [chunk, H2W2]
            dist, idx = torch.min(d, dim=1)
            idxs.append(idx)
            dists.append(dist)
        return torch.cat(idxs), torch.cat(dists)

    def nn_feat_replace(self, content, content_style, style):
        """For each content location, the style feature whose content_style
        feature is most similar. All inputs [L, C, h, w]; returns
        [L, C, hw]."""
        L, C = content.shape[:2]
        out = []
        for i in range(L):
            idx, _ = self._argmin_cos(content[i].reshape(C, -1),
                                      content_style[i].reshape(C, -1))
            out.append(style[i].reshape(C, -1)[:, idx])
        return torch.stack(out, dim=0)

    def nn_feat_replace_color(self, content, content_style, style_color):
        """Colour transfer: each location takes the style colour at its
        nearest neighbour in the layer where that neighbour is closest.
        style_color: [3, h, w]; returns [3, h, w]."""
        L, C = content.shape[:2]
        h, w = style_color.shape[-2:]
        sc = style_color.reshape(3, -1)
        colors, dists = [], []
        for i in range(L):
            idx, d = self._argmin_cos(content[i].reshape(C, -1),
                                      content_style[i].reshape(C, -1))
            colors.append(sc[:, idx])
            dists.append(d)
        best = torch.argmin(torch.stack(dists), dim=0)  # [hw]
        colors = torch.stack(colors)  # [L, 3, hw]
        picked = torch.gather(colors, 0,
                              best[None, None, :].expand(1, 3, -1))[0]
        return picked.reshape(3, h, w)

    @staticmethod
    def get_mean_patch_color(img, size=(32, 32)):
        """img [3, H, W] resized to the colour features' resolution."""
        return resize_bilinear(img, size)

    # -- colour statistics matching --------------------------------------

    @staticmethod
    def match_colors_for_image_set(image, style_img):
        """Whiten-recolour covariance transfer of image toward style_img
        (float64 numpy). image, style_img: [..., 3] in [0, 1]. Returns
        (matched, color_tf [4, 4])."""
        img = np.asarray(image, np.float64).reshape(-1, 3)
        sty = np.asarray(style_img, np.float64).reshape(-1, 3)
        mu_c, mu_s = img.mean(0), sty.mean(0)
        cov_c = (img - mu_c).T @ (img - mu_c) / len(img)
        cov_s = (sty - mu_s).T @ (sty - mu_s) / len(sty)
        u_c, sig_c, _ = np.linalg.svd(cov_c)
        u_s, sig_s, _ = np.linalg.svd(cov_s)
        scl_c = np.diag(1.0 / np.sqrt(np.clip(sig_c, 1e-8, 1e8)))
        scl_s = np.diag(np.sqrt(np.clip(sig_s, 1e-8, 1e8)))
        tmp = u_s @ scl_s @ u_s.T @ u_c @ scl_c @ u_c.T
        vec = mu_s - mu_c @ tmp.T
        out = np.clip(img @ tmp.T + vec, 0, 1).reshape(np.shape(image))
        tf = np.eye(4)
        tf[:3, :3] = tmp
        tf[:3, 3] = vec
        return out.astype(np.float32), tf.astype(np.float32)


def nnfm_loss(encoder: SemanticEncoder, pred_feats, target_nn_feats):
    """The nearest-neighbour feature-matching loss: cosine distance between
    rendered features [L, C, h, w] and the NN-replaced style features
    [L, C, hw]."""
    return encoder.cos_loss(
        pred_feats.reshape(pred_feats.shape[0], pred_feats.shape[1], -1),
        target_nn_feats)
