"""LAENeRF: the palette-based local appearance editing model (counterpart of
laenerf_tpu/editing/laenerf.py).

A 3-D octo hash-grid encoder over ray-termination points feeds (a) a
weight net -> masked softmax -> barycentric palette weights and (b) an
offset net (with an SH direction encoding) -> tanh view-dependent offsets;
colors are clamp(weights @ palette + offset, 0, 1). The [K, 3] palette is
learned, and an activity mask [K] bool prunes bases: inactive logits are
set to -inf before the softmax. The encoder's backward runs through the
K1 scatter-add kernel (ops/hashgrid.py), here with C = 2 rows.
"""

import dataclasses

import torch
from torch import nn

from ..models.mlp import mlp_apply, mlp_init
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, hashgrid_init
from ..ops.sh import sh_encode, sh_output_dim


@dataclasses.dataclass(frozen=True)
class LAENeRFConfig:
    """Same fields and defaults as the JAX package's, minus its TPU-only
    paired-gather layout (the octo layout takes precedence there too)."""

    bound: float = 1.0
    num_layers: int = 3
    hidden_dim: int = 64
    num_palette_bases: int = 8
    dir_degree: int = 3  # SH degree for the offset net (0 = no dir input)
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    octo_gather: bool = True
    gather_dtype: str = "bf16"

    @property
    def grid_spec(self) -> HashGridSpec:
        return HashGridSpec.create(
            desired_resolution=2048 * self.bound,
            num_levels=self.num_levels,
            level_dim=self.level_dim,
            base_resolution=self.base_resolution,
            log2_hashmap_size=self.log2_hashmap_size,
            octo_gather=self.octo_gather,
            gather_dtype=self.gather_dtype,
        )

    @property
    def in_dim(self) -> int:
        return self.grid_spec.output_dim

    @property
    def in_dim_dir(self) -> int:
        return sh_output_dim(self.dir_degree) if self.dir_degree > 0 else 0


class LAENeRF(nn.Module):
    """Parameters: `encoder` [T, C] table, `weight_net`, `offset_net`,
    `palette` [K, 3]."""

    def __init__(self, cfg: LAENeRFConfig, *, device, generator=None,
                 color_palette=None):
        super().__init__()
        self.cfg = cfg
        K = cfg.num_palette_bases
        hidden = [cfg.hidden_dim] * (cfg.num_layers - 1)
        self.encoder = nn.Parameter(
            hashgrid_init(cfg.grid_spec, device=device, generator=generator))
        self.weight_net = mlp_init([cfg.in_dim] + hidden + [K],
                                   device=device, generator=generator)
        self.offset_net = mlp_init(
            [cfg.in_dim + cfg.in_dim_dir] + hidden + [3], device=device,
            generator=generator)
        if color_palette is None:
            palette = torch.rand((K, 3), generator=generator, device=device)
        else:
            palette = torch.as_tensor(color_palette, dtype=torch.float32,
                                      device=device)
        self.palette = nn.Parameter(palette)


def laenerf_init(cfg: LAENeRFConfig, *, device, generator=None,
                 color_palette=None):
    """A fresh LAENeRF (palette U(0, 1) unless given) and its all-active
    mask. Returns (model, active [K] bool)."""
    model = LAENeRF(cfg, device=device, generator=generator,
                    color_palette=color_palette)
    active = torch.ones((cfg.num_palette_bases,), dtype=torch.bool,
                        device=device)
    return model, active


def _encode(model: LAENeRF, x):
    cfg = model.cfg
    return hashgrid_encode(model.encoder, x, cfg.grid_spec, bound=cfg.bound)


def _masked_softmax(logits, active):
    return torch.softmax(torch.where(active[None, :], logits, -torch.inf),
                         dim=-1)


def laenerf_weights(model: LAENeRF, x, active):
    """Softmax palette weights [N, K] over the active bases."""
    return _masked_softmax(mlp_apply(model.weight_net, _encode(model, x)),
                           active)


def laenerf_forward_train(model: LAENeRF, x, d, active,
                          palette_override=None):
    """Full forward.

    Args:
      x: [N, 3] termination points in [-bound, bound].
      d: [N, 3] unit directions (or None when dir_degree == 0).
      active: [K] bool palette activity mask.
      palette_override: optional [K, 3] palette replacing the learned one.
    Returns:
      colors [N, 3] in [0, 1], weights [N, K], offsets [N, 3].
    """
    cfg = model.cfg
    feats = _encode(model, x)
    offset_in = feats
    if cfg.dir_degree > 0 and d is not None:
        offset_in = torch.cat([feats, sh_encode(d, cfg.dir_degree)], dim=-1)
    w_hat = _masked_softmax(mlp_apply(model.weight_net, feats), active)
    o_hat = torch.tanh(mlp_apply(model.offset_net, offset_in))
    palette = model.palette if palette_override is None else palette_override
    colors = w_hat @ palette + o_hat
    return torch.clamp(colors, 0.0, 1.0), w_hat, o_hat


@torch.no_grad()
def prune_palette(model: LAENeRF, active, x_term_views, thresh: float = 0.025,
                  valid_views=None):
    """Deactivate the bases whose mean weight over the given views falls
    below thresh. valid_views: optional [Ni] masks of the views' real rows
    (padded rows sit at the origin and would bias the mean). Returns the
    new active mask [K] bool."""
    mean_w = torch.zeros((model.cfg.num_palette_bases,),
                         device=active.device)
    for i, x in enumerate(x_term_views):
        w = laenerf_weights(model, x, active)
        if valid_views is None:
            mean_w = mean_w + torch.mean(w, dim=0)
        else:
            v = valid_views[i].to(w.dtype)[:, None]
            mean_w = mean_w + (torch.sum(w * v, dim=0)
                               / torch.clamp(torch.sum(v), min=1.0))
    return mean_w / len(x_term_views) >= thresh


class LAENeRFLosses:
    """The regularization losses, as static methods; sums where the
    reference sums."""

    @staticmethod
    def weights(pred_weights, uniform_w: float, non_uniform_w: float,
                valid=None):
        """uniform: the largest per-base column sum; non-uniform: push each
        point's largest weight toward 1. `valid` masks padded rows out."""
        if valid is None:
            valid = torch.ones(pred_weights.shape[:1],
                               dtype=pred_weights.dtype,
                               device=pred_weights.device)
        v = valid[:, None].to(pred_weights.dtype)
        uniform_loss = torch.max(torch.sum(pred_weights * v, dim=0))
        non_uniform_loss = torch.sum(
            (1.0 - torch.amax(pred_weights, dim=-1)) * valid)
        return uniform_loss * uniform_w + non_uniform_loss * non_uniform_w

    @staticmethod
    def palette(palette, active, valid_w: float, distinct_w: float):
        """Out-of-gamut penalty + pairwise distinctness."""
        dists = torch.sum((palette[:, None, :] - palette[None, :, :]) ** 2,
                          dim=-1)
        dist_loss = torch.mean(
            1.0 - dists / torch.clamp(torch.max(dists), min=1e-8))
        valid_loss = torch.sum(torch.floor(palette) * palette)
        return valid_loss * valid_w + dist_loss * distinct_w

    @staticmethod
    def offsets(pred_offsets, w: float):
        return torch.sum(pred_offsets ** 2) * w

    @staticmethod
    def tv(img):
        """Plain TV of a [C, H, W] image (dim-1 and last-dim differences)."""
        w_var = torch.sum((img[:, :-1, :] - img[:, 1:, :]) ** 2)
        v_var = torch.sum((img[..., :-1] - img[..., 1:]) ** 2)
        return w_var + v_var

    @staticmethod
    def depth_discontinuity(img, depth_v_var, depth_w_var):
        """Negative loss encouraging color edges at depth and RGB edges."""
        dv = depth_v_var / torch.clamp(torch.max(depth_v_var), min=1e-8)
        dw = depth_w_var / torch.clamp(torch.max(depth_w_var), min=1e-8)
        w_var = (img[:, :-1, :] - img[:, 1:, :]) ** 2 * dw[None]
        v_var = (img[..., :-1] - img[..., 1:]) ** 2 * dv[None]
        return -torch.sum(w_var) - torch.sum(v_var)

    @staticmethod
    def tv_depth_weighted(img, depth_v_var, depth_w_var, weights_trans=None):
        """TV weighted away from depth edges (and the transition shell)."""
        if weights_trans is not None:
            dv = (1.0 - depth_v_var) * (1.0 - weights_trans[:, 1:])
            dw = (1.0 - depth_w_var) * (1.0 - weights_trans[1:, :])
        else:
            dv = 1.0 - depth_v_var
            dw = 1.0 - depth_w_var
        w_var = torch.sum((img[:, :-1, :] - img[:, 1:, :]) ** 2 * dw[None])
        v_var = torch.sum((img[..., :-1] - img[..., 1:]) ** 2 * dv[None])
        return w_var + v_var

    @staticmethod
    def smooth_transition(ref_img, img, transition_weights):
        """Pull colors toward the frozen NeRF's in the transition shell."""
        diff = torch.sum((img - ref_img) ** 2, dim=-1)
        return torch.sum(diff * transition_weights)

    @staticmethod
    def intensity(ref_img, img):
        return torch.sum((torch.linalg.norm(img, dim=-1)
                          - torch.linalg.norm(ref_img, dim=-1)) ** 2)
