"""Instant-NGP-style NeRF network (counterpart of laenerf_tpu/models/nerf.py):
hash encoding -> 2-layer sigma MLP -> trunc_exp density + geometric feature;
SH(dir) ++ geo-feature -> 3-layer color MLP -> sigmoid.

The background network (`bg_radius > 0`) needs the generic xor-hash grid,
which is not ported yet: building such a network raises NotImplementedError.
"""

import dataclasses

import torch
from torch import nn

from ..ops.activation import trunc_exp
from ..ops.hashgrid import HashGridSpec, hashgrid_encode, hashgrid_init
from ..ops.sh import sh_encode, sh_output_dim
from .mlp import mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Static model configuration (same fields and defaults as the JAX
    package's, minus its TPU-only paired-gather layout)."""

    bound: float = 1.0
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    sh_degree: int = 4
    bg_radius: float = -1.0
    density_scale: float = 1.0
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
        return sh_output_dim(self.sh_degree)


class NeRFNetwork(nn.Module):
    """Parameters: `encoder` [T, C] table, `sigma_net`, `color_net`."""

    def __init__(self, cfg: NeRFConfig, *, device, generator=None):
        super().__init__()
        if cfg.bg_radius > 0:
            raise NotImplementedError(
                "bg_radius > 0 needs the background network on the generic "
                "xor-hash grid, which is not ported yet")
        self.cfg = cfg
        sigma_dims = ([cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
                      + [1 + cfg.geo_feat_dim])
        color_dims = ([cfg.in_dim_dir + cfg.geo_feat_dim]
                      + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1)
                      + [3])
        self.encoder = nn.Parameter(
            hashgrid_init(cfg.grid_spec, device=device, generator=generator))
        self.sigma_net = mlp_init(sigma_dims, device=device,
                                  generator=generator)
        self.color_net = mlp_init(color_dims, device=device,
                                  generator=generator)

    def forward(self, x, d, gather_table=None):
        return nerf_forward(self, x, d, gather_table=gather_table)


def nerf_init(cfg: NeRFConfig, *, device, generator=None) -> NeRFNetwork:
    return NeRFNetwork(cfg, device=device, generator=generator)


def gather_table_for(net: NeRFNetwork):
    """The encoder table as the forward gathers it (rounded to the spec's
    gather dtype), for callers that render many chunks from one table."""
    spec = net.cfg.grid_spec
    t = net.encoder.detach()
    return t.to(torch.bfloat16) if spec.gather_dtype == "bf16" else t


def nerf_density(net: NeRFNetwork, x, gather_table=None):
    """sigma [N] and geo features [N, geo_feat_dim] at positions x [N, 3]."""
    cfg = net.cfg
    feats = hashgrid_encode(net.encoder, x, cfg.grid_spec, bound=cfg.bound,
                            gather_table=gather_table)
    h = mlp_apply(net.sigma_net, feats)
    return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}


def nerf_color(net: NeRFNetwork, d, geo_feat):
    """Directional color head: rgb [N, 3] in (0, 1)."""
    d_enc = sh_encode(d, net.cfg.sh_degree)
    h = torch.cat([d_enc, geo_feat], dim=-1)
    return torch.sigmoid(mlp_apply(net.color_net, h))


def nerf_forward(net: NeRFNetwork, x, d, gather_table=None):
    """x [N, 3] positions, d [N, 3] unit directions -> sigma [N], rgb [N, 3]."""
    dens = nerf_density(net, x, gather_table=gather_table)
    return dens["sigma"], nerf_color(net, d, dens["geo_feat"])
