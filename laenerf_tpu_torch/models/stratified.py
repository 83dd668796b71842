"""Stratified + importance-sampled rendering without an occupancy grid
(counterpart of laenerf_tpu/models/stratified.py): uniform z samples in
[near, far], a coarse density pass, inverse-CDF upsampling on the coarse
weights, a merged sorted fine pass, and alpha compositing.

The random draws (the z jitter and the inverse-CDF u) come from a
torch.Generator or are injected as tensors.
"""

import torch

from ..ops.raymarch import near_far_from_aabb
from .nerf import NeRFNetwork, nerf_color, nerf_density
from .renderer import RenderConfig, _aabb, _background


def sample_pdf(bins, weights, n_samples: int, det: bool = False, u=None,
               generator=None):
    """Inverse-CDF sampling.

    Args:
      bins: [B, T] bin positions; weights: [B, T - 1] bin weights.
      n_samples: number of new samples.
      det: evenly spaced u (eval) instead of uniform-random u.
      u: optional [B, n_samples] uniforms in [0, 1) (drawn from generator
        when not given and not det).
    Returns [B, n_samples] new z values.
    """
    B = bins.shape[0]
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [B, T]
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           device=bins.device).expand(B, n_samples)
    elif u is None:
        u = torch.rand((B, n_samples), generator=generator,
                       device=bins.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_b = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_a = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a),
                        cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def render_rays_stratified(net: NeRFNetwork, rays_o, rays_d, *,
                           render_cfg: RenderConfig, num_steps: int = 128,
                           upsample_steps: int = 128, bg_color=None,
                           perturb: bool = False, training: bool = False,
                           jitter=None, u=None, generator=None):
    """Coarse-to-fine stratified rendering of rays_o, rays_d [N, 3].

    Args:
      jitter: optional [N, num_steps] uniforms for perturb (the z offsets
        are (jitter - 0.5) * the sample spacing).
      u: optional [N, upsample_steps] uniforms of the inverse CDF when
        training (eval uses evenly spaced ones).
    Returns dict(image [N, 3], depth [N], weights_sum [N], nears [N],
    fars [N]).
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    bound = render_cfg.bound
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(bound, dev),
                                     render_cfg.min_near)
    nears, fars = nears[:, None], fars[:, None]

    z = torch.linspace(0.0, 1.0, num_steps, device=dev)[None, :]
    z_vals = nears + (fars - nears) * z  # [N, T]
    sample_dist = (fars - nears) / num_steps
    if perturb:
        if jitter is None:
            jitter = torch.rand(z_vals.shape, generator=generator,
                                device=dev)
        z_vals = z_vals + (jitter - 0.5) * sample_dist

    def query_density(zv):
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]
        xyz = torch.clamp(xyz, -bound, bound)
        out = nerf_density(net, xyz.reshape(-1, 3))
        T = zv.shape[1]
        return (out["sigma"].reshape(N, T),
                out["geo_feat"].reshape(N, T, -1), xyz)

    def last_delta(deltas):
        return torch.cat([deltas, sample_dist.expand_as(deltas[..., :1])],
                         -1)

    sigmas, geo, xyzs = query_density(z_vals)

    if upsample_steps > 0:
        # importance sampling on the coarse weights
        deltas = last_delta(torch.diff(z_vals, dim=-1))
        sd = sigmas.detach() * render_cfg.density_scale * deltas
        csum = torch.cumsum(sd, -1)
        weights = (1.0 - torch.exp(-sd)) * torch.exp(-(csum - sd))
        z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
        new_z = sample_pdf(z_mid, weights[:, 1:-1], upsample_steps,
                           det=not training, u=u,
                           generator=generator).detach()
        new_sig, new_geo, new_xyz = query_density(new_z)

        z_vals = torch.cat([z_vals, new_z], dim=1)
        z_vals, order = torch.sort(z_vals, dim=1, stable=True)
        sigmas = torch.gather(torch.cat([sigmas, new_sig], dim=1), 1, order)
        geo = torch.cat([geo, new_geo], dim=1)
        geo = torch.gather(geo, 1, order[..., None].expand(-1, -1,
                                                            geo.shape[-1]))
        xyzs = torch.gather(torch.cat([xyzs, new_xyz], dim=1), 1,
                            order[..., None].expand(-1, -1, 3))

    T_total = z_vals.shape[1]
    deltas = last_delta(torch.diff(z_vals, dim=-1))
    sd = sigmas * render_cfg.density_scale * deltas
    csum = torch.cumsum(sd, -1)
    weights = (1.0 - torch.exp(-sd)) * torch.exp(-(csum - sd))  # [N, T]

    dirs = rays_d[:, None, :].expand(N, T_total, 3)
    rgbs = nerf_color(net, dirs.reshape(-1, 3),
                      geo.reshape(N * T_total, -1)).reshape(N, T_total, 3)

    weights_sum = torch.sum(weights, -1)
    depth = torch.sum(weights * z_vals, -1)  # absolute z
    image = torch.sum(weights[..., None] * rgbs, dim=1)
    image = image + (1.0 - weights_sum)[:, None] * _background(
        net, rays_o, rays_d, bg_color)
    return {"image": image, "depth": depth, "weights_sum": weights_sum,
            "nears": nears[:, 0], "fars": fars[:, 0]}
