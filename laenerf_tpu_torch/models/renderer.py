"""Volume-rendering paths: training and inference (counterpart of
laenerf_tpu/models/renderer.py).

  * train: march (no gradient) -> compact the valid samples -> one network
    eval -> scatter back -> differentiable masked composite.
  * inference: a host loop of rounds; each round marches K_march events per
    ray, packs the occupied ones into K sample slots, evaluates the network
    on the compacted valid samples and folds them into per-ray accumulators.

The JAX package picks a compacted-eval capacity from a ladder at run time
because its shapes are static. The chosen rung is always >= the valid count
(up to the top capacity), so here the eval takes exactly min(n_valid, cap)
samples, cap being the top rung: max(N * m_cap_per_ray, 2048) (train) or
N * K // infer_compact_factor (inference). Past the cap the train path
truncates each ray to its evaluated prefix (`ray_ok` marks the truncated
rays) and the inference path rewinds the overflowing rays to re-march the
dropped samples next round.
"""

import dataclasses

import torch

from ..ops.compaction import compact_samples, gather_flat, scatter_back
from ..ops.composite import composite_chunk, composite_rays_train
from ..ops.raymarch import (MarchConfig, build_skip_field, make_march_event,
                            march_rays_train, near_far_from_aabb,
                            sample_positions)
from .nerf import NeRFNetwork, nerf_forward


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (same fields as the JAX package's)."""

    bound: float = 1.0
    cascades: int = 1
    grid_size: int = 128
    dt_gamma: float = 0.0
    max_steps: int = 1024
    min_near: float = 0.2
    density_scale: float = 1.0
    density_thresh: float = 0.01  # occupancy threshold (min'd with mean)
    t_thresh: float = 1e-4
    march_iters: int = 256  # train path: event budget == sample width S
    m_cap_per_ray: int = 32  # train path: eval capacity N * this
    infer_chunk_events: int = 16  # K sample slots per inference round
    infer_march_events: int = 32  # march events per round (0: same as K)
    infer_compact_factor: int = 4  # inference eval capacity N * K // this

    @property
    def march_cfg(self) -> MarchConfig:
        return MarchConfig(
            bound=self.bound,
            cascades=self.cascades,
            grid_size=self.grid_size,
            dt_gamma=self.dt_gamma,
            max_steps=self.max_steps,
            march_iters=self.march_iters,
        )


def train_capacity(n_rays: int, render_cfg: RenderConfig) -> int:
    """Samples the train path evaluates at most: the top of the JAX
    package's ladder {max(N*m/2, 2048), N*m}, with m = m_cap_per_ray."""
    base = n_rays * render_cfg.m_cap_per_ray
    return max(base, 2048)


def _aabb(bound, device):
    return torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                        device=device)


def _noises(N, perturb, noises, generator, device):
    if not perturb:
        return torch.zeros((N,), dtype=torch.float32, device=device)
    if noises is not None:
        return noises
    return torch.rand((N,), generator=generator, device=device)


def _background(rays_o, bg_color):
    """Per-ray background color [N, 3] (bg_radius > 0 is not ported)."""
    if bg_color is None:
        return torch.ones_like(rays_o)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=rays_o.device)
    return bg.expand(rays_o.shape)


def render_rays_train(net: NeRFNetwork, occupancy, rays_o, rays_d, *,
                      render_cfg: RenderConfig, bg_color=None,
                      perturb: bool = True, noises=None, generator=None):
    """Training-path rendering.

    Args:
      net: the NeRF network.
      occupancy: [CAS, H, H, H] uint8.
      rays_o, rays_d: [N, 3].
      bg_color: None (white), a scalar, or [N, 3].
      noises: optional [N] march perturbation in [0, 1); drawn from
        `generator` when perturb is set and it is not given.
    Returns:
      dict(image [N,3], depth [N], weights_sum [N], nears [N], fars [N],
           n_samples [N], ray_ok [N]).
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    cfg = render_cfg.march_cfg
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(cfg.bound, dev),
                                     render_cfg.min_near)
    noises = _noises(N, perturb, noises, generator, dev)
    # the march is index work: no gradient flows through it
    with torch.no_grad():
        march = march_rays_train(rays_o, rays_d, occupancy, nears, fars,
                                 noises, cfg)
    ts, dts, valid = march["ts"], march["dts"], march["valid"]
    S = cfg.march_iters

    xyz_flat = sample_positions(rays_o, rays_d, ts, cfg.bound).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(N, S, 3).reshape(-1, 3)

    m_cap = train_capacity(N, render_cfg)
    gather_idx, gather_mask, dest = compact_samples(valid, m_cap)
    n = int(gather_mask.sum())
    idx = gather_idx[:n]
    sigmas_c, rgbs_c = nerf_forward(net, gather_flat(xyz_flat, idx),
                                    gather_flat(dirs, idx))
    sigmas_c = sigmas_c * render_cfg.density_scale
    both = scatter_back(torch.cat([sigmas_c[:, None], rgbs_c], dim=1), dest,
                        (N, S), gather_idx=idx, gather_mask=gather_mask[:n])
    sigmas, rgbs = both[..., 0], both[..., 1:]
    # capacity-dropped samples are a per-ray suffix: composite the prefix
    valid_eval = valid & (dest < m_cap)
    ray_ok = ~torch.any(valid & (dest >= m_cap), dim=1)

    weights_sum, depth, image = composite_rays_train(
        sigmas, rgbs, dts, ts, valid_eval, march["t0"], render_cfg.t_thresh)
    image = image + (1.0 - weights_sum)[:, None] * _background(rays_o,
                                                               bg_color)
    return {
        "image": image,
        "depth": depth,
        "weights_sum": weights_sum,
        "nears": nears,
        "fars": fars,
        "n_samples": march["n_samples"],
        "ray_ok": ray_ok,
    }


def _march_round(event, t, fars, alive, K_slots: int, K_march: int):
    """March up to K_march events, packing occupied samples into K_slots
    per-ray slots. A ray that fills every slot freezes at the overflowing
    event (its t stays there) and resumes next round. With K_march <=
    K_slots this is the plain one-event-per-slot march.

    Returns (t_next [N], ts [N,Ks], dt [N,Ks], valid [N,Ks]).
    """
    N = t.shape[0]
    dev = t.device
    if K_march <= K_slots:
        ts_l, dt_l, occ_l = [], [], []
        for _ in range(K_slots):
            t_next, (ts_s, dt_s, occ) = event(t)
            done = t >= fars
            ts_l.append(ts_s)
            dt_l.append(dt_s)
            occ_l.append(occ & ~done)
            t = torch.where(done, t, t_next)
        return (t, torch.stack(ts_l, 1), torch.stack(dt_l, 1),
                torch.stack(occ_l, 1) & alive[:, None])

    slots = torch.arange(K_slots, dtype=torch.int32, device=dev)
    cnt = torch.zeros((N,), dtype=torch.int32, device=dev)
    ts_b = torch.zeros((N, K_slots), dtype=torch.float32, device=dev)
    dt_b = torch.zeros_like(ts_b)
    for _ in range(K_march):
        t_next, (ts_s, dt_s, occ) = event(t)
        done = t >= fars
        occ = occ & ~done & alive
        full = occ & (cnt >= K_slots)
        write = occ & ~full
        oh = (slots[None, :] == cnt[:, None]) & write[:, None]
        ts_b = torch.where(oh, ts_s[:, None], ts_b)
        dt_b = torch.where(oh, dt_s[:, None], dt_b)
        cnt = cnt + write.to(torch.int32)
        t = torch.where(done | full, t, t_next)
    return t, ts_b, dt_b, slots[None, :] < cnt[:, None]


def _eval_compacted(net, render_cfg: RenderConfig, rays_o, rays_d, ts,
                    valid, t_new, gather_table):
    """Evaluate the network only on the round's valid samples, at most
    N*K // infer_compact_factor of them (a factor <= 1 means no cap, which
    the JAX package runs as an uncompacted eval of the same numbers). Rays
    whose samples overflow the capacity rewind: the dropped samples are
    masked out of this round and t resumes at the first dropped one.

    Returns (sig [N,K], rgb [N,K,3], valid_eval [N,K], t_next [N]).
    """
    N, K = ts.shape
    m_cap = (N * K) // max(render_cfg.infer_compact_factor, 1)
    gather_idx, gather_mask, dest = compact_samples(valid, m_cap)
    n = int(gather_mask.sum())
    idx = gather_idx[:n]
    ray_ids = idx // K
    ts_c = gather_flat(ts.reshape(-1), idx)
    ro_c, rd_c = rays_o[ray_ids], rays_d[ray_ids]
    xyz_c = torch.clamp(ro_c + ts_c[:, None] * rd_c, -render_cfg.bound,
                        render_cfg.bound)
    sig_c, rgb_c = nerf_forward(net, xyz_c, rd_c, gather_table=gather_table)
    sig_c = sig_c * render_cfg.density_scale
    both = scatter_back(torch.cat([sig_c[:, None], rgb_c], dim=1), dest,
                        (N, K))
    sig, rgb = both[..., 0], both[..., 1:]
    dropped = valid & (dest >= m_cap)
    valid_eval = valid & (dest < m_cap)
    first_drop_ts = torch.amin(torch.where(dropped, ts, torch.inf), dim=1)
    t_next = torch.where(torch.any(dropped, dim=1), first_drop_ts, t_new)
    return sig, rgb, valid_eval, t_next


@torch.no_grad()
def render_rays_infer(net: NeRFNetwork, occupancy, rays_o, rays_d, *,
                      render_cfg: RenderConfig, bg_color=None,
                      perturb: bool = False, noises=None, generator=None,
                      skip_flat=None, gather_table=None):
    """Inference-path rendering as a host loop of march rounds.

    Rays die by transmittance; the loop ends when no ray is alive or after
    max_rounds = (max_steps // K) * infer_compact_factor rounds (rewinds
    consume rounds; the factor keeps the evaluated-sample budget at
    N * max_steps).

    skip_flat: optional prebuilt flat skip field (build_march_tables), so a
      frame's chunks share one. gather_table: optional pre-rounded encoder
      table (models/nerf.gather_table_for), likewise once per frame.
    Returns dict(image [N,3], depth [N], weights_sum [N], nears [N],
      fars [N], rounds).
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    cfg = render_cfg.march_cfg
    K = render_cfg.infer_chunk_events
    K_march = render_cfg.infer_march_events or K
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(cfg.bound, dev),
                                     render_cfg.min_near)
    noises = _noises(N, perturb, noises, generator, dev)
    t0 = nears + torch.clamp(nears * cfg.dt_gamma, cfg.dt_min,
                             cfg.dt_max) * noises
    if skip_flat is None:
        skip_flat = build_skip_field(occupancy, bound=cfg.bound).reshape(-1)
    event = make_march_event(rays_o, rays_d, skip_flat, cfg)

    t = t0
    acc = {
        "T": torch.ones((N,), dtype=torch.float32, device=dev),
        "ws": torch.zeros((N,), dtype=torch.float32, device=dev),
        "depth": torch.zeros((N,), dtype=torch.float32, device=dev),
        "rgb": torch.zeros((N, 3), dtype=torch.float32, device=dev),
    }
    max_rounds = (cfg.max_steps // K) * max(render_cfg.infer_compact_factor, 1)
    rounds = 0
    while rounds < max_rounds:
        alive = (acc["T"] >= render_cfg.t_thresh) & (t < fars)
        if not bool(torch.any(alive)):
            break
        t_new, ts, dt, valid = _march_round(event, t, fars, alive, K, K_march)
        sig, rgb, valid_e, t = _eval_compacted(
            net, render_cfg, rays_o, rays_d, ts, valid, t_new, gather_table)
        acc = composite_chunk(acc, sig, rgb, dt, ts, valid_e, t0,
                              render_cfg.t_thresh)
        rounds += 1

    image = acc["rgb"] + (1.0 - acc["ws"])[:, None] * _background(rays_o,
                                                                  bg_color)
    return {
        "image": image,
        "depth": acc["depth"],
        "weights_sum": acc["ws"],
        "nears": nears,
        "fars": fars,
        "rounds": rounds,
    }


def build_march_tables(occupancy, *, render_cfg: RenderConfig):
    """Per-frame flat chebyshev skip field, shared by a frame's chunks."""
    return build_skip_field(occupancy,
                            bound=render_cfg.march_cfg.bound).reshape(-1)
