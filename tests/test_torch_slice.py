"""Parity of the port's network, renderer and occupancy updates
(laenerf_tpu_torch/models) with the JAX package on the same parameters,
rays, occupancy grid and random draws.

Tolerances: the network in bf16 (2e-2 on rgb and on log sigma: bf16 matmul
outputs may round one ulp apart where the two frameworks sum in another
order); rendered images at 2e-3 (the bf16 noise averages out over a ray's
samples); occupancy density grids at 2e-2 relative with at most 0.1% of
cells thresholded differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, MODEL_CFG, RENDER_CFG,
                           blob_occupancy, camera_rays, jax_params, port_cfg,
                           port_net, t)
from laenerf_tpu.models import nerf as jnerf
from laenerf_tpu.models import occupancy as jocc
from laenerf_tpu.models import renderer as jren
from laenerf_tpu_torch.models import RenderConfig
from laenerf_tpu_torch.models import nerf as tnerf
from laenerf_tpu_torch.models import occupancy as tocc
from laenerf_tpu_torch.models import renderer as tren


def test_nerf_forward():
    tree = jax_params(0)
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    d = rng.randn(512, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sig_j, rgb_j = jnerf.nerf_forward(jax.tree.map(jnp.asarray, tree),
                                      J_MODEL_CFG, jnp.asarray(x),
                                      jnp.asarray(d))
    sig_t, rgb_t = tnerf.nerf_forward(port_net(tree), t(x), t(d))
    sig_j, rgb_j = np.asarray(sig_j), np.asarray(rgb_j)
    assert sig_t.shape == (512,) and rgb_t.shape == (512, 3)
    assert np.std(np.log(sig_j)) > 0.1  # the fixture spreads the density
    np.testing.assert_allclose(np.log(sig_t.detach().numpy()),
                               np.log(sig_j), atol=2e-2)
    np.testing.assert_allclose(rgb_t.detach().numpy(), rgb_j, atol=2e-2)


@pytest.mark.parametrize("m_cap_per_ray", [96, 16])  # 16: truncation
def test_render_rays_train(m_cap_per_ray):
    tree = jax_params(2)
    occ = blob_occupancy(3)
    ro, rd = camera_rays(4, 96)
    key = jax.random.PRNGKey(5)
    noises = np.asarray(jax.random.uniform(key, (ro.shape[0],)))
    bg = np.random.RandomState(6).rand(ro.shape[0], 3).astype(np.float32)
    jcfg = dataclasses.replace(J_RENDER_CFG, m_cap_per_ray=m_cap_per_ray)
    ref = jren.render_rays_train(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(occ), jnp.asarray(ro),
                                 jnp.asarray(rd), key, model_cfg=J_MODEL_CFG,
                                 render_cfg=jcfg, bg_color=jnp.asarray(bg))
    got = tren.render_rays_train(port_net(tree), t(occ), t(ro), t(rd),
                                 render_cfg=port_cfg(jcfg, RenderConfig),
                                 bg_color=t(bg), noises=t(noises))
    np.testing.assert_array_equal(got["ray_ok"].numpy(),
                                  np.asarray(ref["ray_ok"]))
    if m_cap_per_ray < 96:
        assert not got["ray_ok"].all()
    np.testing.assert_array_equal(got["n_samples"].numpy(),
                                  np.asarray(ref["n_samples"]))
    assert np.asarray(ref["weights_sum"]).max() > 0.5
    for k in ("image", "weights_sum"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=2e-3)


# 1: no cap (JAX evaluates uncompacted); 16: capacity overflow rewinds
@pytest.mark.parametrize("factor", [1, 4, 16])
def test_render_rays_infer(factor):
    tree = jax_params(7)
    occ = blob_occupancy(8)
    ro, rd = camera_rays(9, 128)
    jcfg = dataclasses.replace(J_RENDER_CFG, infer_compact_factor=factor)
    ref = jren.render_rays_infer(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(occ), jnp.asarray(ro),
                                 jnp.asarray(rd), jax.random.PRNGKey(0),
                                 model_cfg=J_MODEL_CFG, render_cfg=jcfg,
                                 bg_color=1.0)
    got = tren.render_rays_infer(port_net(tree), t(occ), t(ro), t(rd),
                                 render_cfg=port_cfg(jcfg, RenderConfig),
                                 bg_color=1.0)
    assert got["rounds"] == int(ref["rounds"])
    assert np.asarray(ref["weights_sum"]).max() > 0.5
    for k in ("image", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-3)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]),
                               atol=1e-2)


def _jax_density_fn(tree):
    params = jax.tree.map(jnp.asarray, tree)
    return lambda x: jnerf.nerf_density(params, J_MODEL_CFG, x)["sigma"]


def _port_density_fn(tree):
    net = port_net(tree)
    return lambda x: tnerf.nerf_density(net, x)["sigma"]


def _compare_states(got, ref):
    g = got.density_grid.numpy()
    r = np.asarray(ref.density_grid)
    np.testing.assert_allclose(g, r, rtol=2e-2, atol=1e-6)
    mism = np.mean(got.occupancy.numpy() != np.asarray(ref.occupancy))
    assert mism <= 1e-3, f"occupancy mismatch {mism:.2e}"
    np.testing.assert_allclose(float(got.mean_density),
                               float(ref.mean_density), rtol=2e-3)
    assert got.iter_density == int(ref.iter_density)


def _port_state(ref):
    return tocc.OccupancyState(
        density_grid=t(ref.density_grid), occupancy=t(ref.occupancy),
        mean_density=t(ref.mean_density), iter_density=int(ref.iter_density))


@pytest.mark.parametrize("cascades", [1, 2])
def test_update_occupancy_full_then_partial(cascades):
    """A full update from scratch, then a partial one (rotating sweep plus
    occupied window), with JAX's cell jitter injected into the port."""
    tree = jax_params(10, table_scale=0.3)
    H, bound = 32, float(2 ** (cascades - 1))
    state = jocc.occupancy_init(cascades, H)
    key = jax.random.PRNGKey(11)

    jitter, k = [], key
    for cas in range(cascades):
        k, sub = jax.random.split(k)
        half = min(2.0 ** cas, bound) / H
        jitter.append(t(jax.random.uniform(sub, (H ** 3, 3), minval=-half,
                                           maxval=half)))
    ref = jocc.update_occupancy(state, _jax_density_fn(tree), key,
                                bound=bound, full=True)
    got = tocc.update_occupancy(_port_state(state), _port_density_fn(tree),
                                bound=bound, full=True, jitter=jitter)
    _compare_states(got, ref)

    # the partial update from a mid-training state (phase and window start
    # away from zero)
    ref = dataclasses.replace(ref, iter_density=jnp.int32(19))
    key = jax.random.PRNGKey(12)
    n_rows = H ** 3 // 8 + max(H ** 3 // 16, 8)
    jitter, k = [], key
    for cas in range(cascades):
        k, k3 = jax.random.split(k)
        half = min(2.0 ** cas, bound) / H
        jitter.append(t(jax.random.uniform(k3, (n_rows, 3), minval=-half,
                                           maxval=half)))
    ref2 = jocc.update_occupancy(ref, _jax_density_fn(tree), key,
                                 bound=bound, full=False)
    got2 = tocc.update_occupancy(_port_state(ref), _port_density_fn(tree),
                                 bound=bound, full=False, jitter=jitter)
    _compare_states(got2, ref2)
    assert (np.asarray(ref2.density_grid) != np.asarray(
        ref.density_grid)).mean() > 0.05  # the partial update moved cells


def test_mark_untrained_grid():
    rng = np.random.RandomState(13)
    H, cas = 32, 2
    poses = []
    for k in range(5):
        ang = 2 * np.pi * k / 5
        eye = np.array([2.5 * np.cos(ang), 2.5 * np.sin(ang), 0.8])
        f = -eye / np.linalg.norm(eye)
        r = np.cross(f, [0.0, 0.0, 1.0])
        r /= np.linalg.norm(r)
        u = np.cross(r, f)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([r, -u, f], axis=1)
        pose[:3, 3] = eye
        poses.append(pose)
    poses = np.stack(poses).astype(np.float32)
    intr = (60.0, 60.0, 32.0, 32.0)
    grid = rng.rand(cas, H, H, H).astype(np.float32)
    ref = np.asarray(jocc.mark_untrained_grid(
        jnp.asarray(grid), jnp.asarray(poses), intr, bound=2.0,
        cascades=cas, grid_size=H))
    got = tocc.mark_untrained_grid(t(grid), t(poses), intr, bound=2.0,
                                   cascades=cas, grid_size=H).numpy()
    assert 0.01 < np.mean(ref == -1) < 0.95
    assert np.mean(got != ref) <= 1e-4
