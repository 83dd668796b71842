"""Parity of the port's stratified renderer (models/stratified.py) and
auxiliary losses (train/losses.py) with the JAX package's.

Tolerances: sample_pdf within 1e-5 (f32 cumsum and search on both sides;
random u is JAX's draw, passed to the port); render_rays_stratified
(deterministic: no perturbation, evenly spaced u) with the coarse pass
alone: image, weights_sum and depth within 2e-3 (bf16 network on both
sides, as in test_torch_trainer.py); with importance upsampling: image and
weights_sum within 5e-3, depth within 1e-2 relative, because the inverse
CDF turns a bf16 rounding of a coarse weight into a shift of the fine
samples; the three losses within 1e-6 relative, their gradients within
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, RENDER_CFG,
                           camera_rays, jax_params, port_net, t)
from laenerf_tpu.models import stratified as jstrat
from laenerf_tpu.train import losses as jlosses
from laenerf_tpu_torch.models import stratified as tstrat
from laenerf_tpu_torch.train import losses as tlosses


def _bins_weights(seed, B=6, T=17):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(0.5, 3.0, (B, T)), axis=1).astype(np.float32)
    w = rng.rand(B, T - 1).astype(np.float32)
    w[:, 5] += 4.0
    w[1] = 0.0  # all-zero weights: the 1e-5 floor makes it uniform
    return bins, w


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    bins, w = _bins_weights(0)
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jstrat.sample_pdf(key, jnp.asarray(bins),
                                       jnp.asarray(w), 32, det=det))
    u = None if det else t(jax.random.uniform(key, (bins.shape[0], 32)))
    got = tstrat.sample_pdf(t(bins), t(w), 32, det=det, u=u).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.all(got >= bins[:, :1] - 1e-6) and np.all(
        got <= bins[:, -1:] + 1e-6)


def test_render_rays_stratified_matches_jax():
    tree = jax_params(60)
    rays_o, rays_d = camera_rays(61, 96)
    params = jax.tree.map(jnp.asarray, tree)
    for upsample, tol, depth_rtol in ((0, 2e-3, 2e-3), (24, 5e-3, 1e-2)):
        ref = jstrat.render_rays_stratified(
            params, jnp.asarray(rays_o), jnp.asarray(rays_d),
            jax.random.PRNGKey(0), model_cfg=J_MODEL_CFG,
            render_cfg=J_RENDER_CFG, num_steps=32, upsample_steps=upsample,
            bg_color=1.0)
        got = tstrat.render_rays_stratified(
            port_net(tree), t(rays_o), t(rays_d), render_cfg=RENDER_CFG,
            num_steps=32, upsample_steps=upsample, bg_color=1.0)
        for k in ("image", "weights_sum", "nears", "fars"):
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(ref[k]), atol=tol,
                                       err_msg=k)
        np.testing.assert_allclose(got["depth"].detach().numpy(),
                                   np.asarray(ref["depth"]),
                                   rtol=depth_rtol, atol=2e-3)
        # the colour varies across the rays: not a flat background
        assert np.ptp(np.asarray(ref["image"]), axis=0).max() > 0.05


def test_render_rays_stratified_training_draws_and_grads():
    """Perturbed, training-mode rendering with injected draws is
    deterministic and differentiable into every parameter."""
    tree = jax_params(62)
    rays_o, rays_d = camera_rays(63, 32)
    rng = np.random.RandomState(64)
    jitter, u = t(rng.rand(32, 16)), t(rng.rand(32, 16))
    outs = []
    for _ in range(2):
        net = port_net(tree)
        out = tstrat.render_rays_stratified(
            net, t(rays_o), t(rays_d), render_cfg=RENDER_CFG, num_steps=16,
            upsample_steps=16, perturb=True, training=True, jitter=jitter,
            u=u)
        out["image"].sum().backward()
        outs.append(out["image"].detach())
        assert all(p.grad is not None and p.grad.abs().sum() > 0
                   for p in net.parameters())
    assert torch.equal(outs[0], outs[1])


def test_losses_match_jax():
    rng = np.random.RandomState(65)
    p = rng.randn(64).astype(np.float32)
    q = rng.randn(64).astype(np.float32)
    for name, kw in (("mape_loss", {}), ("huber_loss", {"delta": 0.3})):
        for red in ("mean", "none"):
            ref = np.asarray(getattr(jlosses, name)(
                jnp.asarray(p), jnp.asarray(q), reduction=red, **kw))
            got = getattr(tlosses, name)(t(p), t(q), reduction=red,
                                         **kw).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-6)
    w = (rng.rand(4, 12) * 0.2).astype(np.float32)
    m = np.sort(rng.rand(4, 12), axis=1).astype(np.float32)
    interval = (rng.rand(4, 12) * 0.05).astype(np.float32)
    for iv in (0.05, interval):
        ref, ref_g = jax.value_and_grad(jlosses.eff_distloss)(
            jnp.asarray(w), jnp.asarray(m), jnp.asarray(iv))
        wt = t(w).requires_grad_(True)
        got = tlosses.eff_distloss(wt, t(m), t(iv))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_g),
                                   atol=1e-5)
