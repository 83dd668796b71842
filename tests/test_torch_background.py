"""Parity of the port's background network and the generic hash-grid path
(laenerf_tpu_torch/ops/hashgrid.py, ops/freq.py, ops/raymarch.py::
sph_from_ray, models/nerf.py::nerf_background, the renderers with
bg_radius > 0, checkpoints with encoder_bg) with the JAX package's, on the
CPU.

Tolerances: the generic grid's forward at 1e-5 relative to the largest
feature and its table gradient (the port's plain K1 version, a 1-D idx of
B * L * 2^D rows, against JAX's _gather_rows backward) at 1e-5 relative
(with a bf16 gather, within half a bf16 ulp of each element: JAX rounds
each table row's sum to bf16, the port keeps it in f32);
the TV loss, freq_encode and sph_from_ray at 1e-5; the background network
and rendered images at 2e-2 and 2e-3 absolute (bf16 MLPs on both sides,
as tests/test_torch_slice.py); gradients of a render at 2e-2 of each
leaf's largest element (as tests/test_torch_trainer.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, blob_occupancy,
                           camera_rays, jax_params, max_rel_err, port_cfg, t)
from laenerf_tpu.models import nerf as jnerf
from laenerf_tpu.models import renderer as jren
from laenerf_tpu.ops import freq as jfreq
from laenerf_tpu.ops import hashgrid as jhash
from laenerf_tpu.ops import raymarch as jmarch
from laenerf_tpu_torch.convert import params_from_jax, params_to_numpy
from laenerf_tpu_torch.models import NeRFConfig, RenderConfig
from laenerf_tpu_torch.models import nerf as tnerf
from laenerf_tpu_torch.models import renderer as tren
from laenerf_tpu_torch.ops import freq as tfreq
from laenerf_tpu_torch.ops import hashgrid as thash
from laenerf_tpu_torch.ops import raymarch as tmarch

J_BG_CFG = dataclasses.replace(J_MODEL_CFG, bg_radius=4.0)
BG_CFG = port_cfg(J_BG_CFG, NeRFConfig)
RENDER_CFG = port_cfg(J_RENDER_CFG, RenderConfig)

# (input_dim, interpolation, log2_hashmap_size): 2-D with dense and hashed
# levels (the background's spec), 2-D all hashed but one, 3-D all hashed,
# 3-D dense then hashed
GRIDS = [(2, "linear", 19), (2, "smoothstep", 10), (3, "linear", 12),
         (3, "smoothstep", 19)]


def _specs(D, interp, lg, gather_dtype="f32"):
    kw = dict(desired_resolution=2048, input_dim=D, num_levels=4,
              level_dim=2, base_resolution=16, log2_hashmap_size=lg,
              interpolation=interp, gather_dtype=gather_dtype)
    return (jhash.HashGridSpec.create(**kw),
            thash.HashGridSpec.create(octo_gather=False, **kw))


@pytest.mark.parametrize("D,interp,lg", GRIDS)
def test_generic_spec_math(D, interp, lg):
    js, ts = _specs(D, interp, lg)
    for f in ("level_scales", "level_resolutions", "level_sizes",
              "level_offsets", "table_rows", "output_dim"):
        assert getattr(ts, f) == getattr(js, f), f
    dense = [r + 1 for r in js.level_resolutions]
    hashed = [b ** D > s for b, s in zip(dense, js.level_sizes)]
    if (D, lg) in ((2, 19), (3, 19)):
        assert hashed[0] is False and hashed[-1] is True


@pytest.mark.parametrize("gather_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D,interp,lg", GRIDS)
def test_generic_encode_and_table_gradient(D, interp, lg, gather_dtype):
    js, ts = _specs(D, interp, lg, gather_dtype)
    rng = np.random.RandomState(D * 100 + lg)
    tbl = rng.uniform(-1, 1, (js.table_rows, 2)).astype(np.float32)
    x = rng.uniform(-1.1, 1.1, (700, D)).astype(np.float32)  # some outside
    cot = rng.randn(700, js.output_dim).astype(np.float32)

    def f(table):
        return jnp.sum(jhash.hashgrid_encode(table, jnp.asarray(x), js)
                       * cot)

    out_j = np.asarray(jhash.hashgrid_encode(jnp.asarray(tbl),
                                             jnp.asarray(x), js))
    grad_j = np.asarray(jax.grad(f)(jnp.asarray(tbl)))
    tt = t(tbl).requires_grad_(True)
    out_t = thash.hashgrid_encode(tt, t(x), ts)
    (out_t * t(cot)).sum().backward()
    assert out_t.shape == (700, js.output_dim)
    assert max_rel_err(out_t.detach().numpy(), out_j) < 1e-5
    got = tt.grad.numpy()
    if gather_dtype == "f32":
        assert max_rel_err(got, grad_j) < 1e-5
    else:  # JAX rounds each row's sum to bf16 once; the port keeps f32
        bound = 2.0 ** -8 * np.abs(grad_j) + 1e-6 * np.abs(grad_j).max()
        assert np.all(np.abs(got - grad_j) <= bound)
    assert np.all(out_j[np.any(np.abs(x) > 1, axis=1)] == 0)


def test_generic_backward_passes_k1_a_flat_idx(monkeypatch):
    """The background grid's backward hands K1 one 1-D idx of B * L * 4
    rows (the JAX package's _gather_rows layout) of f32 rows."""
    seen = []
    real = thash.scatter_add_rows

    def spy(idx, g, rows, **kw):
        seen.append((tuple(idx.shape), tuple(g.shape), g.dtype,
                     kw.get("precision"), rows))
        return real(idx, g, rows, **kw)

    monkeypatch.setattr(thash, "scatter_add_rows", spy)
    spec = BG_CFG.bg_grid_spec
    tt = torch.zeros((spec.table_rows, 2), requires_grad=True)
    x = torch.rand((64, 2)) * 2 - 1
    thash.hashgrid_encode(tt, x, spec).sum().backward()
    assert seen == [((64 * 4 * 4,), (64 * 4 * 4, 2), torch.float32, "f32",
                     spec.table_rows)]


def test_tv_loss():
    for D, interp, lg in GRIDS:
        js, ts = _specs(D, interp, lg)
        rng = np.random.RandomState(D + lg)
        tbl = rng.uniform(-1, 1, (js.table_rows, 2)).astype(np.float32)
        x = rng.uniform(-1, 1, (400, D)).astype(np.float32)

        def f(table):
            return jhash.hashgrid_tv_loss(table, None, js,
                                          inputs=jnp.asarray(x))

        loss_j, grad_j = jax.value_and_grad(f)(jnp.asarray(tbl))
        tt = t(tbl).requires_grad_(True)
        loss_t = thash.hashgrid_tv_loss(tt, ts, t(x))
        loss_t.backward()
        np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                                   rtol=1e-5)
        assert max_rel_err(tt.grad.numpy(), grad_j) < 1e-5
    # drawn points: a positive loss with a gradient
    g = torch.Generator().manual_seed(0)
    tt = t(tbl).requires_grad_(True)
    loss = thash.hashgrid_tv_loss(tt, ts, n_points=256, generator=g)
    loss.backward()
    assert float(loss) > 0 and float(tt.grad.abs().sum()) > 0


@pytest.mark.parametrize("degree", [0, 2, 6])
def test_freq_encode(degree):
    x = np.random.RandomState(degree).uniform(-3, 3, (5, 7, 3)).astype(
        np.float32)
    ref = np.asarray(jfreq.freq_encode(jnp.asarray(x), degree))
    got = tfreq.freq_encode(t(x), degree).numpy()
    assert got.shape[-1] == tfreq.freq_output_dim(3, degree) \
        == jfreq.freq_output_dim(3, degree)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_sph_from_ray():
    ro, rd = camera_rays(11, 300, spread=3.0)
    ref = np.asarray(jmarch.sph_from_ray(jnp.asarray(ro), jnp.asarray(rd),
                                         4.0))
    got = tmarch.sph_from_ray(t(ro), t(rd), 4.0).numpy()
    assert got.shape == (300, 2) and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=1e-5)


def bg_params(seed):
    """JAX-layout params of the background model: jax_params plus a
    spread encoder_bg and bg_net."""
    tree = jax_params(seed)
    init = jnerf.nerf_init(jax.random.PRNGKey(seed), J_BG_CFG)
    rng = np.random.RandomState(seed + 1)
    tree["encoder_bg"] = rng.uniform(
        -0.5, 0.5, init["encoder_bg"].shape).astype(np.float32)
    tree["bg_net"] = [2.0 * np.asarray(w) for w in init["bg_net"]]
    return tree


def bg_net(tree):
    net = tnerf.nerf_init(BG_CFG, device="cpu")
    net.load_state_dict(params_from_jax(tree))
    return net


def test_background_network_builds():
    assert BG_CFG.bg_grid_spec.level_sizes == \
        J_BG_CFG.bg_grid_spec.level_sizes
    net = tnerf.nerf_init(BG_CFG, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    init = jnerf.nerf_init(jax.random.PRNGKey(0), J_BG_CFG)
    tree = params_to_numpy(net)
    assert sorted(tree) == sorted(init)
    for k in init:
        for a, b in zip(jax.tree.leaves(tree[k]), jax.tree.leaves(init[k])):
            assert a.shape == np.shape(b), k
    assert tree["encoder_bg"].shape == (697776, 2)


def test_nerf_background():
    tree = bg_params(20)
    ro, rd = camera_rays(21, 256, spread=3.0)
    sph = np.asarray(jmarch.sph_from_ray(jnp.asarray(ro), jnp.asarray(rd),
                                         4.0))
    ref = np.asarray(jnerf.nerf_background(jax.tree.map(jnp.asarray, tree),
                                           J_BG_CFG, jnp.asarray(sph),
                                           jnp.asarray(rd)))
    got = tnerf.nerf_background(bg_net(tree), t(sph), t(rd))
    assert np.std(ref) > 0.05
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-2)


def test_render_rays_train_with_background():
    tree = bg_params(22)
    occ = blob_occupancy(23)
    ro, rd = camera_rays(24, 128, spread=1.5)
    key = jax.random.PRNGKey(25)
    noises = np.asarray(jax.random.uniform(key, (ro.shape[0],)))

    def loss_j(p):
        out = jren.render_rays_train(p, jnp.asarray(occ), jnp.asarray(ro),
                                     jnp.asarray(rd), key,
                                     model_cfg=J_BG_CFG,
                                     render_cfg=J_RENDER_CFG)
        return jnp.mean(out["image"] ** 2), out

    (_, ref), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    net = bg_net(tree)
    got = tren.render_rays_train(net, t(occ), t(ro), t(rd),
                                 render_cfg=RENDER_CFG, noises=t(noises))
    torch.mean(got["image"] ** 2).backward()
    ws = np.asarray(ref["weights_sum"])
    assert ws.min() < 0.5 < ws.max()  # some rays show the background
    for k in ("image", "weights_sum"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=2e-3)
    for name in ("encoder", "encoder_bg"):
        assert max_rel_err(getattr(net, name).grad.numpy(),
                           grads_j[name]) < 2e-2, name
    for name in ("sigma_net", "color_net", "bg_net"):
        for lin, r in zip(getattr(net, name).layers, grads_j[name]):
            assert max_rel_err(lin.weight.grad.numpy().T, r) < 2e-2, name


def test_render_rays_infer_with_background():
    tree = bg_params(26)
    occ = blob_occupancy(27)
    ro, rd = camera_rays(28, 128, spread=1.5)
    ref = jren.render_rays_infer(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(occ), jnp.asarray(ro),
                                 jnp.asarray(rd), jax.random.PRNGKey(0),
                                 model_cfg=J_BG_CFG, render_cfg=J_RENDER_CFG,
                                 bg_color=1.0)
    got = tren.render_rays_infer(bg_net(tree), t(occ), t(ro), t(rd),
                                 render_cfg=RENDER_CFG, bg_color=1.0)
    ws = np.asarray(ref["weights_sum"])
    assert ws.min() < 0.5 < ws.max()
    assert np.abs(np.asarray(ref["image"])[ws < 0.5] - 1.0).max() > 0.1
    for k in ("image", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-3)


def test_trainer_with_background_trains_and_renders(tmp_path):
    """NeRFConfig(bg_radius=4.0) builds, trains (the background table gets
    gradient) and renders on the CPU; a JAX Trainer's checkpoint with
    encoder_bg loads into the port under the JAX keystr names."""
    from laenerf_tpu.train import checkpoints as jckpt
    from laenerf_tpu.train import trainer as jtrain
    from laenerf_tpu_torch.convert import load_jax_checkpoint
    from laenerf_tpu_torch.train import Trainer

    tree = bg_params(30)
    occ = blob_occupancy(31)
    tr_j = jtrain.Trainer(str(tmp_path / "jws"), J_BG_CFG, J_RENDER_CFG)
    params = jax.tree.map(jnp.asarray, tree)
    tr_j.state = dataclasses.replace(
        tr_j.state, params=params, ema_params=params,
        opt_state=tr_j.optimizer.init(params), step=jnp.int32(3))
    tr_j.occ_state = dataclasses.replace(
        tr_j.occ_state, occupancy=jnp.asarray(occ),
        density_grid=jnp.asarray(occ.astype(np.float32)),
        mean_density=jnp.float32(0.3), iter_density=jnp.int32(20))
    path = str(tmp_path / "jax_bg.npz")
    jckpt.save_pytree(path, {"state": tr_j.state, "occ": tr_j.occ_state},
                      {"global_step": 3})
    ck = load_jax_checkpoint(path)
    assert "encoder_bg" in ck["params"] and "bg_net.layers.1.weight" in \
        ck["params"]

    tr = Trainer(BG_CFG, RENDER_CFG, device="cpu", iters=50,
                 workspace=str(tmp_path / "tws"))
    assert tr.load_checkpoint(path) and tr.global_step == 3
    torch.testing.assert_close(tr.ema_net.encoder_bg,
                               torch.tensor(tree["encoder_bg"]))
    pose = np.array([[1.0, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, -2.5],
                     [0, 0, 0, 1.0]], np.float32)
    intr = np.array([10.0, 10.0, 8.0, 8.0], np.float32)
    img_j, _ = tr_j.render_image(pose, intr, 16, 16)
    img_t, _ = tr.render_image(pose, intr, 16, 16)
    np.testing.assert_allclose(img_t, img_j, atol=2e-3)

    rng = np.random.RandomState(32)
    before = tr.net.encoder_bg.detach().clone()
    for _ in range(2):
        px = rng.rand(128, 4).astype(np.float32)
        aux = tr.train_one_batch(
            {"pose": pose, "intrinsics": intr, "H": 16, "W": 16,
             "inds": rng.randint(0, 256, 128).astype(np.int32),
             "pixels": px}, has_alpha=True)
        assert np.isfinite(float(aux["loss"]))
    assert not torch.equal(before, tr.net.encoder_bg.detach())
    img, _ = tr.render_image(pose, intr, 16, 16)
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
    # the port's checkpoint carries the background back to the JAX keys
    back, _ = jckpt.load_pytree(tr.save_checkpoint(),
                                {"state": tr_j.state, "occ": tr_j.occ_state})
    np.testing.assert_array_equal(
        np.asarray(back["state"].params["encoder_bg"]),
        tr.net.encoder_bg.detach().numpy())
