"""Parity of the port's train step and full-image render
(laenerf_tpu_torch/train/trainer.py) with the JAX package's.

The random background and march noises of each step are JAX's own draws
(train_step splits its key into k_bg, k_render, k_next; render_rays_train
draws the noises from k_render), handed to the port as tensors.

Tolerances: losses at 2e-2 relative. The step-1 gradient of every
parameter leaf norm-wise (||port - JAX|| / ||JAX||) within a bound the
test derives from a rounding control:
  * The two sides' rays differ by float32 rounding only (get_rays rounds
    its products and norm differently: a third of the directions' entries
    one ulp apart); every later stage, fed the same inputs and cotangents,
    agrees to float32 rounding (the MLPs bit for bit), the table gradient
    also by JAX's bf16 view rounding (see test_torch_hashgrid.py).
  * JAX's own gradient is not stable under such a rounding: the finest
    grid level scales a position's last bit by ~2^11 into the
    interpolation weights, and the bf16 roundings of the MLPs'
    activations and cotangents then land on the other side of a boundary
    here and there. With its rays moved one ulp it moves by up to 2.9% of
    a leaf's largest entry and ~1% norm-wise.
  * So the control is JAX's gradient with rays_o, then rays_d, moved one
    float32 ulp up and down (_torch_parity.ulp_moves), and each leaf's
    error must be within twice the largest of the four controls' errors
    (_torch_parity.rounding_bound). The norm is the measure because a
    rounding flips few entries while a fault moves them all: skipping the
    table's bf16 rounding before the gather, or dropping each ray's last
    sample, exceeds the bound.
Parameters after Adam are not compared: with eps 1e-15 the first update
is about lr * sign(g), so one bf16 sign flip moves an entry by a whole
lr. The rendered image at 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, MODEL_CFG, RENDER_CFG,
                           blob_occupancy, jax_params, norm_err, port_net,
                           rounding_bound, t, ulp_moves)
from laenerf_tpu.models import renderer as jren
from laenerf_tpu.train import trainer as jtrain
from laenerf_tpu_torch.convert import params_from_jax, params_to_numpy
from laenerf_tpu_torch.train import trainer as ttrain

H = W = 16
N_RAYS = 128


def _camera(dist=2.4):
    eye = np.array([0.4, -0.5, -dist], np.float32)
    f = -eye / np.linalg.norm(eye)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    u = np.cross(f, r)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([r, u, f], axis=1)
    pose[:3, 3] = eye
    return pose, np.array([14.0, 14.0, W / 2, H / 2], np.float32)


def _batches(n):
    rng = np.random.RandomState(30)
    out = []
    for _ in range(n):
        inds = rng.randint(0, H * W, N_RAYS).astype(np.int32)
        px = rng.rand(N_RAYS, 4).astype(np.float32)
        px[:, 3] = (px[:, 3] > 0.4).astype(np.float32)
        out.append((inds, px))
    return out


def _jax_loss_fn(occ, rays_o, rays_d, gt, bg, k_render):
    def loss_fn(params):
        out = jren.render_rays_train(params, occ, rays_o, rays_d, k_render,
                                     model_cfg=J_MODEL_CFG,
                                     render_cfg=J_RENDER_CFG, bg_color=bg,
                                     perturb=True)
        return jnp.mean(jnp.mean((out["image"] - gt) ** 2, axis=-1))
    return loss_fn


def test_train_steps_loss_and_grads():
    tree = jax_params(20, table_scale=0.2)
    occ = blob_occupancy(21)
    pose, intr = _camera()
    batches = _batches(3)
    lr, iters = 1e-2, 100

    opt = jtrain.make_optimizer(lr, iters)
    params = jax.tree.map(jnp.asarray, tree)
    state = jtrain.TrainState(params=params, opt_state=opt.init(params),
                              ema_params=jax.tree.map(jnp.array, params),
                              step=jnp.zeros((), jnp.int32))
    net, ema = port_net(tree), port_net(tree).requires_grad_(False)
    topt, tsched = ttrain.make_optimizer(net.parameters(), lr, iters)

    losses_j, losses_t = [], []
    for i, (inds, px) in enumerate(batches):
        key = jax.random.PRNGKey(40 + i)
        k_bg, k_render, _ = jax.random.split(key, 3)
        bg = np.asarray(jax.random.uniform(k_bg, (N_RAYS, 3)))
        noises = np.asarray(jax.random.uniform(k_render, (N_RAYS,)))
        if i == 0:
            rays_o, rays_d = jtrain.get_rays(
                jnp.asarray(pose), jnp.asarray(intr), jnp.asarray(inds), H, W)
            gt = px[:, :3] * px[:, 3:] + bg * (1.0 - px[:, 3:])
            ref_leaves, *controls = [
                [np.asarray(g) for g in jax.tree.leaves(jax.grad(
                    _jax_loss_fn(jnp.asarray(occ), jnp.asarray(ro),
                                 jnp.asarray(rd), jnp.asarray(gt),
                                 jnp.asarray(bg), k_render))(state.params))]
                for ro, rd in [(rays_o, rays_d)] + ulp_moves(rays_o, rays_d)]
        state, aux = jtrain.train_step(
            state, jnp.asarray(occ), jnp.asarray(pose), jnp.asarray(intr),
            jnp.asarray(inds), jnp.asarray(px), key, model_cfg=J_MODEL_CFG,
            render_cfg=J_RENDER_CFG, optimizer=opt, ema_decay=0.95,
            has_alpha=True, bg_white=False, H=H, W=W)
        losses_j.append(float(aux["loss"]))
        aux_t = ttrain.train_step(
            net, ema, topt, tsched, t(occ), t(pose), t(intr),
            t(inds, torch.int64), t(px), render_cfg=RENDER_CFG,
            ema_decay=0.95, has_alpha=True, bg_white=False, H=H, W=W,
            bg=t(bg), noises=t(noises))
        losses_t.append(float(aux_t["loss"]))
        if i == 0:
            grads_t = {"encoder": net.encoder.grad.numpy()}
            for name in ("sigma_net", "color_net"):
                grads_t[name] = [lin.weight.grad.numpy().T
                                 for lin in getattr(net, name).layers]
            got_leaves = jax.tree.leaves(grads_t)
            assert len(ref_leaves) == len(got_leaves) == 6
            for k, (g, r) in enumerate(zip(got_leaves, ref_leaves)):
                assert np.abs(r).max() > 0
                err = norm_err(g, r)
                bound = rounding_bound(r, [c[k] for c in controls])
                print(f"leaf {k}: step-1 grad error {err:.3e}, bound "
                      f"{bound:.3e}")
                assert err <= bound, f"leaf {k}: {err:.3e} > {bound:.3e}"

    print("losses jax", losses_j, "port", losses_t)
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-2)
    assert tsched.get_last_lr()[0] == lr * 0.1 ** (3 / iters)
    # the EMA moved off the initial params, toward the trained ones
    e0 = port_net(tree).sigma_net.layers[0].weight
    e1, p1 = ema.sigma_net.layers[0].weight, net.sigma_net.layers[0].weight
    assert 0 < (e1 - e0).abs().max() < (p1 - e0).abs().max()


def test_render_image_matches_jax(tmp_path):
    tree = jax_params(22)
    occ = blob_occupancy(23)
    pose, intr = _camera(2.2)
    size = 32
    intr = intr * (size / H)
    rcfg_j = dataclasses.replace(J_RENDER_CFG, infer_chunk_events=16)
    tr_j = jtrain.Trainer(str(tmp_path / "ws"), J_MODEL_CFG, rcfg_j,
                          eval_chunk=384)
    params = jax.tree.map(jnp.asarray, tree)
    tr_j.state = dataclasses.replace(tr_j.state, ema_params=params)
    tr_j.occ_state = dataclasses.replace(tr_j.occ_state,
                                         occupancy=jnp.asarray(occ))
    img_j, depth_j = tr_j.render_image(pose, intr, size, size)

    tr_t = ttrain.Trainer(MODEL_CFG, dataclasses.replace(
        RENDER_CFG, infer_chunk_events=16), device="cpu", eval_chunk=384)
    tr_t.ema_net.load_state_dict(params_from_jax(tree))
    tr_t.occ_state.occupancy = t(occ)
    img_t, depth_t = tr_t.render_image(pose, intr, size, size)

    assert img_t.shape == (size, size, 3) and depth_t.shape == (size, size)
    assert np.std(img_j) > 0.02  # something is in view
    np.testing.assert_allclose(img_t, img_j, atol=2e-3)
    # the parameter conversion round-trips
    back = params_to_numpy(tr_t.ema_net)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_trainer_trains_on_cpu():
    """The port's Trainer drives mark_untrained, occupancy refreshes (full,
    then partial) and train steps end to end on a tiny scene."""
    from laenerf_tpu_torch.data import NeRFDataset, generate_synthetic_scene
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_scene(tmp, n_train=4, n_val=1, n_test=1, H=16,
                                 W=16, device="cpu")
        ds = NeRFDataset(tmp, "train", num_rays=256)
    rcfg = dataclasses.replace(RENDER_CFG, m_cap_per_ray=16,
                               density_thresh=10.0)
    tr = ttrain.Trainer(MODEL_CFG, rcfg, device="cpu", lr=1e-2, iters=100,
                        update_interval=2)
    tr.mark_untrained(ds)
    assert (tr.occ_state.density_grid == -1).any()
    losses = []
    for step in range(36):
        aux = tr.train_one_batch(ds.get_batch(step % len(ds)),
                                 has_alpha=True)
        losses.append(float(aux["loss"]))
    assert tr.occ_state.iter_density == 18  # 16 full updates, 2 partial
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-6:]) < np.mean(losses[:6])


def test_entry_points_default_to_the_card(tmp_path):
    """Trainer and generate_synthetic_scene run on the card unless the
    caller asks for the CPU; without a GPU they raise, never fall back."""
    import inspect

    import pytest

    from laenerf_tpu_torch.data import generate_synthetic_scene

    for fn in (ttrain.Trainer, generate_synthetic_scene):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        ttrain.Trainer(MODEL_CFG, RENDER_CFG)
    with pytest.raises((RuntimeError, AssertionError)):
        generate_synthetic_scene(str(tmp_path), n_train=1, n_val=0, n_test=0,
                                 H=4, W=4)
