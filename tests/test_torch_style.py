"""Parity of the port's style mode with the JAX package's: StyleNetwork
(its seeded crop, Gram targets, loss, guided loss and preserve_color
targets), the LAENeRF step with the Gram term past warm-up, and
EditPipeline(mode="style") end to end on a tiny CPU scene. Both packages
draw the same random VGG-19 filters (no weights npz).

Tolerances (bounds on the error):
  * the style crop's Gram targets and the colour-matched ones: <= 1e-4 *
    max |JAX| per layer (f32 convolutions summed in another order).
  * StyleNetwork.__call__ and guided_loss: |port - JAX| <= 1e-4 * |JAX|.
  * laenerf_train_step with style_weight > 0 past warm-up, from the same
    params and batch, the crop shrunk or enlarged to crop_size: the loss
    and the MSE
    at 1e-3 relative; the gradients of test_torch_editing.py's step test
    (encoder 1e-2 of its max, palette and MLPs 2e-2; bf16 MLPs, rows
    summed in another order).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from _torch_parity import max_rel_err, t, tiny_scene_trainer
from laenerf_tpu.editing import style as jstyle
from laenerf_tpu.editing import style_trainer as jst
from laenerf_tpu.editing import vgg as jvgg
from laenerf_tpu_torch.editing import style as tstyle
from laenerf_tpu_torch.editing import style_trainer as tst
from laenerf_tpu_torch.editing import vgg as tvgg
from test_torch_editing import (CROP, H, J_LCFG, W, laenerf_tree, port_model,
                                train_batch)

LAYERS = (10, 12, 14)


@pytest.fixture(autouse=True)
def no_vgg_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("LAENERF_VGG19_NPZ", raising=False)
    monkeypatch.setattr(tvgg, "_WEIGHTS_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(jvgg, "_WEIGHTS_DIR", str(tmp_path / "none"))


def wave(h=72, w=88):
    """The recolor gate's procedural wave style image, [3, h, w]."""
    yy, xx = np.mgrid[0:h, 0:w] / float(max(h, w))
    v = 0.5 + 0.5 * np.sin(12 * xx + 5 * np.sin(6 * yy))
    return np.stack([v, 0.4 + 0.5 * v ** 2, 0.9 - 0.6 * v]).astype(
        np.float32)


def networks(size, preserve_color=False, img=None):
    img = wave() if img is None else img
    with pytest.warns(UserWarning, match="random filters"):
        j = jstyle.StyleNetwork(img, style_layers=LAYERS, size=size,
                                preserve_color=preserve_color, seed=3)
    with pytest.warns(UserWarning, match="random filters"):
        p = tstyle.StyleNetwork(img, style_layers=LAYERS, size=size,
                                preserve_color=preserve_color, seed=3,
                                device="cpu")
    return j, p


def _assert_grams(got, ref):
    assert len(got) == len(ref) == len(LAYERS)
    for g, r in zip(got, ref):
        assert max_rel_err(g.numpy(), r) <= 1e-4


@pytest.mark.parametrize("size", [48, 96])  # 96 pads the 72x88 image
def test_style_network_matches_jax(size):
    j, p = networks(size)
    # the same seeded crop: the RandomState draws agree
    assert j.rng.randint(1 << 30) == p.rng.randint(1 << 30)
    _assert_grams(p.gram_style, j.gram_style)
    rng = np.random.RandomState(size)
    for shape in ((3, 40, 52), (3, 120, 100)):  # resized up and down
        img = rng.rand(*shape).astype(np.float32)
        ref = float(j(jnp.asarray(img)))
        got = float(p(t(img)))
        assert abs(got - ref) <= 1e-4 * abs(ref), (shape, got, ref)
        guide = rng.rand(*shape[1:]).astype(np.float32)
        ref = float(j.guided_loss(jnp.asarray(img), jnp.asarray(guide)))
        got = float(p.guided_loss(t(img), t(guide)))
        assert abs(got - ref) <= 1e-4 * abs(ref), (shape, got, ref)


def test_preserve_color_targets_match_jax():
    j, p = networks(48, preserve_color=True)
    assert p.targets is p.gram_style  # until a colour target is set
    target = (0.2 + 0.3 * np.random.RandomState(8).rand(3, 30, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(p.set_color_target(target),
                                  j.set_color_target(target))
    _assert_grams(p.gram_color, j.gram_color)
    assert p.targets is p.gram_color
    img = np.random.RandomState(9).rand(3, 48, 48).astype(np.float32)
    ref, got = float(j(jnp.asarray(img))), float(p(t(img)))
    assert abs(got - ref) <= 1e-4 * abs(ref)


@pytest.mark.parametrize("crop_size", [12, 24])  # the crop shrunk, enlarged
def test_train_step_with_gram_loss_matches_jax(crop_size):
    j, p = networks(crop_size)
    tree = laenerf_tree(8, table_scale=0.2)
    batch = train_batch()
    active = np.array([True, True, True, False])
    weights = tst.StyleLossWeights(
        style_weight=5e4, tv_weight=1e-2, depth_disc_weight=1e-2,
        offset_loss=1e-3, weight_loss_non_uniform=1e-3,
        palette_loss_valid=1e-1, tv_depth_guide=True, warmup_iterations=0)
    jweights = jst.StyleLossWeights(**vars(weights))
    scale = 1e3
    opt = optax.scale(scale)
    params = jax.tree.map(jnp.asarray, tree)
    jkw = dict(cfg=J_LCFG, weights=jweights, optimizer=opt, H=H, W=W,
               crop_h=CROP, crop_w=CROP, use_style=True, past_warmup=True,
               vgg_params=j.params, vgg_kinds=tuple(j.kinds),
               style_layers=j.style_layers, gram_targets=j.gram_style,
               crop_size=crop_size)
    new, _, aux_j = jst.laenerf_train_step(
        params, opt.init(params), jnp.asarray(active),
        jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0), **jkw)
    grads_j = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                           / scale, new, params)
    # the Gram term is a large part of the loss
    _, _, no_style = jst.laenerf_train_step(
        params, opt.init(params), jnp.asarray(active),
        jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0),
        **dict(jkw, use_style=False))
    assert float(aux_j["loss"]) - float(no_style["loss"]) > \
        0.2 * abs(float(aux_j["loss"]))

    model = port_model(tree)
    aux_t = tst.laenerf_train_step(
        model, tst.make_style_optimizer(model), t(active),
        {k: t(v) for k, v in batch.items()}, weights=weights, H=H, W=W,
        crop_h=CROP, crop_w=CROP, past_warmup=True, style_network=p,
        gram_targets=p.targets, crop_size=crop_size)
    for k in ("loss", "mse"):
        ref, got = float(aux_j[k]), float(aux_t[k])
        assert abs(got - ref) <= 1e-3 * abs(ref), (k, got, ref)
    grads_t = {"encoder": model.encoder.grad.numpy(),
               "palette": model.palette.grad.numpy()}
    for name in ("weight_net", "offset_net"):
        grads_t[name] = [lin.weight.grad.numpy().T
                         for lin in getattr(model, name).layers]
    for name, tol in (("encoder", 1e-2), ("palette", 2e-2),
                      ("weight_net", 2e-2), ("offset_net", 2e-2)):
        for g, r in zip(jax.tree.leaves(grads_t[name]),
                        jax.tree.leaves(grads_j[name])):
            assert np.abs(r).max() > 0, name
            err = max_rel_err(g, r)
            assert err < tol, f"{name}: grad error {err:.3e}"
    # the VGG stays frozen
    assert all(q is None or not q[0].requires_grad for q in p.params)


@pytest.mark.parametrize("preserve_color", [False, True])
def test_style_run_all_on_cpu(tmp_path, preserve_color):
    """EditPipeline(mode="style") end to end: the tiny scene's region, the
    gate's style weights with steps and sizes cut, the Gram term past
    warm-up, distillation, the depth-supervised fine-tune and eval."""
    from laenerf_tpu_torch.editing import EditGrid, StyleLossWeights
    from laenerf_tpu_torch.pipeline import (EditPipeline, PipelineConfig,
                                            project_points)

    tr, ds, test = tiny_scene_trainer(tmp_path)
    pts = project_points(tr, ds.poses[0], ds.intrinsics,
                         [[ds.W // 2, ds.H // 2]], ds.H, ds.W)
    density = tr.occ_state.density_grid.numpy()
    thresh = min(float(tr.occ_state.mean_density), 0.01)
    eg = EditGrid(1, tr.render_cfg.grid_size)
    eg.new_from_points(pts)
    eg.grow_region_queue(density, thresh, grow_iterations=2000)
    grow = EditGrid(1, tr.render_cfg.grid_size)
    grow.grid_from_growing_queue(eg, density, thresh)

    style_path = str(tmp_path / "wave.png")
    rgba = np.concatenate([np.moveaxis(wave(), 0, -1),
                           np.full((72, 88, 1), 0.5, np.float32)], -1)
    Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(style_path)
    cfg = PipelineConfig(
        mode="style", train_steps_style=12, train_steps_distill=4,
        distill_palette_steps=4, num_palette_bases=4, style_lg=12,
        depth_diff=0.5, style_image=style_path, crop_size=32,
        preserve_color=preserve_color,
        weights=StyleLossWeights(
            offset_loss=5e-5, weight_loss_non_uniform=1e-7,
            palette_loss_valid=1.0, smooth_trans_weight=1e-3,
            tv_weight=1e-4, tv_depth_guide=True, depth_disc_weight=5e-4,
            style_weight=130.0, warmup_iterations=5))
    ws = str(tmp_path / "style_ws")
    pipe = EditPipeline(tr, ds, cfg, ws, eg, grow)
    before = ds.images.copy()
    with pytest.warns(UserWarning, match="random filters"):
        results = pipe.run_all(test_dataset=test, log_fn=lambda *a: None)
    st = pipe.style_trainer
    assert st.step == 12
    assert st.gram_steps == 12 - 6  # steps 6..11 are past warm-up 5
    assert np.isfinite(st.mse_history).all()
    assert np.isfinite(results["psnr_train"])
    assert not np.array_equal(ds.images, before)
    sn = st.style_network
    assert (sn.gram_color is not None) == preserve_color
    assert sn.targets is (sn.gram_color if preserve_color else sn.gram_style)

    for f in ("hparams.json", "style_image.png", "style_enc.npz",
              "palet_og.npz", "palet_mod.npz", "timings.json",
              "results_psnr_train.json", "render_test/000.png"):
        assert os.path.exists(os.path.join(ws, f)), f
    with open(os.path.join(ws, "hparams.json")) as f:
        style = json.load(f)["style_losses"]
    assert style["vgg_pretrained"] is False and style["style_weight"] == 130
    # the RGB channels of the RGBA style image, alpha dropped
    saved = np.asarray(Image.open(os.path.join(ws, "style_image.png")))
    np.testing.assert_array_equal(saved, (rgba[..., :3] * 255).astype(
        np.uint8))
    img, _ = tr.render_image(test.poses[0], test.intrinsics, test.H, test.W)
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1 + 1e-5

    # a reload of the style LAENeRF skips its training, as in recolor
    again = dataclasses.replace(
        cfg, style_enc_path=os.path.join(ws, "style_enc.npz"),
        load_edit_dataset=os.path.join(ws, "edataset.npz"))
    pipe2 = EditPipeline(tr, ds, again, str(tmp_path / "ws2"), eg, grow)
    with pytest.warns(UserWarning, match="random filters"):
        pipe2.init_phase()
    pipe2.train_laenerf_phase(log_fn=lambda *a: None)
    assert pipe2.style_trainer.step == 0
    assert torch.equal(pipe2.style_trainer.model.encoder, st.model.encoder)
