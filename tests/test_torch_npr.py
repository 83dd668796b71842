"""Parity of the port's NPR mode with the JAX package's: the semantic
encoder (VGG-16 features, cosine loss, nearest-neighbour feature and colour
replacement, colour-set matching), SingleViewEditDataset, npr_train_step,
the NPR fine-tune step, and run_npr_pipeline end to end on a tiny CPU
scene. Both packages draw the same random VGG-16 filters (no weights npz).

Tolerances (bounds on the error):
  * encode_feats: <= 1e-4 * max |JAX| (f32 convolutions in another order).
  * cos_loss: 1e-5 relative. nn_feat_replace(_color) on features with a
    clear nearest-neighbour margin (a permutation of the content plus
    small noise): equal to JAX's and to the permuted style.
    get_mean_patch_color: 2e-6 absolute. match_colors_for_image_set: equal
    (the same float64 numpy code).
  * SingleViewEditDataset: the same views, pad size, crop sizes and crop
    origins, and the same RandomState draws after the build; per view the
    x_term at 2e-3 absolute (the distill render's tolerance in
    test_torch_pipeline.py), registration membership differing on at most
    1% of a view's rays, targets equal where both register the same
    reference point, sup_feat and col_patch <= 1e-3 * max |JAX| on at
    least 99% of their columns (a near-tie may pick another neighbour).
  * npr_train_step from the same params and batch: loss and MSE at 1e-3
    relative; gradients as test_torch_editing.py's step test (encoder 1e-2
    of its max, palette and MLPs 2e-2).
  * train_step_npr with JAX's background and march noises passed in: the
    loss at 1e-3 relative.
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

from _torch_parity import (J_RENDER_CFG, blob_occupancy, jax_params,
                           max_rel_err, port_cfg, t, tiny_scene_trainer)
from laenerf_tpu.editing import laenerf as jl
from laenerf_tpu.editing import npr_dataset as jnd
from laenerf_tpu.editing import npr_trainer as jnt
from laenerf_tpu.editing import semantic as jsem
from laenerf_tpu.editing import style_trainer as jst
from laenerf_tpu.editing import vgg as jvgg
from laenerf_tpu.train import checkpoints as jckpt
from laenerf_tpu.train import trainer as jtrain
from laenerf_tpu_torch.convert import (laenerf_params_from_jax,
                                       load_jax_checkpoint)
from laenerf_tpu_torch.editing import laenerf as tl
from laenerf_tpu_torch.editing import npr_dataset as tnd
from laenerf_tpu_torch.editing import npr_trainer as tnt
from laenerf_tpu_torch.editing import semantic as tsem
from laenerf_tpu_torch.editing import style_trainer as tst
from laenerf_tpu_torch.editing import vgg as tvgg
from test_torch_editing import CROP, H, N_PAD, W, points
from test_torch_pipeline import _camera, _trainers, _Views

J_NCFG = jl.LAENeRFConfig(bound=1.0, num_levels=4, log2_hashmap_size=12,
                          num_palette_bases=4, dir_degree=0)
NCFG = port_cfg(J_NCFG, tl.LAENeRFConfig)
FS = 16  # feature_size


@pytest.fixture(autouse=True)
def no_vgg_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("LAENERF_VGG16_NPZ", raising=False)
    monkeypatch.setattr(tvgg, "_WEIGHTS_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(jvgg, "_WEIGHTS_DIR", str(tmp_path / "none"))


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    none = str(tmp_path_factory.mktemp("none"))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("LAENERF_VGG16_NPZ", raising=False)
        mp.setattr(tvgg, "_WEIGHTS_DIR", none)
        mp.setattr(jvgg, "_WEIGHTS_DIR", none)
        with pytest.warns(UserWarning, match="random filters"):
            j = jsem.SemanticEncoder()
        with pytest.warns(UserWarning, match="random filters"):
            p = tsem.SemanticEncoder(device="cpu")
    return j, p


# -- the semantic encoder -----------------------------------------------------

def test_encode_feats_and_cos_loss_match_jax(encoders):
    j, p = encoders
    img = np.random.RandomState(20).rand(3, 30, 26).astype(np.float32)
    for layers, size in ((jsem.FEAT_LAYERS, (16, 16)),
                         (jsem.COLOR_LAYERS, None)):
        ref = j.encode_feats(img, layers, size)
        got = p.encode_feats(img, layers, size)
        assert got.shape == ref.shape
        assert max_rel_err(got.numpy(), ref) <= 1e-4
    rng = np.random.RandomState(21)
    a = rng.randn(3, 16, 20).astype(np.float32)
    b = (a + 0.5 * rng.randn(3, 16, 20)).astype(np.float32)
    ref = float(jsem.SemanticEncoder.cos_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(tsem.SemanticEncoder.cos_loss(t(a), t(b)))
    assert abs(got - ref) <= 1e-5 * abs(ref)
    assert float(tsem.nnfm_loss(p, t(a).reshape(3, 16, 4, 5), t(a))) < 1e-5


def _matched(rng, L, C, h, w, noise):
    """content [L, C, h, w] and content_style = a column permutation of it
    plus noise[layer]; returns them and the permutation."""
    content = rng.randn(L, C, h, w).astype(np.float32)
    perm = rng.permutation(h * w)
    cs = content.reshape(L, C, -1)[:, :, perm]
    cs = cs + np.asarray(noise, np.float32)[:, None, None] * rng.randn(
        *cs.shape).astype(np.float32)
    return content, cs.reshape(L, C, h, w), perm


def test_nn_feat_replace_matches_jax(encoders):
    j, p = encoders
    rng = np.random.RandomState(22)
    content, cs, perm = _matched(rng, 2, 64, 6, 5, [0.05, 0.05])
    style = rng.randn(2, 64, 6, 5).astype(np.float32)
    ref = np.asarray(j.nn_feat_replace(jnp.asarray(content), jnp.asarray(cs),
                                       jnp.asarray(style)))
    got = p.nn_feat_replace(t(content), t(cs), t(style)).numpy()
    inv = np.argsort(perm)  # content column i sits at cs column inv[i]
    np.testing.assert_array_equal(got, style.reshape(2, 64, -1)[:, :, inv])
    np.testing.assert_array_equal(got, ref)

    # colours from the layer whose neighbour is nearer (layer 1 here)
    content, cs, perm = _matched(rng, 2, 64, 6, 5, [0.6, 0.02])
    colors = rng.rand(3, 6, 5).astype(np.float32)
    ref = np.asarray(j.nn_feat_replace_color(
        jnp.asarray(content), jnp.asarray(cs), jnp.asarray(colors)))
    got = p.nn_feat_replace_color(t(content), t(cs), t(colors)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, colors.reshape(3, -1)[:, np.argsort(perm)].reshape(3, 6, 5))
    # the chunked search agrees with one chunk
    a, b = t(content[0].reshape(64, -1)), t(cs[0].reshape(64, -1))
    i1, d1 = p._argmin_cos(a, b, chunk=7)
    i2, d2 = p._argmin_cos(a, b)
    assert torch.equal(i1, i2) and torch.allclose(d1, d2)


def test_patch_color_and_color_set_match_jax():
    rng = np.random.RandomState(23)
    img = rng.rand(3, 40, 30).astype(np.float32)
    ref = np.asarray(jsem.SemanticEncoder.get_mean_patch_color(img, (5, 4)))
    got = tsem.SemanticEncoder.get_mean_patch_color(t(img), (5, 4)).numpy()
    assert np.abs(got - ref).max() <= 2e-6
    a = (0.3 * rng.rand(16, 16, 3)).astype(np.float32)
    b = np.clip(0.3 * rng.rand(16, 16, 3) + 0.6, 0, 1).astype(np.float32)
    for r, g in zip(jsem.SemanticEncoder.match_colors_for_image_set(a, b),
                    tsem.SemanticEncoder.match_colors_for_image_set(a, b)):
        np.testing.assert_array_equal(g, r)


# -- the NPR LAENeRF step -----------------------------------------------------

def npr_tree(seed=30):
    params, _ = jl.laenerf_init(jax.random.PRNGKey(seed), J_NCFG)
    rng = np.random.RandomState(seed)
    return {
        "encoder": rng.uniform(-0.2, 0.2, params["encoder"].shape).astype(
            np.float32),
        "weight_net": [3.0 * np.asarray(w) for w in params["weight_net"]],
        "offset_net": [np.asarray(w) for w in params["offset_net"]],
        "palette": np.asarray(params["palette"]),
    }


def npr_batch(seed=31):
    """A hand-built padded NPR view: 300 rays in a 20x20 box of a 32x32
    frame, a 16x16 crop at (6, 8), random supervision features."""
    rng = np.random.RandomState(seed)
    box = np.array([r * W + c for r in range(6, 26) for c in range(8, 28)])
    inds = np.sort(rng.choice(box, 300, replace=False)).astype(np.int32)
    n = inds.size
    x, d = points(seed + 1, N_PAD, radius=0.6)
    valid = np.arange(N_PAD) < n
    pad = np.full(N_PAD, H * W, np.int32)
    pad[:n] = inds
    vf = valid[:, None].astype(np.float32)
    tw = rng.rand(N_PAD).astype(np.float32) * (rng.rand(N_PAD) > 0.3)
    return {
        "valid": valid, "inds": pad,
        "x_term": (x * vf).astype(np.float32), "dirs": d,
        "w8s": (0.5 + 0.5 * rng.rand(N_PAD)).astype(np.float32),
        "targets": (rng.rand(N_PAD, 3) * vf).astype(np.float32),
        "target_weights": tw,
        "crop_origin": np.array([6, 8], np.int32),
        "sup_feat": np.abs(rng.randn(3, 256, (FS // 4) ** 2)).astype(
            np.float32),
        "col_patch": rng.rand(3, 2, 2).astype(np.float32),
        "style_guide": rng.uniform(0.1, 1, (CROP, CROP)).astype(np.float32),
        "tv_h": rng.rand(CROP - 1, CROP).astype(np.float32),
        "tv_v": rng.rand(CROP, CROP - 1).astype(np.float32),
    }


def test_npr_train_step_matches_jax(encoders):
    j, p = encoders
    tree = npr_tree()
    batch = npr_batch()
    active = np.array([True, True, False, True])
    weights = tst.StyleLossWeights(
        offset_loss=1e-3, weight_loss_uniform=1e-4,
        weight_loss_non_uniform=1e-3, palette_loss_valid=1e-1,
        tv_weight=1e-2, tv_depth_guide=True, depth_disc_weight=1e-2)
    kw = dict(H=H, W=W, crop_h=CROP, crop_w=CROP, feature_size=FS,
              mse_loss_w=6.0, cos_loss_w=2.5, color_patch_w=30.0)
    scale = 1e3
    opt = optax.scale(scale)
    params = jax.tree.map(jnp.asarray, tree)
    new, _, aux_j = jnt.npr_train_step(
        params, opt.init(params), jnp.asarray(active),
        jax.tree.map(jnp.asarray, batch), j.params, jax.random.PRNGKey(0),
        vgg_kinds=tuple(j.kinds), cfg=J_NCFG,
        weights=jst.StyleLossWeights(**vars(weights)), optimizer=opt, **kw)
    grads_j = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                           / scale, new, params)

    model, _ = tl.laenerf_init(NCFG, device="cpu")
    model.load_state_dict(laenerf_params_from_jax(tree))
    aux_t = tnt.npr_train_step(
        model, tst.make_style_optimizer(model), t(active),
        {k: t(v) for k, v in batch.items()}, p, weights=weights, **kw)
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
            assert max_rel_err(g, r) < tol, name


# -- the NeRF's NPR fine-tune step --------------------------------------------

def test_train_one_batch_npr_matches_jax(tmp_path):
    tree = jax_params(32, table_scale=0.2)
    tr_j, tr_t = _trainers(tmp_path, tree, blob_occupancy(33))
    tr_t.global_step = 1  # no occupancy refresh on this step
    pose, intr = _camera()
    rng = np.random.RandomState(34)
    hw = 24 * 24
    view = {"view_index": 0,
            "target": rng.rand(24, 24, 4).astype(np.float32),
            "style_img": rng.rand(24, 24, 4).astype(np.float32),
            "target_weights": rng.rand(24, 24).astype(np.float32),
            "depth": rng.uniform(1.5, 3.0, (24, 24)).astype(np.float32),
            "depth_weights": (rng.rand(24, 24) > 0.5).astype(np.float32)}
    N = 128
    inds = rng.randint(0, hw, N).astype(np.int32)
    key = jax.random.PRNGKey(35)
    k_bg, k_render, _ = jax.random.split(key, 3)
    bg = np.asarray(jax.random.uniform(k_bg, (N, 3)))
    noises = np.asarray(jax.random.uniform(k_render, (N,)))
    rows = {k: jnp.asarray(np.asarray(v).reshape(hw, -1)[inds].squeeze(-1)
                           if np.asarray(v).ndim == 2 else
                           np.asarray(v).reshape(hw, -1)[inds])
            for k, v in view.items() if k != "view_index"}
    _, aux_j = jtrain.train_step_npr(
        tr_j.state, tr_j.occ_state.occupancy, jnp.asarray(pose),
        jnp.asarray(intr), jnp.asarray(inds), rows["target"],
        rows["style_img"], rows["target_weights"], rows["depth"],
        rows["depth_weights"], key, model_cfg=tr_j.model_cfg,
        render_cfg=tr_j.render_cfg, optimizer=tr_j.optimizer,
        ema_decay=tr_j.ema_decay, H=24, W=24)
    views = _Views(pose[None], intr, np.zeros((1, 24, 24, 4), np.float32))
    before = tr_t.net.encoder.detach().clone()
    aux_t = tr_t.train_one_batch_npr(views, view, inds=inds, bg=t(bg),
                                     noises=t(noises))
    ref, got = float(aux_j["loss"]), float(aux_t["loss"])
    assert abs(got - ref) <= 1e-3 * abs(ref), (got, ref)
    assert tr_t.global_step == 2
    assert not torch.equal(tr_t.net.encoder, before)
    # drawn from the trainer's generator when not given
    assert np.isfinite(float(tr_t.train_one_batch_npr(views, view,
                                                      num_rays=64)["loss"]))


# -- the registration dataset -------------------------------------------------

def _reference_dir(root, images, idx=0):
    """The NPR config directory: view idx with its green channel doubled
    (RGBA), and data_config.json."""
    cfg_dir = os.path.join(root, "npr_ref")
    os.makedirs(cfg_dir, exist_ok=True)
    ref = images[idx].copy()
    ref[..., 1] = np.clip(ref[..., 1] * 2.0, 0, 1)
    Image.fromarray((ref * 255).astype(np.uint8), "RGBA").save(
        os.path.join(cfg_dir, "ref.png"))
    with open(os.path.join(cfg_dir, "data_config.json"), "w") as f:
        json.dump({"tmpl_idx_train": idx}, f)
    return cfg_dir


def test_single_view_edit_dataset_matches_jax(tmp_path, encoders):
    jenc, penc = encoders
    tree = jax_params(36)
    occ = blob_occupancy(37)
    tr_j, tr_t = _trainers(tmp_path, tree, occ, dataclasses.replace(
        J_RENDER_CFG, density_scale=5.0))
    pose0, intr = _camera()
    pose1, _ = _camera(2.0)
    rng = np.random.RandomState(38)
    images = rng.rand(2, 24, 24, 4).astype(np.float32)
    images[..., 3] = 0.0
    images[:, 4:20, 5:21, 3] = 1.0  # the object's alpha
    views = _Views(np.stack([pose0, pose1]), intr, images)
    cfg_dir = _reference_dir(str(tmp_path), images)
    kw = dict(min_dist=0.1, max_dist=0.3, feature_size=FS, eval_chunk=256,
              seed=4)
    ds_j = jnd.SingleViewEditDataset(tr_j, views, cfg_dir, jenc, **kw)
    ds_t = tnd.SingleViewEditDataset(tr_t, views, cfg_dir, penc, **kw)
    np.testing.assert_array_equal(ds_t.ref_img, ds_j.ref_img)
    assert (ds_t.n_pad, ds_t.crop_h, ds_t.crop_w) == \
        (ds_j.n_pad, ds_j.crop_h, ds_j.crop_w)
    # the same numpy draws: the reference jitter, then what follows
    assert ds_t.rng.randint(1 << 30) == ds_j.rng.randint(1 << 30)
    np.testing.assert_array_equal(ds_t.epoch_indices(), ds_j.epoch_indices())
    assert [v["view_index"] for v in ds_t.views] == \
        [v["view_index"] for v in ds_j.views] == [0, 1]
    for vj, vt in zip(ds_j.views, ds_t.views):
        n = vj["n_valid"]
        assert vt["n_valid"] == n and n > 100
        np.testing.assert_array_equal(vt["inds"], vj["inds"])
        np.testing.assert_array_equal(vt["crop_origin"], vj["crop_origin"])
        np.testing.assert_allclose(vt["x_term"][:n], vj["x_term"][:n],
                                   atol=2e-3)
        rj = vj["target_weights"][:n] > 0
        rt = vt["target_weights"][:n] > 0
        assert np.sum(rj != rt) <= 0.01 * n
        both = rj & rt & np.all(vj["targets"][:n] == vt["targets"][:n], -1)
        assert both.sum() >= 0.9 * min(rj.sum(), rt.sum())
        assert rj.mean() > 0.5  # the second view registers too
        for k in ("sup_feat", "col_patch"):
            g, r = vt[k], vj[k]
            cols = np.abs(g - r).max(axis=-2 if k == "sup_feat" else 0)
            ok = cols <= 1e-3 * np.abs(r).max()
            assert ok.mean() >= 0.99, (k, ok.mean())
        np.testing.assert_allclose(vt["cut_gt"], vj["cut_gt"])


# -- the pipeline -------------------------------------------------------------

def test_npr_pipeline_on_cpu(tmp_path):
    """run_npr_pipeline end to end on the tiny scene: train view 0 with its
    green channel doubled as the reference, a few LAENeRF and fine-tune
    steps; its artifacts, and style_enc.npz read by both packages."""
    from laenerf_tpu_torch.editing import StyleLossWeights
    from laenerf_tpu_torch.pipeline import run_npr_pipeline

    tr, ds, _ = tiny_scene_trainer(tmp_path)
    cfg_dir = _reference_dir(str(tmp_path), ds.images)
    weights = StyleLossWeights(offset_loss=1e-4, weight_loss_uniform=1e-6,
                               weight_loss_non_uniform=1e-6,
                               palette_loss_valid=1e-4, tv_weight=1e-5,
                               tv_depth_guide=True, warmup_iterations=0)
    ws = str(tmp_path / "npr_ws")
    step0 = tr.global_step
    with pytest.warns(UserWarning, match="random filters"):
        npr_tr = run_npr_pipeline(
            tr, ds, cfg_dir, ws, weights, train_steps_style=6,
            train_steps_distill=4, feature_size=FS, num_rays=128,
            log_fn=lambda *a: None)
    assert npr_tr.step == 6 and len(npr_tr.mse_history) == 6
    assert np.isfinite(npr_tr.mse_history).all()
    assert len(npr_tr.finetune_losses) == 4
    assert all(np.isfinite(float(x)) for x in npr_tr.finetune_losses)
    assert tr.global_step == step0 + 4
    assert npr_tr.cfg.dir_degree == 0
    for f in ("style_enc.npz", "style_enc.npz.json", "timings.json",
              "nerf_retrain_dataset/style_img_0.png"):
        assert os.path.exists(os.path.join(ws, f)), f
    with open(os.path.join(ws, "timings.json")) as f:
        assert {"edit_dataset", "train_style_enc", "distill_dataset",
                "distill_nerf", "sum"} <= set(json.load(f))
    assert tr.ckpt.latest() is not None

    path = os.path.join(ws, "style_enc.npz")
    loaded = load_jax_checkpoint(path)
    for name, p in npr_tr.model.state_dict().items():
        np.testing.assert_array_equal(loaded["params"][name].numpy(),
                                      p.numpy())
    np.testing.assert_array_equal(loaded["active"], npr_tr.active.numpy())
    # the JAX package reads it too, under its own config
    params, active = jl.laenerf_init(jax.random.PRNGKey(0), dataclasses.replace(
        J_NCFG, log2_hashmap_size=19, num_levels=16))
    tree, meta = jckpt.load_pytree(path, {"params": params,
                                          "active": active})
    np.testing.assert_array_equal(np.asarray(tree["params"]["palette"]),
                                  npr_tr.model.palette.detach().numpy())
    assert meta["octo_gather"] is True
