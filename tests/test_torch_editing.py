"""Parity of the port's editing modules (laenerf_tpu_torch/editing/) with
the JAX package's, on inputs made with numpy from a seed.

Tolerances:
  * EditGrid voxelize, grow, grow-shell, algebra and dilation: bit-equal
    (the same numpy code).
  * laenerf_forward_train colors, weights and offsets: 2e-2 absolute
    (bf16 MLPs on both sides; a rounding flip of one bf16 activation moves
    an output by up to ~1e-2).
  * the eight LAENeRFLosses: 1e-5 relative (f32 on the same inputs).
  * prune_palette with padded rows: equal masks.
  * one laenerf_train_step from the same params and batch (the jitter is
    applied to x_term before the step in both packages; no intensity term,
    whose norm has a NaN gradient in JAX at the padded rows): the loss at
    1e-3 relative; the MLP and palette gradients at 2e-2 relative to each
    leaf's max; the encoder gradient at 1e-2 relative to its max (bf16
    rows summed in another order: JAX through its Pallas scatter-add in
    interpret mode over its [size, 8C] view, the port through K1's plain
    version). The JAX step runs with optax.scale(1e3) as its optimizer, so
    its gradients are (new - old) / 1e3; the port's are read from .grad.
  * distill_dataset images at 2e-2 absolute; pixels whose edit weight is
    at or under blend_thresh bit-equal to the original in both.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from _torch_parity import port_cfg, t
from laenerf_tpu.editing import distill as jdistill
from laenerf_tpu.editing import editgrid as jeg
from laenerf_tpu.editing import laenerf as jl
from laenerf_tpu.editing import style_trainer as jst
from laenerf_tpu_torch.convert import (laenerf_params_from_jax,
                                       laenerf_params_to_numpy)
from laenerf_tpu_torch.editing import distill as tdistill
from laenerf_tpu_torch.editing import editgrid as teg
from laenerf_tpu_torch.editing import laenerf as tl
from laenerf_tpu_torch.editing import style_trainer as tst

J_LCFG = jl.LAENeRFConfig(bound=1.0, num_levels=4, log2_hashmap_size=12,
                          num_palette_bases=4)
LCFG = port_cfg(J_LCFG, tl.LAENeRFConfig)


def laenerf_tree(seed=0, table_scale=0.5):
    """JAX-initialised LAENeRF params, the table spread wide; numpy."""
    params, _ = jl.laenerf_init(jax.random.PRNGKey(seed), J_LCFG)
    rng = np.random.RandomState(seed)
    return {
        "encoder": rng.uniform(-table_scale, table_scale,
                               params["encoder"].shape).astype(np.float32),
        "weight_net": [3.0 * np.asarray(w) for w in params["weight_net"]],
        "offset_net": [np.asarray(w) for w in params["offset_net"]],
        "palette": np.asarray(params["palette"]),
    }


def port_model(tree):
    model, _ = tl.laenerf_init(LCFG, device="cpu")
    model.load_state_dict(laenerf_params_from_jax(tree))
    return model


def points(seed, n, radius=0.8):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-radius, radius, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


# -- edit grid ----------------------------------------------------------------

def _ball_density(H=32, r2=0.3, seed=0):
    xs = (np.arange(H) + 0.5) / H * 2 - 1
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    rng = np.random.RandomState(seed)
    d = np.where(X ** 2 + Y ** 2 + Z ** 2 < r2, 1.0, 0.0) * rng.rand(H, H, H)
    return d[None].astype(np.float32)


def test_editgrid_matches_jax():
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.3, 0.3, (5, 3)).astype(np.float32)
    lj, cj = jeg.voxelize_points(pts, 2, 1.0, 32)
    lt, ct = teg.voxelize_points(pts, 2, 1.0, 32)
    np.testing.assert_array_equal(lj, lt)
    np.testing.assert_array_equal(cj, ct)

    density = _ball_density()
    grids = []
    for mod in (jeg, teg):
        eg = mod.EditGrid(1, 32)
        eg.new_from_points(pts)
        eg.grow_region_queue(density, 0.2, grow_iterations=3000)
        grow = mod.EditGrid(1, 32)
        grow.grid_from_growing_queue(eg, density, 0.2)
        neg = np.zeros_like(eg.grid)
        neg[0, :14] = 1
        carved = copy.deepcopy(eg)
        carved.xor(neg)
        carved.and_(grow.grid)
        carved.bw_and((density > 0.5).astype(np.uint8))
        carved.morphological()
        grids.append((eg.grid, grow.grid, carved.grid,
                      eg.get_selection_points(), len(eg.growing_queue)))
    assert grids[0][0].sum() > 20 and grids[0][1].sum() > 0
    for a, b in zip(*grids):
        np.testing.assert_array_equal(a, b)


# -- LAENeRF ------------------------------------------------------------------

def test_laenerf_forward_matches_jax():
    tree = laenerf_tree(1)
    x, d = points(2, 512)
    active = np.array([True, False, True, True])
    cj, wj, oj = jl.laenerf_forward_train(
        jax.tree.map(jnp.asarray, tree), J_LCFG, jnp.asarray(x),
        jnp.asarray(d), jnp.asarray(active))
    ct, wt, ot = tl.laenerf_forward_train(port_model(tree), t(x), t(d),
                                          t(active))
    assert float(jnp.std(cj)) > 0.02  # the output varies across points
    for got, ref in ((ct, cj), (wt, wj), (ot, oj)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=2e-2)
    assert float(wt[:, 1].detach().abs().max()) == 0.0  # inactive basis
    # the parameter conversion round-trips
    back = laenerf_params_to_numpy(port_model(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def _loss_inputs(seed=4):
    rng = np.random.RandomState(seed)
    w = rng.dirichlet(np.ones(4), 300).astype(np.float32)
    valid = (rng.rand(300) > 0.2).astype(np.float32)
    img = rng.rand(3, 20, 24).astype(np.float32)
    ref = rng.rand(20, 24, 3).astype(np.float32)
    dv, dw = rng.rand(20, 23).astype(np.float32), rng.rand(19, 24).astype(
        np.float32)
    trans = rng.rand(20, 24).astype(np.float32)
    palette = rng.uniform(-0.2, 1.2, (4, 3)).astype(np.float32)
    offsets = rng.normal(size=(300, 3)).astype(np.float32)
    return w, valid, img, ref, dv, dw, trans, palette, offsets


def test_laenerf_losses_match_jax():
    w, valid, img, ref, dv, dw, trans, palette, offsets = _loss_inputs()
    active = np.ones(4, bool)
    calls = [
        ("weights", lambda L, a: L.weights(a(w), 1e-3, 2e-3, a(valid))),
        ("palette", lambda L, a: L.palette(a(palette), a(active), 0.5, 0.7)),
        ("offsets", lambda L, a: L.offsets(a(offsets), 0.3)),
        ("tv", lambda L, a: L.tv(a(img))),
        ("depth_discontinuity",
         lambda L, a: L.depth_discontinuity(a(img), a(dv), a(dw))),
        ("tv_depth_weighted",
         lambda L, a: L.tv_depth_weighted(a(img), a(dv), a(dw), a(trans))),
        ("smooth_transition",
         lambda L, a: L.smooth_transition(a(ref), a(np.moveaxis(img, 0, -1)),
                                          a(trans))),
        ("intensity",
         lambda L, a: L.intensity(a(ref), a(np.moveaxis(img, 0, -1)))),
    ]
    assert len({name for name, _ in calls}) == 8
    for name, fn in calls:
        ref_v = float(fn(jl.LAENeRFLosses, jnp.asarray))
        got = float(fn(tl.LAENeRFLosses, t))
        assert abs(got - ref_v) <= 1e-5 * abs(ref_v), (name, got, ref_v)
    # tv_depth_weighted without the transition weights
    ref_v = float(jl.LAENeRFLosses.tv_depth_weighted(
        jnp.asarray(img), jnp.asarray(dv), jnp.asarray(dw)))
    got = float(tl.LAENeRFLosses.tv_depth_weighted(t(img), t(dv), t(dw)))
    assert abs(got - ref_v) <= 1e-5 * abs(ref_v)


def test_prune_palette_matches_jax():
    tree = laenerf_tree(5)
    rng = np.random.RandomState(6)
    views, valids = [], []
    for n in (300, 180):
        x, _ = points(int(rng.randint(1000)), n, radius=0.5)
        views.append(np.concatenate([x, np.zeros((212, 3), np.float32)]))
        valids.append(np.arange(n + 212) < n)
    active = np.array([True, True, False, True])
    params = jax.tree.map(jnp.asarray, tree)
    # a threshold in the widest gap between the bases' mean weights
    mean_w = np.mean([np.asarray(jl.laenerf_weights(
        params, J_LCFG, jnp.asarray(v[:int(m.sum())]), jnp.asarray(active)
    )).mean(0) for v, m in zip(views, valids)], axis=0)
    live = np.sort(mean_w[active])
    gap = int(np.argmax(np.diff(live)))
    thresh = float(live[gap] + live[gap + 1]) / 2
    ref = np.asarray(jl.prune_palette(params, J_LCFG, jnp.asarray(active),
                                      views, thresh, valid_views=valids))
    got = tl.prune_palette(port_model(tree), t(active),
                           [t(v) for v in views], thresh,
                           valid_views=[t(m) for m in valids]).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.sum() < active.sum()  # some basis was pruned


# -- one train step -----------------------------------------------------------

H = W = 32
N_PAD = 1024
CROP = 16


def train_batch(seed=7):
    """One padded EditDataset-style view: 600 rays in a 20x20 box (the
    rest padded), a 16x16 crop at (6, 8) and random crop maps."""
    rng = np.random.RandomState(seed)
    box = np.array([r * W + c for r in range(6, 26) for c in range(8, 28)])
    inds = np.sort(rng.choice(box, 300, replace=False)).astype(np.int32)
    n = inds.size
    x, d = points(seed + 1, N_PAD, radius=0.6)
    valid = np.arange(N_PAD) < n
    pad = np.full(N_PAD, H * W, np.int32)
    pad[:n] = inds
    return {
        "valid": valid,
        "inds": pad,
        "x_term": np.where(valid[:, None], x, 0.0).astype(np.float32),
        "dirs": d,
        "targets": (rng.rand(N_PAD, 3) * valid[:, None]).astype(np.float32),
        "crop_origin": np.array([6, 8], np.int32),
        "cut_gt": rng.rand(CROP, CROP, 3).astype(np.float32),
        "cut_smooth": rng.rand(CROP, CROP).astype(np.float32),
        "tv_h": rng.rand(CROP - 1, CROP).astype(np.float32),
        "tv_v": rng.rand(CROP, CROP - 1).astype(np.float32),
    }


def _step_parity(past_warmup):
    tree = laenerf_tree(8, table_scale=0.2)
    batch = train_batch()
    active = np.array([True, True, True, False])
    weights = tst.StyleLossWeights(
        tv_weight=2e-2, depth_disc_weight=1e-2, smooth_trans_weight=5e-2,
        offset_loss=1e-3,
        weight_loss_non_uniform=1e-3, weight_loss_uniform=1e-3,
        palette_loss_valid=1e-1, palette_loss_distinct=1e-2,
        tv_depth_guide=True, warmup_iterations=0)
    jweights = jst.StyleLossWeights(**vars(weights))
    scale = 1e3
    opt = optax.scale(scale)
    params = jax.tree.map(jnp.asarray, tree)
    new, _, aux_j = jst.laenerf_train_step(
        params, opt.init(params), jnp.asarray(active),
        jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0),
        cfg=J_LCFG, weights=jweights, optimizer=opt, H=H, W=W, crop_h=CROP,
        crop_w=CROP, use_style=False, past_warmup=past_warmup)
    grads_j = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                           / scale, new, params)

    model = port_model(tree)
    aux_t = tst.laenerf_train_step(
        model, tst.make_style_optimizer(model), t(active),
        {k: t(v) for k, v in batch.items()}, weights=weights, H=H, W=W,
        crop_h=CROP, crop_w=CROP, past_warmup=past_warmup)
    loss_j, loss_t = float(aux_j["loss"]), float(aux_t["loss"])
    assert abs(loss_t - loss_j) <= 1e-3 * abs(loss_j), (loss_t, loss_j)
    grads_t = {"encoder": model.encoder.grad.numpy(),
               "palette": model.palette.grad.numpy()}
    for name in ("weight_net", "offset_net"):
        grads_t[name] = [lin.weight.grad.numpy().T
                         for lin in getattr(model, name).layers]
    for name, tol in (("encoder", 1e-2), ("palette", 2e-2),
                      ("weight_net", 2e-2), ("offset_net", 2e-2)):
        for g, r in zip(jax.tree.leaves(grads_t[name]),
                        jax.tree.leaves(grads_j[name])):
            peak = np.abs(r).max()
            assert peak > 0, name
            err = np.abs(g - r).max() / peak
            assert err < tol, f"{name}: grad error {err:.3e}"
    return loss_t


def test_train_step_matches_jax_with_crop_losses():
    _step_parity(past_warmup=True)


def test_train_step_matches_jax_without_crop_losses():
    _step_parity(past_warmup=False)


# -- distillation -------------------------------------------------------------

class _Images:
    """The part of NeRFDataset that distill_dataset reads and writes."""

    def __init__(self, images):
        self.images = images
        self.H, self.W = images.shape[1:3]
        self.depths = []

    def __len__(self):
        return len(self.images)


def _edit_views(seed=9, n_views=2):
    rng = np.random.RandomState(seed)
    views = []
    for v in range(n_views):
        n = 400 + 50 * v
        inds = np.sort(rng.choice(H * W, n, replace=False)).astype(np.int32)
        x, d = points(seed + v, N_PAD, radius=0.6)
        pad = lambda a, fill=0: np.concatenate(
            [a[:n], np.full((N_PAD - n,) + a.shape[1:], fill, a.dtype)])
        w8s = rng.rand(N_PAD).astype(np.float32)
        views.append({
            "view_index": 2 * v, "n_valid": n,
            "inds": pad(inds, H * W), "w8s": pad(w8s),
            "x_term": pad(x), "dirs": d,
            "dist_factor": pad(np.where(rng.rand(N_PAD) > 0.7,
                                        rng.rand(N_PAD), 0.0).astype(
                                            np.float32)),
            "pred_img": pad(rng.rand(N_PAD, 3).astype(np.float32)),
            "depths": pad(rng.uniform(1, 3, N_PAD).astype(np.float32)),
        })
    return views


def test_distill_dataset_matches_jax():
    tree = laenerf_tree(10)
    views = _edit_views()
    edit_ds = type("EditViews", (), {"views": views})()
    rng = np.random.RandomState(11)
    images = rng.rand(4, H, W, 4).astype(np.float32)
    palette = tree["palette"]
    palet_mod = np.clip(palette * np.array([1.8, 0.4, 0.35]), 0, 1)
    active = np.array([True, True, False, True])
    pw = np.array([1.0, 0.5, 1.0, 2.0], np.float32)
    pb = np.array([0.0, 0.1, 0.0, -0.05], np.float32)
    kw = dict(palet_weights=pw, palet_biases=pb, blend_thresh=0.5,
              smooth_transition=True)

    ds_j, ds_t = _Images(images.copy()), _Images(images.copy())
    stats_j = jdistill.distill_dataset(
        ds_j, edit_ds, jax.tree.map(jnp.asarray, tree), J_LCFG,
        jnp.asarray(active), palette, palet_mod, **kw)
    stats_t = tdistill.distill_dataset(ds_t, edit_ds, port_model(tree),
                                       t(active), palette, palet_mod, **kw)
    np.testing.assert_allclose(ds_t.images, ds_j.images, atol=2e-2)
    for v in views:
        i, n = v["view_index"], v["n_valid"]
        w8s = np.zeros(H * W, np.float32)
        w8s[v["inds"][:n]] = v["w8s"][:n]
        keep = w8s <= 0.5
        for ds in (ds_j, ds_t):
            np.testing.assert_array_equal(
                ds.images[i].reshape(-1, 4)[keep],
                images[i].reshape(-1, 4)[keep])
        assert not np.array_equal(ds_t.images[i], images[i])
        np.testing.assert_array_equal(ds_t.depths[i], ds_j.depths[i])
    for k in ("sparsity_loss", "tv_loss"):
        np.testing.assert_allclose(stats_t[k], stats_j[k], rtol=2e-2)
