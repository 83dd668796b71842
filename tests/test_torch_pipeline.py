"""Parity of the port's distill render, edit dataset and distill fine-tune
step with the JAX package's, and the port's recolor pipeline end to end on
a tiny CPU scene.

The NeRF parameters and occupancy grids are numpy arrays made from a seed
(tests/_torch_parity.py), handed to both packages.

Tolerances:
  * _march_round(with_edit) at both K_march branches (packing and one
    event a slot): equal t, slots, validity and edit flags (the same f32
    operations in the same order).
  * render_rays_distill image, depth, weights, weights_edit and x_term:
    2e-3 absolute, with the density grid and with the edit grid itself
    (grow_grid) as the march source (bf16 network on both sides, as in
    test_torch_trainer.py's render).
  * render_rays_distill with an all-zero edit grid against
    render_rays_infer with no background (one round loop): image and
    weights bit for bit, depth + t0 * weights at 1e-6 relative and
    absolute (float32 rounding of the sums), nothing flagged as edited.
  * EditDataset views: x_term and weights at 2e-3 absolute on the pixels
    both keep; at most 0.5% of a view's pixels differ in mask membership
    (a weight near a filter threshold may fall either side).
  * train_one_batch_distill with depth supervision: the loss at 1e-3
    relative, with JAX's background and march noises passed as tensors.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, MODEL_CFG, RENDER_CFG,
                           blob_occupancy, camera_rays, jax_params, port_net,
                           t)
from laenerf_tpu.editing import edit_dataset as jed
from laenerf_tpu.models import renderer as jren
from laenerf_tpu.ops import raymarch as jmarch
from laenerf_tpu.train import trainer as jtrain
from laenerf_tpu_torch.convert import params_from_jax
from laenerf_tpu_torch.editing import edit_dataset as ted
from laenerf_tpu_torch.models import renderer as tren
from laenerf_tpu_torch.ops import raymarch as tmarch
from laenerf_tpu_torch.train import trainer as ttrain

H = W = 24


def edit_grids(occ):
    """An edit grid (half the blob) and a shell beside it."""
    G = occ.shape[-1]
    edit = np.zeros_like(occ)
    edit[:, : G // 2] = occ[:, : G // 2]
    shell = np.zeros_like(occ)
    shell[:, G // 2: G // 2 + 8] = occ[:, G // 2: G // 2 + 8]
    return edit, shell


def _camera(dist=2.4):
    eye = np.array([0.4, -0.5, -dist], np.float32)
    f = -eye / np.linalg.norm(eye)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    u = np.cross(f, r)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([r, u, f], axis=1)
    pose[:3, 3] = eye
    return pose, np.array([20.0, 20.0, W / 2, H / 2], np.float32)


def test_march_round_with_edit_matches_jax():
    occ = blob_occupancy(40)
    edit, _ = edit_grids(occ)
    rays_o, rays_d = camera_rays(41, 200)
    cfg_j, cfg_t = J_RENDER_CFG.march_cfg, RENDER_CFG.march_cfg
    skip_j = jmarch.build_skip_field(jnp.asarray(occ), bound=1.0).reshape(-1)
    skip_t = tmarch.build_skip_field(t(occ), bound=1.0).reshape(-1)
    ev_j = jmarch.make_march_event(jnp.asarray(rays_o), jnp.asarray(rays_d),
                                   skip_j, jnp.asarray(edit).reshape(-1),
                                   cfg_j)
    ev_t = tmarch.make_march_event(t(rays_o), t(rays_d), skip_t, cfg_t,
                                   edit_flat=t(edit).reshape(-1))
    nears, fars = jmarch.near_far_from_aabb(
        jnp.asarray(rays_o), jnp.asarray(rays_d),
        jnp.array([-1.0] * 3 + [1.0] * 3), 0.2)
    alive = np.ones(200, bool)
    alive[::7] = False
    for K_march in (4, 32):  # one event a slot; packing 32 events into 8
        t0 = np.asarray(nears)
        for _ in range(3):  # three rounds, each from the last one's t
            ref = jren._march_round(ev_j, jnp.asarray(t0), fars,
                                    jnp.asarray(alive), 8, K_march,
                                    with_edit=True)
            got = tren._march_round(ev_t, t(t0), t(fars), t(alive), 8,
                                    K_march, with_edit=True)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            t0 = np.asarray(ref[0])
        assert np.asarray(ref[4]).any() and np.asarray(ref[3]).any()


def test_render_rays_distill_matches_jax():
    tree = jax_params(42)
    occ = blob_occupancy(43)
    edit, shell = edit_grids(occ)
    rays_o, rays_d = camera_rays(44, 400)
    net = port_net(tree)
    params = jax.tree.map(jnp.asarray, tree)
    for grow, grid in ((False, edit), (True, shell)):
        ref = jren.render_rays_distill(
            params, jnp.asarray(occ), jnp.asarray(grid), jnp.asarray(rays_o),
            jnp.asarray(rays_d), jax.random.PRNGKey(0),
            model_cfg=J_MODEL_CFG, render_cfg=J_RENDER_CFG, grow_grid=grow)
        got = tren.render_rays_distill(net, t(occ), t(grid), t(rays_o),
                                       t(rays_d), render_cfg=RENDER_CFG,
                                       grow_grid=grow)
        for k in ("image", "depth", "weights", "weights_edit", "x_term",
                  "depth_edit"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=2e-3, err_msg=k)
        assert float(ref["weights_edit"].max()) > 0.5
        assert float(ref["weights_edit"].min()) == 0.0
        assert float(got["min_near"]) == float(ref["min_near"])


class _Views:
    """The part of NeRFDataset that EditDataset reads."""

    def __init__(self, poses, intrinsics, images):
        self.poses, self.intrinsics, self.images = poses, intrinsics, images
        self.H, self.W = images.shape[1:3]

    def __len__(self):
        return len(self.poses)


def test_distill_with_empty_edit_grid_is_infer():
    """render_rays_distill and render_rays_infer share one round loop: with
    an all-zero edit grid and no background, distill's image and weights
    are infer's bit for bit, its depth (from t = 0) is infer's (from the
    perturbed origin t0) plus t0 * weights, and no weight is flagged as
    edited."""
    net = port_net(jax_params(45))
    occ = t(blob_occupancy(46))
    rays_o, rays_d = (t(a) for a in camera_rays(47, 300))
    noises = torch.rand((300,), generator=torch.Generator().manual_seed(48))
    kw = dict(render_cfg=RENDER_CFG, perturb=True, noises=noises)
    infer = tren.render_rays_infer(net, occ, rays_o, rays_d, bg_color=0.0,
                                   **kw)
    distill = tren.render_rays_distill(net, occ, torch.zeros_like(occ),
                                       rays_o, rays_d, **kw)
    assert torch.equal(distill["image"], infer["image"])
    assert torch.equal(distill["weights"], infer["weights_sum"])
    t0 = tmarch.march_origin(infer["nears"], noises, RENDER_CFG.march_cfg)
    want = infer["depth"] + t0 * infer["weights_sum"]
    np.testing.assert_allclose(distill["depth"].numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not distill["weights_edit"].any()
    assert not distill["depth_edit"].any()
    assert float(infer["weights_sum"].max()) > 0.5  # the rays hit the blob


def _trainers(tmp_path, tree, occ, render_cfg=J_RENDER_CFG):
    tr_j = jtrain.Trainer(str(tmp_path / "jws"), J_MODEL_CFG, render_cfg)
    params = jax.tree.map(jnp.asarray, tree)
    tr_j.state = dataclasses.replace(
        tr_j.state, params=params, ema_params=jax.tree.map(jnp.array, params),
        opt_state=tr_j.optimizer.init(params))
    tr_j.occ_state = dataclasses.replace(tr_j.occ_state,
                                         occupancy=jnp.asarray(occ))
    tr_t = ttrain.Trainer(MODEL_CFG, ttrain.RenderConfig(**{
        f.name: getattr(render_cfg, f.name)
        for f in dataclasses.fields(ttrain.RenderConfig)}), device="cpu")
    tr_t.net.load_state_dict(params_from_jax(tree))
    tr_t.ema_net.load_state_dict(params_from_jax(tree))
    tr_t.occ_state.occupancy = t(occ)
    return tr_j, tr_t


def test_edit_dataset_matches_jax(tmp_path):
    tree = jax_params(45)
    occ = blob_occupancy(46)
    edit, shell = edit_grids(occ)
    # dense enough that some rays end wholly inside the shell
    tr_j, tr_t = _trainers(tmp_path, tree, occ, dataclasses.replace(
        J_RENDER_CFG, density_scale=5.0))
    pose0, intr = _camera()
    pose1, _ = _camera(2.0)
    rng = np.random.RandomState(47)
    views = _Views(np.stack([pose0, pose1]), intr,
                   rng.rand(2, H, W, 4).astype(np.float32))
    kw = dict(depth_diff=0.5, max_dist=0.5, smooth_transition=True,
              eval_chunk=256)
    ds_j = jed.EditDataset(tr_j, views, edit, shell, **kw)
    ds_t = ted.EditDataset(tr_t, views, edit, shell, **kw)
    assert [v["view_index"] for v in ds_t.views] == \
        [v["view_index"] for v in ds_j.views] == [0, 1]
    for vj, vt in zip(ds_j.views, ds_t.views):
        mj = vj["inds"][:vj["n_valid"]]
        mt = vt["inds"][:vt["n_valid"]]
        assert mj.size > 20
        differ = np.setxor1d(mj, mt).size
        assert differ <= 0.005 * H * W, differ
        common, ij, it = np.intersect1d(mj, mt, return_indices=True)
        for k in ("x_term", "w8s", "w_density", "w_edit", "depths"):
            np.testing.assert_allclose(vt[k][it], vj[k][ij], atol=2e-3,
                                       err_msg=k)
        assert np.any(vj["dist_factor"] > 0)
        np.testing.assert_allclose(vt["dist_factor"][it],
                                   vj["dist_factor"][ij], atol=2e-3)


def test_train_one_batch_distill_matches_jax(tmp_path):
    tree = jax_params(48, table_scale=0.2)
    occ = blob_occupancy(49)
    tr_j, tr_t = _trainers(tmp_path, tree, occ)
    # no occupancy refresh on this step
    tr_j.global_step = tr_t.global_step = 1
    pose, intr = _camera()
    rng = np.random.RandomState(50)
    N = 128
    px = rng.rand(N, 4).astype(np.float32)
    px[:, 3] = (px[:, 3] > 0.3).astype(np.float32)
    depth = np.where(rng.rand(N) > 0.4, rng.uniform(1.5, 3.0, N), 0.0)
    batch = {"pose": pose, "intrinsics": intr, "H": H, "W": W,
             "inds": rng.randint(0, H * W, N).astype(np.int32),
             "pixels": px, "depth": depth.astype(np.float32)}
    # the draws JAX's step makes: Trainer._next_key, then train_step's split
    _, sub = jax.random.split(tr_j.key)
    k_bg, k_render, _ = jax.random.split(sub, 3)
    bg = np.asarray(jax.random.uniform(k_bg, (N, 3)))
    noises = np.asarray(jax.random.uniform(k_render, (N,)))
    aux_j = tr_j.train_one_batch_distill(batch, True, depth_sup=True)
    aux_t = tr_t.train_one_batch_distill(batch, True, depth_sup=True,
                                         bg=t(bg), noises=t(noises))
    loss_j, loss_t = float(aux_j["loss"]), float(aux_t["loss"])
    assert abs(loss_t - loss_j) <= 1e-3 * abs(loss_j), (loss_t, loss_j)
    # the depth term is part of it
    plain = tr_t.train_one_batch_distill(batch, True, depth_sup=False,
                                         bg=t(bg), noises=t(noises))
    assert float(plain["loss"]) != loss_t


def test_recolor_run_all_on_cpu(tmp_path):
    """The port's recolor pipeline end to end: a tiny scene, a NeRF from
    seeded params trained a few steps, a region grown from the centre
    pixel's termination point, then EditPipeline.run_all."""
    from laenerf_tpu_torch.data import NeRFDataset, generate_synthetic_scene
    from laenerf_tpu_torch.editing import EditGrid, StyleLossWeights
    from laenerf_tpu_torch.pipeline import (EditPipeline, PipelineConfig,
                                            project_points)

    scene = str(tmp_path / "scene")
    generate_synthetic_scene(scene, n_train=3, n_val=0, n_test=1, H=H, W=W,
                             device="cpu")
    ds = NeRFDataset(scene, "train", num_rays=256)
    test = NeRFDataset(scene, "test")
    tr = ttrain.Trainer(MODEL_CFG, RENDER_CFG, device="cpu",
                        workspace=str(tmp_path / "ws"))
    tr.net.load_state_dict(params_from_jax(jax_params(51)))
    tr.ema_net.load_state_dict(tr.net.state_dict())
    occ = blob_occupancy(52)
    tr.occ_state.occupancy = t(occ)
    tr.occ_state.density_grid = t(occ.astype(np.float32))
    tr.occ_state.mean_density = torch.tensor(float(occ.mean()))
    tr.occ_state.iter_density = 16
    tr.global_step = 1
    for step in range(4):
        tr.train_one_batch(ds.get_batch(step % len(ds)), has_alpha=True)

    pts = project_points(tr, ds.poses[0], ds.intrinsics, [[W // 2, H // 2]],
                         H, W)
    assert pts.shape == (1, 3) and np.all(np.abs(pts) < 1.0)
    density = tr.occ_state.density_grid.numpy()
    thresh = min(float(tr.occ_state.mean_density), 0.01)
    eg = EditGrid(1, RENDER_CFG.grid_size)
    eg.new_from_points(pts)
    eg.grow_region_queue(density, thresh, grow_iterations=2000)
    grow = EditGrid(1, RENDER_CFG.grid_size)
    grow.grid_from_growing_queue(eg, density, thresh)
    assert eg.grid.sum() > 10 and grow.grid.sum() > 0

    before = ds.images.copy()
    cfg = PipelineConfig(
        train_steps_style=24, train_steps_distill=4, distill_palette_steps=8,
        num_palette_bases=4, style_lg=12, depth_diff=0.5,
        weights=StyleLossWeights(
            tv_weight=1e-3, depth_disc_weight=1e-4, smooth_trans_weight=1e-3,
            offset_loss=1e-4, weight_loss_uniform=1e-5,
            weight_loss_non_uniform=1e-5, palette_loss_valid=1e-4,
            palette_loss_distinct=1e-4, tv_depth_guide=True,
            warmup_iterations=8),
        palette_mod=np.tile([[0.1, 0.9, 0.1]], (4, 1)))
    ws = str(tmp_path / "edit_ws")
    pipe = EditPipeline(tr, ds, cfg, ws, eg, grow)
    results = pipe.run_all(test_dataset=test, log_fn=lambda *a: None)
    assert np.isfinite(results["psnr_train"])
    assert len(pipe.edit_dataset) > 0
    assert pipe.style_trainer.step == 24
    assert not np.array_equal(ds.images, before)
    assert len(ds.depths) == len(ds)

    for f in ("hparams.json", "opt.json", "edit_grid.npz", "grow_grid.npz",
              "style_enc.npz", "palet_og.npz", "palet_mod.npz",
              "palette_eval.json", "timings.json",
              "results_psnr_train.json", "render_test/000.png",
              "masks/test/000.png"):
        assert os.path.exists(os.path.join(ws, f)), f
    with open(os.path.join(ws, "timings.json")) as f:
        timings = json.load(f)
    assert {"edit_dataset", "train_style_enc", "distill_dataset",
            "distill_nerf", "sum"} <= set(timings)
    # the fine-tune saved a checkpoint the trainer reloads
    assert tr.ckpt.latest() is not None

    # a second pipeline reloads the trained LAENeRF, its edited palette and
    # the cached edit dataset, and skips the LAENeRF training
    again = dataclasses.replace(
        cfg, style_enc_path=os.path.join(ws, "style_enc.npz"),
        palette_path=os.path.join(ws, "palet_mod.npz"),
        load_edit_dataset=os.path.join(ws, "edataset.npz"))
    pipe2 = EditPipeline(tr, ds, again, str(tmp_path / "ws2"), eg, grow)
    pipe2.init_phase()
    pipe2.train_laenerf_phase(log_fn=lambda *a: None)
    assert pipe2.style_trainer.step == 0
    for (n, p), q in zip(pipe2.style_trainer.model.named_parameters(),
                         pipe.style_trainer.model.parameters()):
        if n != "palette":
            assert torch.equal(p, q), n
    np.testing.assert_array_equal(
        pipe2.style_trainer.model.palette.detach().numpy(),
        np.load(os.path.join(ws, "palet_mod.npz"))["palette"].astype(
            np.float32))
    np.testing.assert_array_equal(pipe2.original_palette,
                                  pipe.original_palette)
    assert torch.equal(pipe2.style_trainer.active, pipe.style_trainer.active)
    assert len(pipe2.edit_dataset) == len(pipe.edit_dataset)


def test_metrics_and_evaluate_match_jax(tmp_path):
    from laenerf_tpu.train import metrics as jmetrics
    from laenerf_tpu_torch.train import metrics as tmetrics

    rng = np.random.RandomState(53)
    a = rng.rand(30, 26, 3).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(30, 26, 3), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim"):
        ref = float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tmetrics, name)(t(a), t(b)))
        assert abs(got - ref) <= 1e-5 * abs(ref), (name, got, ref)
    assert not tmetrics.LPIPSMeter().available

    tree = jax_params(54)
    occ = blob_occupancy(55)
    tr_j, tr_t = _trainers(tmp_path, tree, occ)
    pose, intr = _camera()
    images = rng.rand(1, H, W, 4).astype(np.float32)
    views = _Views(pose[None], intr, images)
    ref = tr_j.evaluate(views)
    got = tr_t.evaluate(views)
    assert abs(got - ref) < 1e-2, (got, ref)
    assert tr_t.stats["psnr"] == [got]
