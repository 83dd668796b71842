"""The port's command-line entry point (laenerf_tpu_torch/pipeline/cli.py)
and the pieces it adds: the patch-LPIPS term of the train step, error-map
distillation, the mesh export and the video writer.

Tolerances:
  * build_parser: the same namespace as JAX's on every flag set the run
    scripts pass (exactly).
  * batched LPIPS against JAX's vmapped LPIPS: 1e-5 relative (f32).
  * train_step with patch_size 8: the loss at 1e-3 relative and the
    step-1 gradient of every leaf norm-wise within twice the largest error
    of the rounding control (JAX's gradient with its rays moved one
    float32 ulp, test_torch_trainer.py says why), with JAX's background
    and noises injected.
  * distilled error maps: exactly where JAX's are exact (the edit weights
    are the same numpy arrays on both sides).
  * marching_tetrahedra: equal vertices and faces; write_ply equal bytes;
    save_density_mesh from the same parameters: equal face counts and
    vertices within 1e-4 (bf16 network on both sides).
  * the slice: the port CLI's --test frames from a JAX workspace within
    2/255 of JAX's render_image of the same poses.
"""

import dataclasses
import functools
import glob
import json
import os
import stat
import subprocess
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, MODEL_CFG, RENDER_CFG,
                           blob_occupancy, jax_params, norm_err, port_net,
                           rounding_bound, t, ulp_moves, write_vgg_npz)
from laenerf_tpu.data import NeRFDataset as JDataset
from laenerf_tpu.editing import distill as jdistill
from laenerf_tpu.editing import vgg as jvgg
from laenerf_tpu.models import renderer as jren
from laenerf_tpu.pipeline import cli as jcli
from laenerf_tpu.train import trainer as jtrain
from laenerf_tpu.utils import mesh as jmesh
from laenerf_tpu_torch.editing import VGG16_LAYOUT
from laenerf_tpu_torch.editing import distill as tdistill
from laenerf_tpu_torch.editing import vgg as tvgg
from laenerf_tpu_torch.pipeline import cli
from laenerf_tpu_torch.pipeline import driver as tdriver
from laenerf_tpu_torch.train import trainer as ttrain
from laenerf_tpu_torch.utils import mesh as tmesh
from laenerf_tpu_torch.utils.video import write_video
from test_colmap_fixture import _make_colmap_fixture
from test_torch_editing import H as EDIT_H
from test_torch_editing import (J_LCFG, _edit_views, _Images, laenerf_tree,
                                port_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 16


@pytest.fixture(scope="module")
def colmap(tmp_path_factory):
    return _make_colmap_fixture(str(tmp_path_factory.mktemp("colmap")),
                                n_train=5, H=16)


@pytest.fixture
def vgg16(tmp_path, monkeypatch):
    path = str(tmp_path / "vgg16_features.npz")
    write_vgg_npz(path, VGG16_LAYOUT, seed=3)
    monkeypatch.setenv("LAENERF_VGG16_NPZ", path)
    return path


# -- the parser -----------------------------------------------------------

def _run_script_argvs(tmp_path):
    """The argv each run script hands the CLI, for every shipped config
    and mode: scripts/run_common.sh run with a `python` on PATH that
    prints its arguments."""
    fake = tmp_path / "bin" / "python"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\nshift 2\nprintf '%s\\0' \"$@\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{fake.parent}:{os.environ['PATH']}")
    argvs = []
    for cfg in sorted(glob.glob(os.path.join(ROOT, "scripts", "configs_*",
                                             "*.sh"))):
        for mode in ("nerf", "recolor", "style"):
            out = subprocess.run(
                ["bash", os.path.join(ROOT, "scripts", "run_common.sh"), cfg,
                 "-m", mode, "--error_map", "--patch_size", "8"],
                env=env, capture_output=True, check=True, cwd=str(tmp_path))
            argvs.append(out.stdout.decode().rstrip("\0").split("\0"))
    return argvs


def test_parser_matches_jax_on_run_script_flags(tmp_path):
    argvs = _run_script_argvs(tmp_path)
    assert len(argvs) == 45
    argvs.append(["data/llff/flower", "--workspace", "ws", "-m", "recolor",
                  "--iters", "100", "--bound", "2", "--scale", "0.02",
                  "--offset", "0", "0", "1.5", "--num_palette_bases", "8",
                  "--style_layers", "10", "--style_layers", "12"])
    argvs.append(["x"])
    for argv in argvs:
        got = vars(cli.build_parser().parse_args(argv))
        assert got == vars(jcli.build_parser().parse_args(argv)), argv
    fern = vars(cli.build_parser().parse_args(argvs[
        [a[0] for a in argvs].index("./data/llff/fern")]))
    assert fern["offset"] == [0.0, 0.0, 1.5] and fern["O"]
    assert fern["error_map"] and fern["patch_size"] == 8
    style = vars(cli.build_parser().parse_args(argvs[2]))
    assert style["mode"] == "style" and style["style_layers"] == [10, 12, 14]


def test_make_configs_match_jax():
    for bound in (1.0, 2.0, 8.0):
        argv = ["x", "--bound", str(bound), "--bg_radius", "0"]
        got = cli.make_configs(cli.build_parser().parse_args(argv))
        ref = jcli.make_configs(jcli.build_parser().parse_args(argv))
        for g, r in zip(got, ref):
            for f in dataclasses.fields(g):
                assert getattr(g, f.name) == getattr(r, f.name), f.name
    m, r = cli.make_configs(cli.build_parser().parse_args(["x"]))
    assert (m.num_levels, m.level_dim, m.log2_hashmap_size) == (16, 2, 19)
    assert r.cascades == 2 and r.march_iters == r.max_steps == 1024


def test_device_selection(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LAENERF_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["unused"])
    monkeypatch.setenv("LAENERF_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        cli.select_device()
    monkeypatch.setenv("LAENERF_PLATFORM", "cpu")
    assert cli.select_device() == torch.device("cpu")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["unused", "--multihost"])


# -- patch LPIPS ----------------------------------------------------------

def test_batched_lpips_matches_jax(vgg16):
    fn_j, fn_t = jvgg.lpips_fn(), tvgg.lpips_fn(device="cpu")
    rng = np.random.RandomState(0)
    for ps in (4, 8, 16):
        a = rng.rand(3, ps, ps, 3).astype(np.float32)
        b = rng.rand(3, ps, ps, 3).astype(np.float32)
        ref = np.asarray(jax.vmap(fn_j)(jnp.asarray(a), jnp.asarray(b)))
        got = fn_t(t(a), t(b)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        one = float(fn_t(t(a[1]), t(b[1])))
        np.testing.assert_allclose(one, ref[1], rtol=1e-5)


def _patch_inds(rng, n_patch, ps):
    ix = rng.randint(0, H - ps, n_patch)
    iy = rng.randint(0, W - ps, n_patch)
    px, py = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
    gx = (ix[:, None] + px.reshape(-1)[None]).reshape(-1)
    gy = (iy[:, None] + py.reshape(-1)[None]).reshape(-1)
    return (gx * W + gy).astype(np.int32)


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


def test_train_step_patch_lpips_matches_jax(vgg16):
    ps, N = 8, 128
    tree = jax_params(70, table_scale=0.2)
    occ = blob_occupancy(71)
    pose, intr = _camera()
    rng = np.random.RandomState(72)
    inds = _patch_inds(rng, N // ps ** 2, ps)
    px = rng.rand(N, 4).astype(np.float32)
    px[:, 3] = (px[:, 3] > 0.4).astype(np.float32)
    key = jax.random.PRNGKey(73)
    k_bg, k_render, _ = jax.random.split(key, 3)
    bg = np.asarray(jax.random.uniform(k_bg, (N, 3)))
    noises = np.asarray(jax.random.uniform(k_render, (N,)))
    gt = px[:, :3] * px[:, 3:] + bg * (1.0 - px[:, 3:])
    fn_j = jvgg.lpips_fn()

    rays_o, rays_d = jtrain.get_rays(jnp.asarray(pose), jnp.asarray(intr),
                                     jnp.asarray(inds), H, W)

    def loss_fn(params, with_patch=True, rays=(rays_o, rays_d)):
        out = jren.render_rays_train(
            params, jnp.asarray(occ), *map(jnp.asarray, rays), k_render,
            model_cfg=J_MODEL_CFG, render_cfg=J_RENDER_CFG,
            bg_color=jnp.asarray(bg), perturb=True)
        loss = jnp.mean(jnp.mean((out["image"] - gt) ** 2, axis=-1))
        if with_patch:
            loss = loss + 1e-3 * jnp.mean(jax.vmap(fn_j)(
                out["image"].reshape(-1, ps, ps, 3),
                jnp.asarray(gt).reshape(-1, ps, ps, 3)))
        return loss

    params = jax.tree.map(jnp.asarray, tree)
    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    controls = [jax.tree.leaves(jax.grad(loss_fn)(params, rays=rays))
                for rays in ulp_moves(rays_o, rays_d)]
    plain_j = float(loss_fn(params, with_patch=False))
    assert abs(float(loss_j) - plain_j) > 1e-6  # the term is in the loss
    opt = jtrain.make_optimizer(1e-2, 100)
    state = jtrain.TrainState(params=params, opt_state=opt.init(params),
                              ema_params=jax.tree.map(jnp.array, params),
                              step=jnp.zeros((), jnp.int32))
    _, aux_j = jtrain.train_step(
        state, jnp.asarray(occ), jnp.asarray(pose), jnp.asarray(intr),
        jnp.asarray(inds), jnp.asarray(px), key, model_cfg=J_MODEL_CFG,
        render_cfg=J_RENDER_CFG, optimizer=opt, ema_decay=0.95,
        has_alpha=True, bg_white=False, H=H, W=W, patch_lpips_fn=fn_j,
        patch_size=ps)
    np.testing.assert_allclose(float(aux_j["loss"]), float(loss_j),
                               rtol=1e-5)

    net, ema = port_net(tree), port_net(tree).requires_grad_(False)
    topt, tsched = ttrain.make_optimizer(net.parameters(), 1e-2, 100)
    aux_t = ttrain.train_step(
        net, ema, topt, tsched, t(occ), t(pose), t(intr),
        t(inds, torch.int64), t(px), render_cfg=RENDER_CFG, ema_decay=0.95,
        has_alpha=True, bg_white=False, H=H, W=W, bg=t(bg),
        noises=t(noises), patch_lpips_fn=tvgg.lpips_fn(device="cpu"),
        patch_size=ps)
    loss_t = float(aux_t["loss"])
    assert abs(loss_t - float(loss_j)) <= 1e-3 * float(loss_j)
    grads_t = {"encoder": net.encoder.grad.numpy()}
    for name in ("sigma_net", "color_net"):
        grads_t[name] = [lin.weight.grad.numpy().T
                         for lin in getattr(net, name).layers]
    for k, (g, r) in enumerate(zip(jax.tree.leaves(grads_t),
                                   jax.tree.leaves(grads_j))):
        err = norm_err(g, r)
        bound = rounding_bound(r, [c[k] for c in controls])
        print(f"leaf {k}: grad error {err:.3e}, bound {bound:.3e}")
        assert err <= bound, f"leaf {k}: {err:.3e} > {bound:.3e}"


def test_trainer_patch_lpips_needs_vgg16(tmp_path, monkeypatch):
    monkeypatch.setenv("LAENERF_VGG16_NPZ", str(tmp_path / "missing.npz"))
    monkeypatch.setenv("HOME", str(tmp_path))
    tr = ttrain.Trainer(MODEL_CFG, RENDER_CFG, device="cpu", patch_size=8,
                        workspace=str(tmp_path / "ws"))
    assert tr.patch_lpips_fn is None
    with open(tmp_path / "ws" / "log.txt") as f:
        assert "patch LPIPS loss disabled" in f.read()
    path = str(tmp_path / "vgg16.npz")
    write_vgg_npz(path, VGG16_LAYOUT)
    monkeypatch.setenv("LAENERF_VGG16_NPZ", path)
    assert ttrain.Trainer(MODEL_CFG, RENDER_CFG, device="cpu",
                          patch_size=8).patch_lpips_fn is not None
    assert ttrain.Trainer(MODEL_CFG, RENDER_CFG,
                          device="cpu").patch_lpips_fn is None


# -- distilled error maps -------------------------------------------------

def test_distill_error_maps_match_jax():
    tree = laenerf_tree(10)
    views = _edit_views()
    edit_ds = type("EditViews", (), {"views": views})()
    images = np.random.RandomState(11).rand(4, EDIT_H, EDIT_H, 4).astype(
        np.float32)
    palette = tree["palette"]
    active = np.array([True, True, False, True])
    ds_j, ds_t = _Images(images.copy()), _Images(images.copy())
    jdistill.distill_dataset(ds_j, edit_ds, jax.tree.map(jnp.asarray, tree),
                             J_LCFG, jnp.asarray(active), palette, palette,
                             use_error_maps=True)
    tdistill.distill_dataset(ds_t, edit_ds, port_model(tree), t(active),
                             palette, palette, use_error_maps=True)
    assert ds_t.error_map.shape == (4, 128 * 128)
    np.testing.assert_array_equal(ds_t.error_map, ds_j.error_map)
    # views without edit rays keep a uniform map; edited ones do not
    assert np.all(ds_t.error_map[[1, 3]] == 1)
    for i in (0, 2):
        em = ds_t.error_map[i]
        assert em.min() >= 0.15 and em.max() <= 1 and em.min() < 1


# -- mesh and video -------------------------------------------------------

def _sphere(n=32):
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    return 1.0 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)


def test_marching_tetrahedra_and_ply_match_jax(tmp_path):
    field = _sphere()
    vj, fj = jmesh.marching_tetrahedra(field, 0.5)
    vt, ft = tmesh.marching_tetrahedra(field, 0.5)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(vt) > 100
    w = (vt / 31 * 2 - 1).astype(np.float32)
    jmesh.write_ply(str(tmp_path / "j.ply"), w, fj)
    tmesh.write_ply(str(tmp_path / "t.ply"), w, ft)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    empty = tmesh.marching_tetrahedra(np.zeros((4, 4, 4), np.float32), 0.5)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_save_density_mesh_matches_jax(tmp_path):
    tree = jax_params(74)
    jtr = SimpleNamespace(model_cfg=J_MODEL_CFG, state=SimpleNamespace(
        ema_params=jax.tree.map(jnp.asarray, tree)))
    ttr = SimpleNamespace(model_cfg=MODEL_CFG, ema_net=port_net(tree),
                          device=torch.device("cpu"))
    vj, fj = jmesh.save_density_mesh(jtr, str(tmp_path / "j.ply"),
                                     resolution=24, threshold=10.0,
                                     chunk=4096)
    vt, ft = tmesh.save_density_mesh(ttr, str(tmp_path / "t.ply"),
                                     resolution=24, threshold=10.0,
                                     chunk=4096)
    assert len(fj) > 100 and len(ft) == len(fj) and len(vt) == len(vj)
    np.testing.assert_allclose(vt, vj, atol=1e-4)
    np.testing.assert_array_equal(ft, fj)


def test_write_video_falls_back_to_frames(tmp_path, monkeypatch):
    frames = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(3)]
    import imageio.v2 as imageio

    def no_writer(*a, **k):
        raise RuntimeError("no ffmpeg")

    monkeypatch.setattr(imageio, "mimwrite", no_writer)
    out = write_video(str(tmp_path / "video.mp4"), frames)
    assert out == str(tmp_path / "video_frames")
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(out, f"{i:04d}.png"))), f)


# -- the CLI end to end ---------------------------------------------------

# a short march keeps the CPU renders of the CLI runs quick
J_CLI_RENDER_CFG = dataclasses.replace(J_RENDER_CFG, max_steps=64,
                                       march_iters=64, infer_chunk_events=16,
                                       density_thresh=10.0)
CLI_RENDER_CFG = ttrain.RenderConfig(**{
    f.name: getattr(J_CLI_RENDER_CFG, f.name)
    for f in dataclasses.fields(ttrain.RenderConfig)})


def _tiny_configs(monkeypatch):
    monkeypatch.setattr(cli, "make_configs",
                        lambda opt: (MODEL_CFG, CLI_RENDER_CFG))
    monkeypatch.setenv("LAENERF_PLATFORM", "cpu")


def test_cli_test_renders_a_jax_workspace(colmap, tmp_path, monkeypatch):
    """The slice: a JAX Trainer trains 4 steps on the colmap scene and
    saves its workspace; the port CLI's --test renders the slerp
    trajectory from it as JAX's render_image does."""
    ws = str(tmp_path / "ws")
    tr_j = jtrain.Trainer(ws, J_MODEL_CFG, J_CLI_RENDER_CFG, lr=1e-2,
                          iters=100, eval_chunk=256)
    train = JDataset(colmap, "train", num_rays=256)
    tr_j.mark_untrained(train)
    for step in range(4):
        tr_j.train_one_batch(train.get_batch(step % len(train)),
                             has_alpha=False)
    tr_j.save_checkpoint()

    _tiny_configs(monkeypatch)
    cli.main([colmap, "--workspace", ws, "--test", "--bound", "1",
              "--eval_chunk", "256"])
    test = JDataset(colmap, "test")
    assert len(test) == 11
    worst = 0
    for i, pose in enumerate(test.poses):
        ref, _ = tr_j.render_image(pose, test.intrinsics, test.H, test.W)
        ref = (np.clip(ref, 0, 1) * 255).astype(np.int32)
        got = np.asarray(Image.open(os.path.join(ws, "results",
                                                 f"{i:04d}.png")))
        worst = max(worst, int(np.abs(got.astype(np.int32) - ref).max()))
    assert worst <= 2, worst
    assert os.path.exists(os.path.join(ws, "results", "video.mp4")) or \
        len(os.listdir(os.path.join(ws, "results", "video_frames"))) == 11


def test_cli_nerf_test_and_recolor_on_cpu(colmap, tmp_path, monkeypatch):
    """-m nerf --error_map, then --test --save_mesh, then -m recolor
    --run_all --use_error_maps on the CPU, on one workspace."""
    from laenerf_tpu_torch.data import provider

    _tiny_configs(monkeypatch)
    ws = str(tmp_path / "ws")
    common = [colmap, "--workspace", ws, "--bound", "1", "--num_rays", "256",
              "--eval_chunk", "256", "--iters", "24", "--error_map"]
    updates = []
    real_update = provider.NeRFDataset.update_error_map

    def spy(self, index, inds_coarse, errors):
        updates.append(len(inds_coarse))
        return real_update(self, index, inds_coarse, errors)

    monkeypatch.setattr(provider.NeRFDataset, "update_error_map", spy)
    cli.main(common)
    assert updates == [256] * 24
    assert len(glob.glob(os.path.join(ws, "checkpoints", "*.npz"))) >= 1
    with open(os.path.join(ws, "log.txt")) as f:
        assert "[eval]" in f.read()

    cli.main(common + ["--test", "--save_mesh", "--mesh_resolution", "24"])
    frames = sorted(glob.glob(os.path.join(ws, "results", "0*.png")))
    assert len(frames) == 11
    for p in frames:
        img = np.asarray(Image.open(p))
        assert img.shape == (16, 16, 3)
    assert os.path.exists(os.path.join(ws, "results", "video.mp4")) or \
        len(os.listdir(os.path.join(ws, "results", "video_frames"))) == 11
    with open(os.path.join(ws, "mesh.ply"), "rb") as f:
        assert f.read(3) == b"ply"

    # the recolor route, with a small LAENeRF table and a region: the
    # cells of a ball around the scene's centre
    monkeypatch.setattr(tdriver, "PipelineConfig", functools.partial(
        tdriver.PipelineConfig, style_lg=12))
    from laenerf_tpu_torch.editing import EditGrid

    lattice = np.stack(np.meshgrid(*[np.linspace(-0.5, 0.5, 65)] * 3,
                                   indexing="ij"), -1).reshape(-1, 3)
    eg = EditGrid(1, CLI_RENDER_CFG.grid_size)
    eg.new_from_points(lattice[np.linalg.norm(lattice, axis=1) < 0.5]
                       .astype(np.float32))
    eg.save(str(tmp_path / "edit_grid.npz"))
    maps = []
    real_distill = tdriver.distill_dataset

    def distill_spy(dataset, *a, **k):
        stats = real_distill(dataset, *a, **k)
        maps.append(dataset.error_map.copy())
        return stats

    monkeypatch.setattr(tdriver, "distill_dataset", distill_spy)
    cli.main(common + ["-m", "recolor", "--run_all", "--use_error_maps",
                       "--ablation_dir", str(tmp_path / "abl"),
                       "--ablation_folder", "r", "--train_steps_style", "12",
                       "--distill_palette_steps", "4",
                       "--train_steps_distill", "4", "--edit_grid_path",
                       str(tmp_path / "edit_grid.npz")])
    assert len(maps) == 1 and maps[0].shape == (4, 128 * 128)
    assert maps[0].min() >= 0.15 and maps[0].min() < 1
    out = str(tmp_path / "abl" / "r")
    for f in ("style_enc.npz", "palet_mod.npz", "results_psnr_train.json",
              "render_val/000.png", "render_test/010.png"):
        assert os.path.exists(os.path.join(out, f)), f
    assert os.path.exists(os.path.join(out, "video.mp4")) or \
        len(os.listdir(os.path.join(out, "video_frames"))) == 5
    with open(os.path.join(out, "results_psnr_train.json")) as f:
        assert np.isfinite(json.load(f)["psnr_train"])
