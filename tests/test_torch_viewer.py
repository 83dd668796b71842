"""Parity of the port's viewer (laenerf_tpu_torch/pipeline/viewer.py:
OrbitCamera, EditSession) and plot_losses with the JAX package's.

The editing session runs on tests/_torch_parity.py's tiny scene trainer;
its trained parameters (through convert.py), occupancy and density grids
are handed to a JAX Trainer on the same scene.

Tolerances: the camera's pose and intrinsics within 1e-6 (the same numpy
arithmetic); a clicked point within 1e-4 (both render the distill path
with the bf16 network); the grown selection, its grow grid and the saved
grids bit for bit; the loss plot's decoded PNG pixel for pixel.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import J_MODEL_CFG, J_RENDER_CFG, tiny_scene_trainer
from _torch_parity import one_thread  # noqa: F401 (a fixture)
from laenerf_tpu.data import NeRFDataset as JNeRFDataset
from laenerf_tpu.editing import EditGrid as JEditGrid
from laenerf_tpu.pipeline import viewer as jviewer
from laenerf_tpu.train import trainer as jtrain
from laenerf_tpu.utils import plot_losses as jplot_losses
from laenerf_tpu_torch.convert import params_to_numpy
from laenerf_tpu_torch.editing import EditGrid
from laenerf_tpu_torch.pipeline import viewer as tviewer
from laenerf_tpu_torch.utils import plot_losses


def _moves(cam):
    cam.orbit(37, -12)
    cam.scale(2)
    cam.pan(30, -20, 5)
    cam.orbit(-5, 44)
    cam.scale(-1)
    cam.pan(-7, 3)


@pytest.mark.parametrize("size,radius,fovy", [((64, 48), 2.0, 50.0),
                                              ((800, 800), 3.5, 30.0)])
def test_orbit_camera_matches_jax(size, radius, fovy):
    cams = [m.OrbitCamera(*size, radius=radius, fovy=fovy)
            for m in (jviewer, tviewer)]
    for cam in cams:
        _moves(cam)
    np.testing.assert_allclose(cams[1].pose, cams[0].pose, atol=1e-6)
    np.testing.assert_allclose(cams[1].intrinsics, cams[0].intrinsics,
                               atol=1e-6)
    R = cams[1].pose[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def _sessions(tmp_path):
    """The port's EditSession on the tiny scene trainer and the JAX one on
    a JAX Trainer holding the same state. Every cell is occupied and the
    density grid is seeded noise (a few cells under the growing threshold),
    so a click's cell stays selected and the selection grows around it."""
    tr, ds, _ = tiny_scene_trainer(tmp_path)
    occ = tr.occ_state
    occ.occupancy = torch.ones_like(occ.occupancy)
    occ.density_grid = torch.tensor(np.random.RandomState(5).rand(
        *occ.density_grid.shape).astype(np.float32) - 0.02)
    occ.mean_density = occ.density_grid.mean()
    jtr = jtrain.Trainer(str(tmp_path / "jws"), J_MODEL_CFG, J_RENDER_CFG)
    params = jax.tree.map(jnp.asarray, params_to_numpy(tr.net))
    jtr.state = dataclasses.replace(
        jtr.state, params=params,
        ema_params=jax.tree.map(jnp.asarray, params_to_numpy(tr.ema_net)),
        opt_state=jtr.optimizer.init(params))
    occ = tr.occ_state
    jtr.occ_state = dataclasses.replace(
        jtr.occ_state, occupancy=jnp.asarray(occ.occupancy.numpy()),
        density_grid=jnp.asarray(occ.density_grid.numpy()),
        mean_density=jnp.asarray(float(occ.mean_density)))
    jds = JNeRFDataset(str(tmp_path / "scene"), "train")
    return (tviewer.EditSession(tr, ds), jviewer.EditSession(jtr, jds), tr)


def test_edit_session_matches_jax(tmp_path, one_thread):
    ts, js, tr = _sessions(tmp_path)
    np.testing.assert_allclose(ts.camera.pose, js.camera.pose, atol=1e-6)
    W, H = ts.camera.W, ts.camera.H
    bound = tr.render_cfg.bound
    # the centre pixel, then one beside it (the union path)
    for x, y in [(W // 2, H // 2), (W // 2 - 3, H // 2 + 2)]:
        pt, ref = ts.click_select(x, y), js.click_select(x, y)
        np.testing.assert_allclose(pt, ref, atol=1e-4)
        assert np.all(np.isfinite(pt)) and np.all(np.abs(pt) <= bound)
    np.testing.assert_array_equal(ts.edit_grid.grid, js.edit_grid.grid)
    assert len(ts.edit_grid.growing_queue) == len(js.edit_grid.growing_queue)

    ts.grow(iterations=600)
    js.grow(iterations=600)
    np.testing.assert_array_equal(ts.edit_grid.grid, js.edit_grid.grid)
    assert ts.edit_grid.grid.sum() > 2
    ts.extract_grow_grid()
    js.extract_grow_grid()
    np.testing.assert_array_equal(ts.grow_grid.grid, js.grow_grid.grid)
    assert ts.grow_grid.grid.sum() > 0
    occ = tr.occ_state.occupancy.numpy()
    assert not np.any(ts.grow_grid.grid & ~occ.astype(bool))

    paths = {}
    for name, s in (("port", ts), ("jax", js)):
        paths[name] = (str(tmp_path / f"{name}_edit.npz"),
                       str(tmp_path / f"{name}_grow.npz"))
        s.save_grids(*paths[name])
    for k in range(2):
        a = EditGrid.load(paths["port"][k])
        b = JEditGrid.load(paths["jax"][k])
        np.testing.assert_array_equal(a.grid, b.grid)
        assert (a.cascades, a.grid_size) == (b.cascades, b.grid_size)

    # the port's frames: render_image at the camera's pose, and the
    # selection view leaves the occupancy tensor in place
    img, depth = ts.render_frame(downscale=2)
    intr = ts.camera.intrinsics / 2
    intr[2], intr[3] = W // 2 / 2, H // 2 / 2
    ref, _ = tr.render_image(ts.camera.pose, intr, H // 2, W // 2)
    np.testing.assert_array_equal(img, ref)
    before = tr.occ_state.occupancy
    sel, _ = ts.render_frame(downscale=2, show_selection=True)
    assert tr.occ_state.occupancy is before
    assert sel.shape == img.shape and np.all(np.isfinite(sel))
    assert not np.array_equal(sel, img)
    ts.negative_grid.grid = ts.edit_grid.grid.copy()
    ts.carve_negative()
    assert ts.edit_grid.grid.sum() == 0


def test_launch_gui_needs_dearpygui(monkeypatch):
    monkeypatch.setitem(sys.modules, "dearpygui", None)  # import fails
    with pytest.raises(RuntimeError,
                       match=r"laenerf_tpu_torch\.pipeline\.cli"):
        tviewer.launch_gui(None, None)


def test_plot_losses_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    series = {"loss": np.exp(-np.linspace(0, 3, 50)) + 0.05 * rng.rand(50),
              "psnr": list(10 + 20 * rng.rand(31)), "empty": [],
              "single": [0.5]}
    a = plot_losses(str(tmp_path / "port.png"), series)
    b = jplot_losses(str(tmp_path / "jax.png"), series, width=640,
                     height=360)
    pa, pb = (np.asarray(Image.open(p)) for p in (a, b))
    assert pa.shape == (360, 640, 3)
    np.testing.assert_array_equal(pa, pb)
    assert np.any(pa != 255)
    c = plot_losses(str(tmp_path / "port2.png"), {"x": [1, 2, 1]},
                    width=100, height=50, colors=[(0.0, 0.0, 0.0)])
    d = jplot_losses(str(tmp_path / "jax2.png"), {"x": [1, 2, 1]},
                     width=100, height=50, colors=[(0.0, 0.0, 0.0)])
    np.testing.assert_array_equal(np.asarray(Image.open(c)),
                                  np.asarray(Image.open(d)))
    assert torch.tensor(np.asarray(Image.open(c))).min() == 0
