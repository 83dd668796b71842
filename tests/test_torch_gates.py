"""Parity of the port's lego-class scene and eval scripts with the JAX
package's and the repository's scripts/, and the port's gate scripts
(laenerf_tpu_torch/scripts/) end to end on a tiny CPU run.

Tolerances:
  * lego_class_scene(): equal lists.
  * scene_density_color: densities and which primitive colors a point
    exactly; the colors exactly too, except that a textured color takes
    torch's float32 sin where the reference takes NumPy's, and the two
    differ in the last bit for about a sixth of the arguments: those colors
    within 2 float32 ulps (1.2e-7 on values below 1).
  * the lego scene's generated views: within one 8-bit level of JAX's
    generate_synthetic_scene (float32 quadrature in another order, as in
    tests/test_torch_data.py).
  * consistency_metrics (block_flow, warp, evaluate) and
    mse_background.evaluate: equal to the scripts/eval/ originals, loaded
    by path, on the same files (the same numpy arithmetic; the image files
    are read with Pillow, imageio's backend).
  * the gates: each writes its JSON with the JAX script's keys (read from
    the script's own source) and finite values.
"""

import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import one_thread  # noqa: F401 (a fixture)
from laenerf_tpu.data import generate_synthetic_scene as jgenerate
from laenerf_tpu.data import synthetic as jsyn
from laenerf_tpu_torch.data import generate_synthetic_scene
from laenerf_tpu_torch.data import synthetic as tsyn
from laenerf_tpu_torch.scripts import quality_gate, recolor_gate
from laenerf_tpu_torch.scripts.eval import (consistency_metrics,
                                            mse_background, render_orbit)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _original(rel):
    """A numpy-only script of the repository's scripts/, loaded by path."""
    path = os.path.join(ROOT, rel)
    spec = importlib.util.spec_from_file_location(
        "orig_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys(rel, name):
    """The keys of the dict literal assigned to `name` in a script."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise LookupError(f"no dict literal {name} in {rel}")


def test_lego_class_scene_is_the_same():
    prims = tsyn.lego_class_scene()
    assert prims == jsyn.lego_class_scene()
    assert len(prims) == 19
    assert {p[0] for p in prims} == {"box", "shell"}


@pytest.mark.parametrize("scene", ["spheres", "lego"])
def test_scene_density_color_matches_jax(scene):
    prims = None if scene == "spheres" else jsyn.lego_class_scene()
    pts = np.random.RandomState(6).uniform(-0.7, 0.7, (4096, 3)).astype(
        np.float32)
    ref_sigma, ref_color = jsyn.scene_density_color(pts, prims)
    sigma, color = tsyn.scene_density_color(pts, prims, device="cpu")
    assert sigma.dtype == color.dtype == torch.float32
    np.testing.assert_array_equal(sigma.numpy(), ref_sigma)
    inside = ref_sigma > 0
    assert 0.05 < inside.mean() < 0.5
    color = color.numpy()
    np.testing.assert_array_equal(color[~inside], ref_color[~inside])
    if prims is None:  # untextured: every color exact
        np.testing.assert_array_equal(color, ref_color)
    else:
        np.testing.assert_allclose(color, ref_color, rtol=0, atol=1.2e-7)
        assert np.mean(color == ref_color) > 0.9


def test_lego_scene_render_matches_jax(tmp_path):
    kw = dict(n_train=2, n_val=0, n_test=0, H=10, W=12, aa=2,
              spheres=jsyn.lego_class_scene())
    roots = (jgenerate(str(tmp_path / "jax"), **kw),
             generate_synthetic_scene(str(tmp_path / "port"), device="cpu",
                                      **kw))
    metas, imgs = [], []
    for root in roots:
        with open(os.path.join(root, "transforms_train.json")) as f:
            metas.append(json.load(f))
        imgs.append(np.stack([
            np.asarray(Image.open(os.path.join(root, fr["file_path"]
                                               + ".png")))
            for fr in metas[-1]["frames"]]).astype(np.int32))
    assert metas[0] == metas[1]
    assert imgs[1].shape == imgs[0].shape == (2, 10, 12, 4)
    assert np.abs(imgs[1] - imgs[0]).max() <= 1
    assert imgs[0][..., 3].max() > 200  # the scene is in view


def _frames(tmp_path, n=4, H=36, W=44):
    """Frames of a smooth pattern drifting a few pixels a frame."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = tmp_path / "frames"
    out.mkdir()
    for k in range(n):
        u = xx - 1.5 * k
        img = np.stack([0.5 + 0.5 * np.sin(u / 3.0 + yy / 5.0),
                        0.5 + 0.5 * np.cos(u / 4.0 - yy / 7.0),
                        (u * 7 + yy * 3) % 17 / 17.0], -1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            str(out / f"f_{k:04d}.png"))
    return str(out)


def test_consistency_metrics_match_original(tmp_path):
    orig = _original("scripts/eval/consistency_metrics.py")
    frames = _frames(tmp_path)
    a, b = (consistency_metrics._load(os.path.join(frames, f))
            for f in ("f_0000.png", "f_0001.png"))
    np.testing.assert_array_equal(
        a, orig._load(os.path.join(frames, "f_0000.png")))
    flow = consistency_metrics.block_flow(a, b)
    np.testing.assert_array_equal(flow, orig.block_flow(a, b))
    assert np.any(flow != 0)
    np.testing.assert_array_equal(consistency_metrics.warp(b, flow),
                                  orig.warp(b, flow))
    for step in (1, 2):
        got = consistency_metrics.evaluate(frames, step=step)
        assert got == orig.evaluate(frames, step=step)
        assert got["n_pairs"] == 4 - step and got["lpips_mean"] is None
    # precomputed flows (the RAFT protocol), one pair without a backward
    flows = tmp_path / "flows"
    flows.mkdir()
    rng = np.random.RandomState(7)
    for i in range(3):
        np.save(flows / f"flow_{i:04d}_1.npy",
                rng.uniform(-3, 3, (36, 44, 2)).astype(np.float32))
        if i != 1:
            np.save(flows / f"flowb_{i:04d}_1.npy",
                    rng.uniform(-3, 3, (36, 44, 2)).astype(np.float32))
    saved = str(tmp_path / "cm.json")
    got = consistency_metrics.evaluate(frames, 1, str(flows), saved)
    assert got == orig.evaluate(frames, 1, str(flows))
    with open(saved) as f:
        assert json.load(f) == got


def test_mse_background_matches_original(tmp_path):
    orig = _original("scripts/eval/mse_background.py")
    rng = np.random.RandomState(8)
    scene = tmp_path / "data" / "synthetic" / "toy"
    (scene / "test").mkdir(parents=True)
    renders, masks = tmp_path / "renders", tmp_path / "masks"
    renders.mkdir()
    masks.mkdir()
    frames = []
    for k in range(3):
        gt = (rng.rand(20, 24, 4) * 255).astype(np.uint8)
        Image.fromarray(gt).save(str(scene / "test" / f"r_{k}.png"))
        frames.append({"file_path": f"./test/r_{k}"})
        # one render at half resolution (resized to the reference's)
        hw = (10, 12) if k == 1 else (20, 24)
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
            str(renders / f"{k:03d}.png"))
        m = np.zeros((20, 24, 3), np.uint8)
        m[4:12, 6:18, 1] = 255
        Image.fromarray(m).save(str(masks / f"{k:03d}.png"))
    with open(scene / "transforms_test.json", "w") as f:
        json.dump({"frames": frames}, f)
    kw = dict(results_dir=str(renders), scene="toy", datatype="synthetic",
              data_root=str(tmp_path / "data"), masks_root=str(masks))
    got = mse_background.evaluate(save_dir=str(tmp_path / "port"), **kw)
    ref = orig.evaluate(save_dir=str(tmp_path / "orig"), **kw)
    assert got == ref
    assert len(got["errors"]) == 3 and 0 < got["mean"] < 1
    for k in range(3):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / f"error_{k:03d}.png")),
            np.asarray(Image.open(tmp_path / "orig" / f"error_{k:03d}.png")))


def _finite(values):
    for v in values:
        if isinstance(v, dict):
            _finite(v.values())
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            assert math.isfinite(v), v


def _opaque_scene(tr, dataset):
    """The checkpoint's NeRF made an opaque copy of the analytic lego-class
    scene: its occupancy and density grids hold the scene's densities at
    the grid's cells (model space -> blender world: (x, y, z) -> (z, x, y)
    / scale), and its density is e^4 wherever it is sampled (a constant
    table, non-negative first layer, the output row scaled to 4)."""
    from laenerf_tpu_torch.models.occupancy import _all_coords

    G = tr.render_cfg.grid_size
    c = _all_coords(G, "cpu").float()
    xyz = (2.0 * c / (G - 1) - 1.0) * (1.0 - 1.0 / G)
    world = (xyz - torch.tensor(dataset.offset)) / dataset.scale
    sigma, _ = tsyn.scene_density_color(world[:, [2, 0, 1]],
                                        tsyn.lego_class_scene(), device="cpu")
    grid = sigma.reshape(1, G, G, G)
    tr.occ_state.density_grid = grid
    tr.occ_state.occupancy = (grid > 0).to(torch.uint8)
    tr.occ_state.mean_density = grid.mean()
    with torch.no_grad():
        for net in (tr.net, tr.ema_net):
            net.encoder.fill_(0.5)
            first, last = net.sigma_net.layers[0], net.sigma_net.layers[-1]
            first.weight.abs_()
            hidden = torch.relu(first.weight @ torch.full(
                (first.weight.shape[1],), 0.5))
            last.weight[0] = 4.0 * hidden / hidden.square().sum()
    tr.save_checkpoint()


def test_gates_end_to_end_on_cpu(tmp_path, monkeypatch, one_thread):
    """quality_gate, recolor_gate and render_orbit's main on one workspace
    with LAENERF_PLATFORM=cpu, at a tiny model and budget."""
    from laenerf_tpu_torch.data import NeRFDataset
    from laenerf_tpu_torch.train import Trainer

    monkeypatch.setenv("LAENERF_PLATFORM", "cpu")
    ws = str(tmp_path / "gate")
    model = ["--num_levels", "2", "--level_dim", "2", "--max_steps", "64"]
    assert quality_gate.main(["--workspace", ws, "--iters", "4", "--n_train",
                              "2", "--H", "16", "--aa", "1", "--lg", "10"]
                             + model) == 0
    with open(os.path.join(ws, "quality_gate.json")) as f:
        q = json.load(f)
    assert set(q) == _dict_keys("scripts/quality_gate.py", "result")
    _finite(q.values())
    assert q["device"] == "cpu" and q["test_lpips"] is None
    assert 0 < q["test_ssim"] <= 1 and q["iters"] == 4

    # after 4 steps the NeRF's faint density fills the box and hides the
    # blue shell from every view, so the gate would find no edit dataset:
    # the checkpoint becomes an opaque copy of the scene
    args = quality_gate.build_parser().parse_args(["--lg", "10"] + model)
    tr = Trainer(*quality_gate.make_configs(args), device="cpu",
                 workspace=os.path.join(ws, "ws"))
    assert tr.load_checkpoint("latest")
    _opaque_scene(tr, NeRFDataset(os.path.join(ws, "scene"), "train"))
    assert recolor_gate.main(["--workspace", ws, "--style_steps", "8",
                              "--distill_steps", "2", "--palette_steps", "4",
                              "--style_lg", "10", "--lg", "10"] + model) == 0
    with open(os.path.join(ws, "recolor_ws", "recolor_gate.json")) as f:
        r = json.load(f)
    assert set(r) == _dict_keys("scripts/recolor_gate.py", "summary")
    _finite(r.values())
    assert r["mode"] == "recolor" and r["bg_mse"] >= 0
    assert set(r["timings"]) >= {"edit_dataset", "train_style_enc",
                                 "distill_nerf"}

    out = str(tmp_path / "orbit.json")
    assert render_orbit.main(["--workspace", ws, "--frames", "3", "--H",
                              "16", "--step", "1", "--save_json", out,
                              "--log2_hashmap_size", "10"] + model) == 0
    with open(out) as f:
        o = json.load(f)
    assert set(o) == _dict_keys("scripts/eval/render_orbit.py",
                                "results") | {"step_1"}
    assert set(o["step_1"]) == _dict_keys(
        "scripts/eval/consistency_metrics.py", "result")
    assert o["step_1"]["n_pairs"] == 2
    _finite(o.values())
    assert len(os.listdir(os.path.join(ws, "orbit_frames"))) == 3


@pytest.mark.parametrize("script", [quality_gate, recolor_gate,
                                    render_orbit])
def test_gate_scripts_need_a_gpu(script, monkeypatch, tmp_path):
    """Without LAENERF_PLATFORM=cpu the scripts run on the GPU only: with
    none they raise before touching the workspace."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the scripts would run on it")
    monkeypatch.delenv("LAENERF_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(["--workspace", str(tmp_path / "ws")])
    assert not os.path.exists(tmp_path / "ws")
