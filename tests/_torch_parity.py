"""Shared fixtures of the JAX-vs-port parity tests (tests/test_torch_*.py):
small configurations, seeded parameters and occupancy grids, made with
numpy and handed to both packages."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from laenerf_tpu.models import NeRFConfig as JNeRFConfig
from laenerf_tpu.models import RenderConfig as JRenderConfig
from laenerf_tpu.models import nerf_init as jnerf_init
from laenerf_tpu_torch.convert import params_from_jax
from laenerf_tpu_torch.models import NeRFConfig, RenderConfig, nerf_init

# the model of tests/test_model_render.py (every grid level hashed)
J_MODEL_CFG = JNeRFConfig(bound=1.0, num_levels=4, log2_hashmap_size=12)
J_RENDER_CFG = JRenderConfig(bound=1.0, cascades=1, grid_size=32,
                             max_steps=128, march_iters=128, m_cap_per_ray=96,
                             infer_chunk_events=8)


def port_cfg(jcfg, cls):
    """The port's config with the same field values."""
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


MODEL_CFG = port_cfg(J_MODEL_CFG, NeRFConfig)
RENDER_CFG = port_cfg(J_RENDER_CFG, RenderConfig)


def jax_params(seed=0, table_scale=0.5):
    """JAX-initialised params with the table and weights spread wide enough
    that density and color vary across the scene; numpy leaves."""
    params = jnerf_init(jax.random.PRNGKey(seed), J_MODEL_CFG)
    rng = np.random.RandomState(seed)
    tree = {
        "encoder": rng.uniform(-table_scale, table_scale,
                               params["encoder"].shape).astype(np.float32),
        "sigma_net": [4.0 * np.asarray(w) for w in params["sigma_net"]],
        "color_net": [2.0 * np.asarray(w) for w in params["color_net"]],
    }
    return tree


def port_net(tree, cfg=MODEL_CFG):
    net = nerf_init(cfg, device="cpu")
    net.load_state_dict(params_from_jax(tree))
    return net


def blob_occupancy(seed=0, H=32, cas=1):
    rng = np.random.RandomState(seed)
    occ = (rng.rand(cas, H, H, H) > 0.8).astype(np.uint8)
    occ[:, H // 4:3 * H // 4, H // 4:3 * H // 4, H // 3:2 * H // 3] = 1
    return occ


def camera_rays(seed, n, spread=0.5):
    rng = np.random.RandomState(seed)
    eye = np.array([0.2, -0.3, -2.5], np.float32)
    tgt = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = tgt - eye
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(eye, d.shape).copy(), d


def t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def write_vgg_npz(path, layout, seed=0):
    """A synthetic VGG npz in torchvision's `features.state_dict()` layout
    (the recipe of tests/test_vgg_weights.py)."""
    from laenerf_tpu.editing.vgg import _layer_indices

    rng = np.random.RandomState(seed)
    arrays = {}
    cin = 3
    for i, (kind, cout) in enumerate(_layer_indices(layout)):
        if kind != "conv":
            continue
        arrays[f"{i}.weight"] = rng.randn(cout, cin, 3, 3).astype(
            np.float32) * 0.05
        arrays[f"{i}.bias"] = rng.randn(cout).astype(np.float32) * 0.01
        cin = cout
    np.savez(path, **arrays)
    return arrays


def max_rel_err(got, ref):
    """max |got - ref| over max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def norm_err(got, ref):
    """||got - ref|| over ||ref|| (Frobenius norms, float64)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def ulp_moves(*arrays):
    """The inputs of a rounding control: for each array in turn, the
    arrays with that one moved one float32 ulp up, then one down (the
    others as given); 2 * len(arrays) tuples of float32 arrays."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    out = []
    for i, a in enumerate(arrays):
        for toward in (np.inf, -np.inf):
            moved = list(arrays)
            moved[i] = np.nextafter(a, np.float32(toward))
            out.append(tuple(moved))
    return out


def rounding_bound(ref, controls, factor=2.0):
    """The norm-wise bound that a rounding control supports: `factor`
    times the largest norm_err of the controls (the reference rerun with
    one float32 rounding moved) against the reference itself."""
    return factor * max(norm_err(c, ref) for c in controls)


def tiny_scene_trainer(tmp_path, seed=51, H=24, W=24, n_train=3, steps=4):
    """The port's Trainer on a tiny procedural scene (CPU): seeded params,
    the blob occupancy grid, then a few train steps. Returns (trainer,
    train split, test split)."""
    from laenerf_tpu_torch.data import NeRFDataset, generate_synthetic_scene
    from laenerf_tpu_torch.train import Trainer

    scene = str(tmp_path / "scene")
    generate_synthetic_scene(scene, n_train=n_train, n_val=0, n_test=1, H=H,
                             W=W, device="cpu")
    ds = NeRFDataset(scene, "train", num_rays=256)
    test = NeRFDataset(scene, "test")
    tr = Trainer(MODEL_CFG, RENDER_CFG, device="cpu",
                 workspace=str(tmp_path / "ws"))
    tr.net.load_state_dict(params_from_jax(jax_params(seed)))
    tr.ema_net.load_state_dict(tr.net.state_dict())
    occ = blob_occupancy(seed + 1)
    tr.occ_state.occupancy = t(occ)
    tr.occ_state.density_grid = t(occ.astype(np.float32))
    tr.occ_state.mean_density = torch.tensor(float(occ.mean()))
    tr.occ_state.iter_density = 16
    tr.global_step = 1
    for step in range(steps):
        tr.train_one_batch(ds.get_batch(step % len(ds)), has_alpha=True)
    return tr, ds, test


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of thousands of small ops: with every
    test worker's threads on all cores they contend (in one parallel run
    of the suite the gates' end-to-end test took 364 s on all threads;
    alone it takes 15 s on all and 28 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
