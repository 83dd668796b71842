"""The port's checkpoints (laenerf_tpu_torch/train/checkpoints.py and
Trainer.save_checkpoint / load_checkpoint) and their exchange with the JAX
package's.

Tolerances: a port save -> load round-trip restores every parameter, the
EMA, the Adam moments, the learning rate, the occupancy state and the step
exactly, so the next step's loss and a render are equal (within 1e-6). A
JAX Trainer state saved by the JAX save_pytree and read with
load_jax_checkpoint (numpy only) or Trainer.load_checkpoint renders as the
JAX trainer does at 2e-3 (bf16 network on both sides, as in
test_torch_trainer.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, MODEL_CFG, RENDER_CFG,
                           blob_occupancy, jax_params, t)
from laenerf_tpu.train import checkpoints as jckpt
from laenerf_tpu.train import trainer as jtrain
from laenerf_tpu_torch.convert import load_jax_checkpoint, params_from_jax
from laenerf_tpu_torch.train import trainer as ttrain
from laenerf_tpu_torch.train.checkpoints import load_pytree, save_pytree

H = W = 16
RCFG = dataclasses.replace(RENDER_CFG, infer_chunk_events=16)
J_RCFG = dataclasses.replace(J_RENDER_CFG, infer_chunk_events=16)


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


def _batch(seed):
    rng = np.random.RandomState(seed)
    pose, intr = _camera()
    px = rng.rand(128, 4).astype(np.float32)
    px[:, 3] = (px[:, 3] > 0.4).astype(np.float32)
    return {"pose": pose, "intrinsics": intr, "H": H, "W": W,
            "inds": rng.randint(0, H * W, 128).astype(np.int32),
            "pixels": px}


def _port_trainer(ws=None, seed=0):
    tr = ttrain.Trainer(MODEL_CFG, RCFG, device="cpu", workspace=ws,
                        max_keep_ckpt=2, iters=50, seed=seed)
    tree = jax_params(60)
    tr.net.load_state_dict(params_from_jax(tree))
    tr.ema_net.load_state_dict(params_from_jax(tree))
    occ = blob_occupancy(61)
    tr.occ_state.occupancy = t(occ)
    tr.occ_state.density_grid = t(occ.astype(np.float32) * 3.0)
    tr.occ_state.mean_density = torch.tensor(0.7)
    tr.occ_state.iter_density = 20
    return tr


def test_save_load_roundtrip_with_max_keep_and_best(tmp_path):
    ws = str(tmp_path / "ws")
    tr = _port_trainer(ws)
    tr.global_step = 1  # no occupancy refresh in these steps
    paths = []
    for i, metric in enumerate((10.0, 5.0, 20.0)):
        tr.train_one_batch(_batch(i), has_alpha=True)
        paths.append(tr.save_checkpoint(best_metric=metric))
    ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
    assert [os.path.basename(p) for p in paths[1:]] == [
        c for c in ckpts if "_step" in c and c.endswith(".npz")]
    assert not os.path.exists(paths[0])  # rolled off (max_keep = 2)
    assert tr.ckpt.best_metric == 20.0
    _, meta = load_pytree(tr.ckpt.best(), tr._ckpt_tree())
    assert meta == {"global_step": 4, "best_metric": 20.0}

    fresh = _port_trainer(ws, seed=5)
    fresh.net.encoder.data.zero_()
    assert fresh.load_checkpoint("latest")
    assert fresh.global_step == tr.global_step == 4
    for a, b in ((fresh.net, tr.net), (fresh.ema_net, tr.ema_net)):
        for (n, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), n
    for p, q in zip(fresh.net.parameters(), tr.net.parameters()):
        sa, sb = fresh.optimizer.state[p], tr.optimizer.state[q]
        assert float(sa["step"]) == float(sb["step"]) == 3
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k])
    assert fresh.optimizer.param_groups[0]["lr"] == \
        tr.optimizer.param_groups[0]["lr"]
    for k in ("density_grid", "occupancy", "mean_density"):
        assert torch.equal(getattr(fresh.occ_state, k),
                           getattr(tr.occ_state, k)), k
    assert fresh.occ_state.iter_density == tr.occ_state.iter_density

    # the next step and a render agree
    bg = torch.rand(128, 3, generator=torch.Generator().manual_seed(1))
    noises = torch.rand(128, generator=torch.Generator().manual_seed(2))
    losses = [float(x._step(_batch(9), True, bg=bg, noises=noises)["loss"])
              for x in (tr, fresh)]
    assert abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[0])
    pose, intr = _camera()
    a, _ = tr.render_image(pose, intr, H, W)
    b, _ = fresh.render_image(pose, intr, H, W)
    np.testing.assert_allclose(a, b, atol=1e-6)

    # best mode, and a trainer with no checkpoint
    assert fresh.load_checkpoint("best") and fresh.global_step == 4
    assert not _port_trainer(str(tmp_path / "empty")).load_checkpoint()


def test_jax_checkpoint_renders_the_same(tmp_path):
    tree = jax_params(62)
    occ = blob_occupancy(63)
    tr_j = jtrain.Trainer(str(tmp_path / "jws"), J_MODEL_CFG, J_RCFG)
    params = jax.tree.map(jnp.asarray, tree)
    tr_j.state = dataclasses.replace(
        tr_j.state, params=jax.tree.map(lambda a: 0.5 * a, params),
        ema_params=params, opt_state=tr_j.optimizer.init(params),
        step=jnp.int32(7))
    tr_j.occ_state = dataclasses.replace(
        tr_j.occ_state, occupancy=jnp.asarray(occ),
        density_grid=jnp.asarray(occ.astype(np.float32)),
        mean_density=jnp.float32(0.25), iter_density=jnp.int32(5))
    path = str(tmp_path / "jax_ckpt.npz")
    jckpt.save_pytree(path, {"state": tr_j.state, "occ": tr_j.occ_state},
                      {"global_step": 7})
    pose, intr = _camera()
    img_j, _ = tr_j.render_image(pose, intr, H, W)

    ck = load_jax_checkpoint(path)
    assert ck["step"] == 7 and ck["occ"]["occupancy"].dtype == np.uint8
    tr_t = ttrain.Trainer(MODEL_CFG, RCFG, device="cpu")
    tr_t.ema_net.load_state_dict(ck["ema_params"])
    tr_t.occ_state.occupancy = t(ck["occ"]["occupancy"])
    img_t, _ = tr_t.render_image(pose, intr, H, W)
    assert np.std(img_j) > 0.02
    np.testing.assert_allclose(img_t, img_j, atol=2e-3)

    # Trainer.load_checkpoint takes the JAX file as it is ...
    tr_l = ttrain.Trainer(MODEL_CFG, RCFG, device="cpu",
                          workspace=str(tmp_path / "tws"))
    assert tr_l.load_checkpoint(path) and tr_l.global_step == 7
    assert tr_l.occ_state.iter_density == 5
    torch.testing.assert_close(tr_l.net.encoder,
                               torch.tensor(0.5 * tree["encoder"]))
    img_l, _ = tr_l.render_image(pose, intr, H, W)
    np.testing.assert_allclose(img_l, img_t, atol=1e-6)
    # ... and the JAX package reads the port's checkpoints by the same keys
    port_path = tr_l.save_checkpoint()
    back, meta = jckpt.load_pytree(port_path, {"state": tr_j.state,
                                               "occ": tr_j.occ_state})
    assert meta["global_step"] == 7
    for a, b in zip(jax.tree.leaves(back["state"].ema_params),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_save_pytree_keys_are_jax_keystrs(tmp_path):
    from types import SimpleNamespace

    tree = {"state": SimpleNamespace(params={"b": np.ones(2), "a": [
        np.zeros(3), np.arange(2)]}, step=np.int32(3)), "occ": (np.ones(1),)}
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree, {"k": 1})
    with np.load(path) as z:
        keys = sorted(z.files)
    assert keys == ["['occ'][0]", "['state'].params['a'][0]",
                    "['state'].params['a'][1]", "['state'].params['b']",
                    "['state'].step"]
    back, meta = load_pytree(path, tree)
    assert meta == {"k": 1} and int(back["state"].step) == 3
    np.testing.assert_array_equal(back["state"].params["a"][1], np.arange(2))
