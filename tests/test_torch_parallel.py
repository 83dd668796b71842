"""Parity of the port's ray data-parallelism (laenerf_tpu_torch/parallel/)
with the JAX package's mesh step and render, on the CPU.

Ranks are processes of torch.multiprocessing.spawn in a gloo group that
meets through a file:// rendezvous under tmp_path (tests/
_torch_dp_worker.py). JAX's dp_train_step runs on make_mesh(2) and
make_mesh(4) of the 8 CPU devices; each rank gets JAX's own march noises
of its shard (fold_in(k_render, rank)) and the batch's background.

Tolerances: the loss at 2e-2 relative and each gradient leaf norm-wise
within twice the largest error of the rounding control against JAX (JAX's
mean gradient with its rays moved one float32 ulp; a bf16 network on both
sides, tests/test_torch_trainer.py says why); against the port's own
single-process step
on the same noises, the loss and per-ray errors at 1e-5 and the table
gradient at 1e-4 relative (only f32 summation orders differ), the MLP
weight gradients at 2e-2 (each shard's bf16 weight gradient is rounded
before the average); every rank ends with bit-equal
parameters. The sharded render within 2e-3 of the single-process one (the
JAX test's own tolerance).
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dp_worker
from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, MODEL_CFG, RENDER_CFG,
                           blob_occupancy, jax_params, max_rel_err, norm_err,
                           port_net, rounding_bound, t, ulp_moves)
from laenerf_tpu.models import renderer as jren
from laenerf_tpu.parallel import dp_train_step as j_dp_train_step
from laenerf_tpu.parallel import make_mesh as j_make_mesh
from laenerf_tpu.train import trainer as jtrain
from laenerf_tpu_torch.convert import params_from_jax
from laenerf_tpu_torch.parallel import Mesh, shard_batch
from laenerf_tpu_torch.train import trainer as ttrain

H = W = 16
N_RAYS = 128


def _camera(dist_=2.4, size=16):
    eye = np.array([0.4, -0.5, -dist_], np.float32)
    f = -eye / np.linalg.norm(eye)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    u = np.cross(f, r)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([r, u, f], axis=1)
    pose[:3, 3] = eye
    s = size / 16
    return pose, np.array([14.0 * s, 14.0 * s, size / 2, size / 2],
                          np.float32)


def _spawn(fn, world_size, tmp_path, job):
    job_path = str(tmp_path / "job.pt")
    torch.save(job, job_path)
    torch.multiprocessing.spawn(
        fn, args=(world_size, str(tmp_path / "rendezvous"), job_path,
                  str(tmp_path / "rank")), nprocs=world_size, join=True)
    return [dict(np.load(tmp_path / f"rank{r}.npz"))
            for r in range(world_size)]


@pytest.mark.parametrize("world_size", [2, 4])
def test_dp_train_step_matches_jax(world_size, tmp_path):
    tree = jax_params(20, table_scale=0.2)
    occ = blob_occupancy(21)
    pose, intr = _camera()
    rng = np.random.RandomState(30)
    inds = rng.randint(0, H * W, N_RAYS).astype(np.int32)
    px = rng.rand(N_RAYS, 4).astype(np.float32)
    px[:, 3] = (px[:, 3] > 0.4).astype(np.float32)
    key = jax.random.PRNGKey(40)
    k_bg, k_render, _ = jax.random.split(key, 3)
    bg = np.asarray(jax.random.uniform(k_bg, (N_RAYS, 3)))
    shard = N_RAYS // world_size
    noises = [np.asarray(jax.random.uniform(jax.random.fold_in(k_render, r),
                                            (shard,)))
              for r in range(world_size)]

    # JAX: the mean of the shards' gradients that the mesh step applies
    params = jax.tree.map(jnp.asarray, tree)
    rays_o, rays_d = jtrain.get_rays(jnp.asarray(pose), jnp.asarray(intr),
                                     jnp.asarray(inds), H, W)
    gt = px[:, :3] * px[:, 3:] + bg * (1.0 - px[:, 3:])

    def mean_grads(rays_o, rays_d):
        grads = []
        for r in range(world_size):
            s = slice(r * shard, (r + 1) * shard)

            def loss_fn(p, s=s, r=r):
                out = jren.render_rays_train(
                    p, jnp.asarray(occ), jnp.asarray(rays_o[s]),
                    jnp.asarray(rays_d[s]), jax.random.fold_in(k_render, r),
                    model_cfg=J_MODEL_CFG, render_cfg=J_RENDER_CFG,
                    bg_color=jnp.asarray(bg[s]), perturb=True)
                return jnp.mean(jnp.mean((out["image"] - gt[s]) ** 2,
                                         axis=-1))

            grads.append(jax.grad(loss_fn)(params))
        return jax.tree.map(lambda *g: sum(g) / world_size, *grads)

    grads_j = mean_grads(rays_o, rays_d)
    controls = [mean_grads(*rays) for rays in ulp_moves(rays_o, rays_d)]
    # JAX's mesh step (it donates its state: a copy of the params)
    opt = jtrain.make_optimizer(1e-2, 100)
    p0 = jax.tree.map(jnp.array, params)
    state = jtrain.TrainState(params=p0, opt_state=opt.init(p0),
                              ema_params=jax.tree.map(jnp.array, params),
                              step=jnp.zeros((), jnp.int32))
    _, aux_j = j_dp_train_step(
        j_make_mesh(world_size), jtrain.train_step, state, jnp.asarray(occ),
        jnp.asarray(pose), jnp.asarray(intr), jnp.asarray(inds),
        jnp.asarray(px), key, model_cfg=J_MODEL_CFG,
        render_cfg=J_RENDER_CFG, optimizer=opt, ema_decay=0.95,
        has_alpha=True, bg_white=False, H=H, W=W)

    job = {"model_cfg": MODEL_CFG, "render_cfg": RENDER_CFG,
           "state_dict": params_from_jax(tree), "occ": t(occ),
           "pose": t(pose), "intr": t(intr), "inds": t(inds, torch.int64),
           "pixels": t(px), "bg": t(bg), "noises": [t(n) for n in noises],
           "H": H, "W": W}
    ranks = _spawn(_torch_dp_worker.train, world_size, tmp_path, job)
    for other in ranks[1:]:
        for k in ranks[0]:
            if k != "per_ray_error" and not k.startswith("loss"):
                np.testing.assert_array_equal(other[k], ranks[0][k], k)
    got = ranks[0]
    assert got["per_ray_error"].shape == (N_RAYS,)
    np.testing.assert_allclose(float(got["loss"]), float(aux_j["loss"]),
                               rtol=2e-2)

    def by_name(grads):
        out = {"encoder": np.asarray(grads["encoder"])}
        for name in ("sigma_net", "color_net"):
            for i, g in enumerate(grads[name]):
                out[f"{name}.layers.{i}.weight"] = np.asarray(g).T
        return out

    ref, controls = by_name(grads_j), [by_name(c) for c in controls]
    for name, r in ref.items():
        assert np.abs(r).max() > 0
        err = norm_err(got["grad." + name], r)
        bound = rounding_bound(r, [c[name] for c in controls])
        print(f"{name}: grad error {err:.3e}, bound {bound:.3e}")
        assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"

    # the port's own single-process step on the same rays and noises
    net, ema = port_net(tree), port_net(tree).requires_grad_(False)
    topt, tsched = ttrain.make_optimizer(net.parameters(), 1e-2, 100)
    aux_t = ttrain.train_step(
        net, ema, topt, tsched, t(occ), t(pose), t(intr),
        t(inds, torch.int64), t(px), render_cfg=RENDER_CFG, ema_decay=0.95,
        has_alpha=True, bg_white=False, H=H, W=W, bg=t(bg),
        noises=t(np.concatenate(noises)))
    np.testing.assert_allclose(float(got["loss"]), float(aux_t["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["per_ray_error"],
                               aux_t["per_ray_error"].numpy(), rtol=1e-5,
                               atol=1e-7)
    for name, p in net.named_parameters():
        tol = 1e-4 if name == "encoder" else 2e-2
        assert max_rel_err(got["grad." + name], p.grad.numpy()) < tol, name


def test_dp_render_image_matches_single_process(tmp_path):
    """World size 2 on a 23x23 frame (529 pixels: one padded ray)."""
    from laenerf_tpu_torch.train import Trainer

    tree = jax_params(22)
    occ = blob_occupancy(23)
    size = 23
    pose, intr = _camera(2.2, size)
    render_cfg = dataclasses.replace(RENDER_CFG, infer_chunk_events=16)
    tr = Trainer(MODEL_CFG, render_cfg, device="cpu", eval_chunk=128)
    tr.ema_net.load_state_dict(params_from_jax(tree))
    tr.occ_state.occupancy = t(occ)
    img1, d1 = tr.render_image(pose, intr, size, size)
    job = {"model_cfg": MODEL_CFG, "render_cfg": render_cfg,
           "state_dict": params_from_jax(tree), "occ": t(occ),
           "pose": pose, "intr": intr, "H": size, "W": size, "chunk": 100}
    ranks = _spawn(_torch_dp_worker.render, 2, tmp_path, job)
    np.testing.assert_array_equal(ranks[0]["image"], ranks[1]["image"])
    assert ranks[0]["image"].shape == (size, size, 3)
    assert np.std(img1) > 0.02
    np.testing.assert_allclose(ranks[0]["image"], img1, atol=2e-3)
    np.testing.assert_allclose(ranks[0]["depth"], d1, atol=2e-3)


def test_shard_batch():
    x = torch.arange(12).reshape(6, 2)
    assert shard_batch(Mesh(1, 3, torch.device("cpu")), x).tolist() == \
        [[4, 5], [6, 7]]
    with pytest.raises(ValueError, match="equal shards"):
        shard_batch(Mesh(0, 4, torch.device("cpu")), x)


def test_cli_multihost_joins_the_torchrun_group(tmp_path, monkeypatch):
    """--multihost joins the group a one-process torchrun env describes
    (gloo on the CPU) and trains."""
    from laenerf_tpu_torch.parallel import destroy_mesh
    from laenerf_tpu_torch.pipeline import cli
    from test_colmap_fixture import _make_colmap_fixture

    colmap = _make_colmap_fixture(str(tmp_path / "colmap"), n_train=5, H=16)
    rcfg = dataclasses.replace(RENDER_CFG, max_steps=64, march_iters=64,
                               infer_chunk_events=16, density_thresh=10.0)
    monkeypatch.setattr(cli, "make_configs", lambda opt: (MODEL_CFG, rcfg))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("LAENERF_PLATFORM", "cpu"), ("RANK", "0"),
                 ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(port))):
        monkeypatch.setenv(k, v)
    ws = str(tmp_path / "ws")
    assert not dist.is_initialized()
    try:
        cli.main([colmap, "--workspace", ws, "--bound", "1", "--num_rays",
                  "128", "--eval_chunk", "256", "--iters", "4",
                  "--multihost"])
        assert dist.is_initialized()
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
    finally:
        destroy_mesh()
    assert any(f.endswith(".npz") for f in os.listdir(f"{ws}/checkpoints"))
