"""Parity of the port's CLIP guidance (laenerf_tpu_torch/models/clip_vit.py,
train/clip_guidance.py, Trainer.train_one_batch_clip) with the JAX
package's, on the CPU.

The ViT-B/16 tower runs at its published width (12 x 768, 12 heads, MLP
3,072, projection 512, 224^2, patch 16) with JAX's random weights handed
over through convert.clip_params_from_jax. Tolerances: preprocessing at
1e-5 absolute, embeddings at 1e-4 relative to the largest element, the
loss at 1e-5 relative and the image gradient at 1e-4 of its largest
element (f32 on both sides, different summation orders). One CLIP step on
the tiny NeRF of tests/_torch_parity.py with JAX's march noises: the loss
at 1e-3 relative and each NeRF gradient leaf at 2e-2 of its largest
element (a bf16 network on both sides, as tests/test_torch_trainer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (J_MODEL_CFG, J_RENDER_CFG, MODEL_CFG, RENDER_CFG,
                           blob_occupancy, jax_params, max_rel_err, port_net,
                           t)
from laenerf_tpu.models import clip_vit as jclip
from laenerf_tpu.train import trainer as jtrain
from laenerf_tpu_torch.convert import (clip_params_from_jax,
                                       clip_params_to_numpy)
from laenerf_tpu_torch.models import clip_vit as tclip
from laenerf_tpu_torch.train import trainer as ttrain


@pytest.fixture(scope="module")
def towers():
    """JAX's random ViT-B/16 and the port's copy of it."""
    params = jclip.clip_vision_init(seed=1)
    model = tclip.CLIPVision(device="cpu")
    model.load_state_dict(clip_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, model


def test_published_width(towers):
    _, model = towers
    assert (tclip.IMAGE_SIZE, tclip.PATCH, tclip.WIDTH, tclip.LAYERS,
            tclip.HEADS, tclip.MLP_DIM, tclip.EMBED_DIM,
            tclip.N_TOKENS) == (224, 16, 768, 12, 12, 3072, 512, 197)
    assert model.blocks["qkv_w"].shape == (12, 768, 2304)
    assert model.blocks["fc1_w"].shape == (12, 768, 3072)
    assert model.proj.shape == (768, 512)
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_array_equal(tclip.CLIP_MEAN, jclip.CLIP_MEAN)
    np.testing.assert_array_equal(tclip.CLIP_STD, jclip.CLIP_STD)


def test_params_round_trip(towers):
    params, model = towers
    back = clip_params_to_numpy(model)
    ref = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [32, 64])
def test_clip_preprocess(size):
    img = np.random.RandomState(size).rand(2, size, size, 3).astype(
        np.float32)
    ref = np.asarray(jclip.clip_preprocess(jnp.asarray(img)))
    got = tclip.clip_preprocess(t(img)).numpy()
    assert got.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_clip_vision_forward(towers):
    params, model = towers
    x = np.random.RandomState(3).randn(2, 224, 224, 3).astype(np.float32)
    ref = np.asarray(jclip.clip_vision_forward(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tclip.clip_vision_forward(model, t(x)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert max_rel_err(got, ref) < 1e-4


@pytest.mark.parametrize("text_rows", [1, 2])
def test_similarity_loss_and_image_gradient(towers, text_rows):
    params, model = towers
    rng = np.random.RandomState(4 + text_rows)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    tz = rng.randn(*((512,) if text_rows == 1 else (2, 512))).astype(
        np.float32)
    loss_j, grad_j = jax.value_and_grad(
        lambda x: jclip.clip_similarity_loss(params, x, jnp.asarray(tz)))(
        jnp.asarray(img))
    x = t(img).requires_grad_(True)
    loss_t = tclip.clip_similarity_loss(model, x, t(tz))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    assert max_rel_err(x.grad.numpy(), grad_j) < 1e-4


def test_hf_npz_loader(tmp_path):
    """Both packages map a HuggingFace-layout npz alike: the patch weight
    at its full [768, 3, 16, 16], the other arrays small."""
    rng = np.random.RandomState(6)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    sd = {"embeddings.patch_embedding.weight": r(768, 3, 16, 16),
          "embeddings.class_embedding": r(768),
          "embeddings.position_embedding.weight": r(5, 4),
          "pre_layrnorm.weight": r(4), "pre_layrnorm.bias": r(4),
          "post_layernorm.weight": r(4), "post_layernorm.bias": r(4),
          "visual_projection.weight": r(3, 4)}
    for i in range(12):
        p = f"encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = r(4), r(4)
        for n in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                  "self_attn.out_proj"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = r(4, 4), r(4)
        sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"] = r(6, 4), r(6)
        sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"] = r(4, 6), r(4)
    path = tmp_path / "clip.npz"
    np.savez(path, **sd)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    ref = jax.tree.map(np.asarray, jclip._params_from_hf_npz(arrays))
    got = tclip._params_from_hf_npz(arrays)
    flat_ref = {}
    for k, v in ref.items():
        if isinstance(v, dict):
            flat_ref.update({f"{k}.{n}": a for n, a in v.items()})
        else:
            flat_ref[k] = v
    assert sorted(got) == sorted(flat_ref)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), flat_ref[k], err_msg=k)
    assert got["patch_w"].shape == (768, 768)
    assert got["blocks.qkv_w"].shape == (12, 4, 12)


def test_load_clip_vision_gated(monkeypatch, tmp_path):
    monkeypatch.setenv("LAENERF_CLIP_NPZ", str(tmp_path / "missing.npz"))
    model, pretrained = tclip.load_clip_vision(device="cpu")
    assert pretrained is False
    assert model.blocks["qkv_w"].shape[0] == 12
    assert float(model.ln_pre["w"].min()) == 1.0
    assert 0.01 < float(model.patch_w.std()) < 0.03


def _camera(H, W):
    pose = np.array([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.0],
                     [0, 0, 0, 1.0]], np.float32)
    return pose, np.array([32.0, 32.0, W / 2, H / 2], np.float32)


def test_clip_step_matches_jax(towers):
    """train_step_clip on the tiny NeRF at 32x32 against JAX's, the march
    noises JAX's own draw from its step key."""
    params_clip, model = towers
    H = W = 32
    tree = jax_params(60, table_scale=0.2)
    occ = blob_occupancy(61)
    pose, intr = _camera(H, W)
    tz = np.random.RandomState(62).randn(512).astype(np.float32)
    key = jax.random.PRNGKey(63)
    k_render, _ = jax.random.split(key)
    noises = np.asarray(jax.random.uniform(k_render, (H * W,)))

    rays_o, rays_d = jtrain.get_rays(
        jnp.asarray(pose), jnp.asarray(intr),
        jnp.arange(H * W, dtype=jnp.int32), H, W)

    def loss_fn(p):
        from laenerf_tpu.models import renderer as jren

        out = jren.render_rays_train(p, jnp.asarray(occ), rays_o, rays_d,
                                     k_render, model_cfg=J_MODEL_CFG,
                                     render_cfg=J_RENDER_CFG, bg_color=None,
                                     perturb=True)
        return jclip.clip_similarity_loss(
            params_clip, out["image"].reshape(1, H, W, 3), jnp.asarray(tz))

    params = jax.tree.map(jnp.asarray, tree)
    loss_ref, grads_ref = jax.value_and_grad(loss_fn)(params)
    opt = jtrain.make_optimizer(1e-2, 100)
    state = jtrain.TrainState(params=params, opt_state=opt.init(params),
                              ema_params=jax.tree.map(jnp.array, params),
                              step=jnp.zeros((), jnp.int32))
    _, aux_j = jtrain.train_step_clip(
        state, jnp.asarray(occ), params_clip, jnp.asarray(tz),
        jnp.asarray(pose), jnp.asarray(intr), key, model_cfg=J_MODEL_CFG,
        render_cfg=J_RENDER_CFG, optimizer=opt, ema_decay=0.95, H=H, W=W)
    # the jitted step fuses another summation order
    np.testing.assert_allclose(float(aux_j["loss"]), float(loss_ref),
                               rtol=1e-4)

    net, ema = port_net(tree), port_net(tree).requires_grad_(False)
    topt, tsched = ttrain.make_optimizer(net.parameters(), 1e-2, 100)
    before = net.encoder.detach().clone()
    aux_t = ttrain.train_step_clip(
        net, ema, topt, tsched, t(occ), model, t(tz), t(pose), t(intr),
        render_cfg=RENDER_CFG, ema_decay=0.95, H=H, W=W, noises=t(noises))
    np.testing.assert_allclose(float(aux_t["loss"]), float(loss_ref),
                               rtol=1e-3)
    got = {"encoder": net.encoder.grad.numpy()}
    for name in ("sigma_net", "color_net"):
        got[name] = [lin.weight.grad.numpy().T
                     for lin in getattr(net, name).layers]
    ref_leaves = jax.tree.leaves(grads_ref)
    got_leaves = jax.tree.leaves(got)
    assert len(ref_leaves) == len(got_leaves) == 6
    for g, r in zip(got_leaves, ref_leaves):
        assert np.abs(np.asarray(r)).max() > 0
        assert max_rel_err(g, r) < 2e-2
    assert not torch.equal(before, net.encoder.detach())
    assert tsched.last_epoch == 1


def test_train_one_batch_clip_moves_params():
    from laenerf_tpu_torch.train import Trainer

    tr = Trainer(MODEL_CFG, RENDER_CFG, device="cpu", lr=1e-2, iters=100)
    model = tclip.clip_vision_init(seed=1, device="cpu")
    tz = np.random.RandomState(0).randn(512).astype(np.float32)
    pose, intr = _camera(32, 32)
    before = tr.net.encoder.detach().clone()
    aux = tr.train_one_batch_clip(model, tz, pose, intr, 32, 32)
    assert np.isfinite(float(aux["loss"]))
    assert not torch.equal(before, tr.net.encoder.detach())
    assert tr.global_step == 1
    assert tr.occ_state.iter_density == 1  # the refresh ran first


def test_clip_loss_gated():
    """Without transformers or a cached model both gates raise the JAX
    package's RuntimeError."""
    from laenerf_tpu_torch.train.clip_guidance import (CLIPLoss,
                                                       text_embedding)

    for make in (lambda: CLIPLoss("a red chair"),
                 lambda: text_embedding("a red chair")):
        try:
            make()
        except RuntimeError as e:
            assert "locally cached CLIP" in str(e)
        else:  # a real cache exists on this machine; construction is enough
            pass
