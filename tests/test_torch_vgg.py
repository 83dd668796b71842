"""Parity of the port's VGG stacks, bilinear resize, Gram matrices, colour
matching and LPIPS with the JAX package's, on inputs made with numpy from
a seed.

Tolerances (bounds on the error):
  * vgg_init random filters: equal (the same numpy RandomState stream,
    transposed HWIO -> OIHW). A synthetic npz loads equal in both.
  * vgg_features: max |port - JAX| <= 1e-4 * max |JAX| at every index
    asked for (f32 convolutions summed in another order, through up to 8
    layers).
  * resize_bilinear against jax.image.resize, up, down and non-square:
    max abs error <= 2e-6 on [0, 1] images; its gradient (of a weighted
    sum) <= 1e-5 * max |JAX gradient|.
  * gram_matrices: <= 1e-5 * max |JAX|; match_color: equal (the same
    float64 numpy code).
  * lpips_fn on a synthetic VGG-16 npz: |port - JAX| <= 1e-5 * JAX + 1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import max_rel_err, t, write_vgg_npz
from laenerf_tpu.editing import style as jstyle
from laenerf_tpu.editing import vgg as jvgg
from laenerf_tpu.train import metrics as jmetrics
from laenerf_tpu_torch.convert import vgg_params_from_jax, vgg_params_to_numpy
from laenerf_tpu_torch.editing import style as tstyle
from laenerf_tpu_torch.editing import vgg as tvgg
from laenerf_tpu_torch.train import metrics as tmetrics
from laenerf_tpu_torch.utils.images import resize_bilinear

LAYOUTS = {"vgg19": jvgg.VGG19_LAYOUT, "vgg16": jvgg.VGG16_LAYOUT}
# the indices the modes read: the style layers, the NPR feature and colour
# layers, LPIPS's
INDICES = {"vgg19": (1, 4, 10, 12, 14), "vgg16": (3, 8, 11, 13, 15, 22, 29)}


@pytest.fixture
def no_vgg_env(monkeypatch, tmp_path):
    """No weights npz anywhere: the env variables unset, HOME empty."""
    for arch in LAYOUTS:
        monkeypatch.delenv(f"LAENERF_{arch.upper()}_NPZ", raising=False)
    monkeypatch.setattr(tvgg, "_WEIGHTS_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(jvgg, "_WEIGHTS_DIR", str(tmp_path / "none"))


@pytest.fixture
def vgg16_npz(tmp_path, monkeypatch):
    path = str(tmp_path / "vgg16_features.npz")
    write_vgg_npz(path, jvgg.VGG16_LAYOUT, seed=3)
    monkeypatch.setenv("LAENERF_VGG16_NPZ", path)
    return path


def _both_stacks(arch):
    with pytest.warns(UserWarning, match="random filters"):
        jp, jkinds, jpre = jvgg.vgg_init(arch)
    with pytest.warns(UserWarning, match="random filters"):
        tp, tkinds, tpre = tvgg.vgg_init(arch, device="cpu")
    assert not jpre and not tpre and list(jkinds) == list(tkinds)
    return jp, tp, tkinds


@pytest.mark.parametrize("arch", sorted(LAYOUTS))
def test_vgg_init_random_filters_equal_jax(no_vgg_env, arch):
    jp, tp, _ = _both_stacks(arch)
    for j, p in zip(jp, tp):
        assert (j is None) == (p is None)
        if j is None:
            continue
        np.testing.assert_array_equal(
            p[0].numpy(), np.transpose(np.asarray(j[0]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
        assert not p[0].requires_grad
    # the converters go both ways
    back = vgg_params_to_numpy(vgg_params_from_jax(
        [None if j is None else tuple(map(np.asarray, j)) for j in jp]))
    for j, b in zip(jp, back):
        if j is not None:
            np.testing.assert_array_equal(b[0], np.asarray(j[0]))


@pytest.mark.parametrize("arch", sorted(LAYOUTS))
def test_vgg_init_loads_npz_equal_jax(tmp_path, monkeypatch, arch):
    path = str(tmp_path / f"{arch}_features.npz")
    arrays = write_vgg_npz(path, LAYOUTS[arch], seed=1)
    monkeypatch.setenv(f"LAENERF_{arch.upper()}_NPZ", path)
    jp, _, jpre = jvgg.vgg_init(arch)
    tp, _, tpre = tvgg.vgg_init(arch, device="cpu")
    assert jpre and tpre
    for i, (j, p) in enumerate(zip(jp, tp)):
        if j is None:
            continue
        np.testing.assert_array_equal(p[0].numpy(), arrays[f"{i}.weight"])
        np.testing.assert_array_equal(p[1].numpy(), arrays[f"{i}.bias"])
        np.testing.assert_array_equal(
            p[0].numpy(), np.transpose(np.asarray(j[0]), (3, 2, 0, 1)))


@pytest.mark.parametrize("arch", sorted(LAYOUTS))
def test_vgg_features_match_jax(no_vgg_env, arch):
    jp, tp, kinds = _both_stacks(arch)
    x = np.random.RandomState(4).rand(1, 3, 36, 44).astype(np.float32)
    x = (x - 0.45) / 0.225
    ref = jvgg.vgg_features(jp, kinds, jnp.asarray(x), INDICES[arch])
    got = tvgg.vgg_features(tp, kinds, t(x), INDICES[arch])
    assert len(got) == len(ref) == len(INDICES[arch])
    for i, g, r in zip(INDICES[arch], got, ref):
        assert g.shape == r.shape, i
        err = max_rel_err(g.numpy(), r)
        assert err <= 1e-4, (i, err)
    np.testing.assert_allclose(
        tvgg.normalize_imagenet(t(x[0])).numpy(),
        np.asarray(jvgg.normalize_imagenet(jnp.asarray(x[0]))), atol=1e-6)


@pytest.mark.parametrize("src,dst", [
    ((40, 56), (256, 256)),   # up
    ((300, 420), (256, 256)),  # down (antialiased in both)
    ((100, 100), (32, 32)),   # down by 3.125
    ((17, 23), (31, 9)),      # non-square, up one axis and down the other
])
def test_resize_matches_jax_image_resize(src, dst):
    rng = np.random.RandomState(sum(src))
    x = rng.rand(3, *src).astype(np.float32)
    w = rng.rand(3, *dst).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3,) + dst,
                                      "bilinear"))
    got = resize_bilinear(t(x), dst).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2e-6

    gref = np.asarray(jax.grad(lambda a: jnp.sum(
        jax.image.resize(a, (3,) + dst, "bilinear") * w))(jnp.asarray(x)))
    xt = t(x).requires_grad_(True)
    (resize_bilinear(xt, dst) * t(w)).sum().backward()
    assert max_rel_err(xt.grad.numpy(), gref) <= 1e-5


def test_gram_matrices_and_match_color_match_jax():
    rng = np.random.RandomState(5)
    feats = [rng.randn(1, c, h, w).astype(np.float32)
             for c, h, w in ((8, 6, 5), (16, 3, 3))]
    ref = jstyle.gram_matrices([jnp.asarray(f) for f in feats])
    got = tstyle.gram_matrices([t(f) for f in feats])
    for g, r in zip(got, ref):
        assert max_rel_err(g.numpy(), r) <= 1e-5

    style = rng.rand(3, 20, 24).astype(np.float32)
    target = (0.3 * rng.rand(3, 12, 10) + 0.5).astype(np.float32)
    np.testing.assert_array_equal(tstyle.match_color(style, target),
                                  jstyle.match_color(style, target))


def test_lpips_matches_jax_on_a_synthetic_npz(vgg16_npz):
    rng = np.random.RandomState(6)
    a = rng.rand(32, 40, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(32, 40, 3), 0, 1).astype(np.float32)
    small = rng.rand(5, 7, 3).astype(np.float32)  # drops layers
    jfn, tfn = jvgg.lpips_fn(), tvgg.lpips_fn(device="cpu")
    for x, y in ((a, b), (a, a), (small, small[::-1].copy())):
        ref = float(jfn(jnp.asarray(x), jnp.asarray(y)))
        got = float(tfn(t(x), t(y)))
        assert abs(got - ref) <= 1e-5 * abs(ref) + 1e-7, (got, ref)

    jm, tm = jmetrics.LPIPSMeter(), tmetrics.LPIPSMeter(device="cpu")
    assert jm.available and tm.available
    for m in (jm, tm):
        m.update(a, b)
        m.update(a, a)
    assert abs(tm.measure() - jm.measure()) <= 1e-5 * jm.measure()
    assert "n/a" not in tm.report()


def test_lpips_degrades_without_weights(no_vgg_env):
    with pytest.raises(RuntimeError, match="vgg16 weights"):
        tvgg.lpips_fn(device="cpu")
    m = tmetrics.LPIPSMeter(device="cpu")
    assert not m.available
    m.update(np.zeros((8, 8, 3)), np.ones((8, 8, 3)))
    assert m.vals == [] and m.measure() == 0.0
    assert "n/a" in m.report()
    assert "LAENERF_VGG16_NPZ" not in os.environ
