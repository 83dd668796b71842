"""Parity of the port's NeRFDataset (laenerf_tpu_torch/data/provider.py)
with the JAX package's, on the colmap fixture of
tests/test_colmap_fixture.py and on a blender scene.

Tolerances: splits, poses, intrinsics, images and masks exactly; the
slerp test poses within 1e-6; the linear colour space within 1e-6; with
one seed, every host draw (pixel indices, error-map cells, patches,
shuffles, random poses) bit-equal.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from laenerf_tpu.data import NeRFDataset as JDataset
from laenerf_tpu.data import generate_synthetic_scene as jgenerate
from laenerf_tpu.data.provider import rand_poses as jrand_poses
from laenerf_tpu.utils import color as jcolor
from laenerf_tpu_torch.data import NeRFDataset
from laenerf_tpu_torch.data.provider import rand_poses
from laenerf_tpu_torch.utils import color
from test_colmap_fixture import _make_colmap_fixture


@pytest.fixture(scope="module")
def colmap(tmp_path_factory):
    return _make_colmap_fixture(str(tmp_path_factory.mktemp("colmap")),
                                n_train=6, H=32)


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blender"))
    jgenerate(root, n_train=3, n_val=2, n_test=2, H=16, W=16)
    return root


def _same(a, b):
    assert a.mode == b.mode and (a.H, a.W) == (b.H, b.W)
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
    if b.images is None:
        assert a.images is None and not a.has_gt
    else:
        np.testing.assert_array_equal(a.images, b.images)
    assert a.radius == b.radius


def test_colmap_splits_match_jax(colmap):
    for split in ("train", "val"):
        a = NeRFDataset(colmap, split, num_rays=64)
        b = JDataset(colmap, split, num_rays=64)
        _same(a, b)
        assert a.mode == "colmap" and a.images.shape[-1] == 3
    assert len(NeRFDataset(colmap, "train")) == 5
    assert len(NeRFDataset(colmap, "val")) == 1
    for seed in (0, 3):
        a = NeRFDataset(colmap, "test", seed=seed)
        b = JDataset(colmap, "test", seed=seed)
        assert len(a) == 11 and a.images is None and not a.has_gt
        np.testing.assert_allclose(a.poses, b.poses, atol=1e-6)
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        for p in a.poses:
            np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3),
                                       atol=1e-5)


def test_masks_and_linear_color_match_jax(colmap, tmp_path):
    # a copy with a mask beside two frames
    root = str(tmp_path / "masked")
    os.makedirs(os.path.join(root, "images"))
    with open(os.path.join(colmap, "transforms.json")) as f:
        tf = json.load(f)
    rng = np.random.RandomState(4)
    for i, fr in enumerate(tf["frames"]):
        src = os.path.join(colmap, fr["file_path"])
        dst = os.path.join(root, fr["file_path"])
        Image.open(src).save(dst)
        if i in (1, 3):
            m = (rng.rand(32, 32) > 0.5).astype(np.uint8) * 255
            Image.fromarray(m).save(dst[: dst.find(".")] + "_mask.png")
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(tf, f)
    a = NeRFDataset(root, "train", color_space="linear")
    b = JDataset(root, "train", color_space="linear")
    assert [m is None for m in a.masks] == [m is None for m in b.masks] \
        == [False, True, False, True, True]
    for ma, mb in zip(a.masks, b.masks):
        if ma is not None:
            np.testing.assert_array_equal(ma, mb)
    np.testing.assert_allclose(a.images, b.images, atol=1e-6)
    srgb = NeRFDataset(root, "train").images
    assert not np.allclose(a.images, srgb)
    x = np.linspace(-0.1, 1.1, 257, dtype=np.float32)
    for fn in ("srgb_to_linear", "linear_to_srgb"):
        ref = np.asarray(getattr(jcolor, fn)(x))
        np.testing.assert_allclose(getattr(color, fn)(x), ref, atol=1e-6)
        np.testing.assert_allclose(
            getattr(color, fn)(torch.as_tensor(x)).numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("split", ["trainval", "all", "video", "test"])
def test_blender_splits_match_jax(blender, split):
    a = NeRFDataset(blender, split)
    b = JDataset(blender, split)
    _same(a, b)
    if split == "video":
        assert a.images is None and len(a) == 2 and a.H == 16
    else:
        assert a.has_gt


def test_error_map_batches_match_jax(colmap):
    a = NeRFDataset(colmap, "train", num_rays=256, error_map=True, seed=5)
    b = JDataset(colmap, "train", num_rays=256, error_map=True, seed=5)
    rng = np.random.RandomState(6)
    moved = 0
    for step in range(6):
        order_a, order_b = a.epoch_indices(), b.epoch_indices()
        np.testing.assert_array_equal(order_a, order_b)
        i = int(order_a[step % len(order_a)])
        ba, bb = a.get_batch(i), b.get_batch(i)
        for k in ("inds", "inds_coarse", "pixels"):
            np.testing.assert_array_equal(ba[k], bb[k])
        assert ba["inds"].dtype == np.int32
        assert len(np.unique(ba["inds_coarse"])) == 256
        err = rng.rand(256).astype(np.float32) * (step + 1)
        a.update_error_map(i, ba["inds_coarse"], err)
        b.update_error_map(i, bb["inds_coarse"], err)
        np.testing.assert_array_equal(a.error_map, b.error_map)
        moved = int((a.error_map != 1).sum())
    assert moved > 0


@pytest.mark.parametrize("patch_size", [4, 8])
def test_patch_batches_match_jax(colmap, patch_size):
    a = NeRFDataset(colmap, "train", num_rays=256, patch_size=patch_size,
                    seed=7)
    b = JDataset(colmap, "train", num_rays=256, patch_size=patch_size,
                 seed=7)
    for step in range(3):
        ba, bb = a.get_batch(step), b.get_batch(step)
        np.testing.assert_array_equal(ba["inds"], bb["inds"])
        np.testing.assert_array_equal(ba["pixels"], bb["pixels"])
        assert "inds_coarse" not in ba
        # each run of patch_size^2 indices is one square patch
        p = ba["inds"].reshape(-1, patch_size, patch_size)
        assert np.all(np.diff(p, axis=2) == 1)
        assert np.all(np.diff(p, axis=1) == a.W)
        np.testing.assert_array_equal(a.epoch_indices(), b.epoch_indices())


def test_uniform_batches_and_rand_poses_match_jax(colmap):
    a = NeRFDataset(colmap, "train", num_rays=128, seed=8)
    b = JDataset(colmap, "train", num_rays=128, seed=8)
    for step in range(3):
        ba, bb = a.get_batch(step), b.get_batch(step)
        np.testing.assert_array_equal(ba["inds"], bb["inds"])
        assert "inds_coarse" not in ba
    np.testing.assert_array_equal(a.epoch_indices(), b.epoch_indices())
    np.testing.assert_array_equal(
        rand_poses(9, np.random.RandomState(2), radius=1.5),
        jrand_poses(9, np.random.RandomState(2), radius=1.5))
