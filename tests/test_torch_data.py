"""Parity of the port's data modules (laenerf_tpu_torch/data) with the JAX
package's: the synthetic scene generator and the blender-format dataset.

The ground-truth renders agree to one 8-bit level (float32 quadrature in
another order); the dataset reads the same files into identical arrays and,
from the same seed, samples identical pixel batches.
"""

import json
import os

import numpy as np

from laenerf_tpu.data import NeRFDataset as JNeRFDataset
from laenerf_tpu.data import generate_synthetic_scene as jgenerate
from laenerf_tpu_torch.data import NeRFDataset, generate_synthetic_scene


def _read_split(root, split):
    from PIL import Image

    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    imgs = [np.asarray(Image.open(os.path.join(root, fr["file_path"] +
                                               ".png")))
            for fr in meta["frames"]]
    return meta, np.stack(imgs).astype(np.int32)


def test_synthetic_scene_and_dataset(tmp_path):
    kw = dict(n_train=3, n_val=1, n_test=1, H=12, W=10)
    jroot = jgenerate(str(tmp_path / "jax"), **kw)
    troot = generate_synthetic_scene(str(tmp_path / "port"), device="cpu",
                                     **kw)
    for split in ("train", "val", "test"):
        jmeta, jimg = _read_split(jroot, split)
        tmeta, timg = _read_split(troot, split)
        assert tmeta == jmeta
        assert timg.shape == jimg.shape
        assert np.abs(timg - jimg).max() <= 1
        assert timg[..., 3].max() > 200  # the spheres are in view

    jds = JNeRFDataset(troot, "train", num_rays=64, seed=3)
    tds = NeRFDataset(troot, "train", num_rays=64, seed=3)
    assert (tds.H, tds.W, len(tds)) == (jds.H, jds.W, len(jds)) == (12, 10, 3)
    np.testing.assert_array_equal(tds.poses, jds.poses)
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.intrinsics, jds.intrinsics)
    for i in range(3):
        jb, tb = jds.get_batch(i), tds.get_batch(i)
        for k in ("inds", "pixels", "pose", "intrinsics"):
            np.testing.assert_array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(tds.epoch_indices(), jds.epoch_indices())
