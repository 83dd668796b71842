"""The plate's edit dataset: every region ray ends on the plate's surface,
and the views are laid out as EditDataset.load expects."""

import numpy as np
import pytest

from nerfbench.scenes import edit_plate
from nerfbench.scenes.lego_class import lego_class_scene

SCALE = 0.8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from laenerf_tpu_torch.editing.edit_dataset import EditDataset

    path = tmp_path_factory.mktemp("plate") / "edit.npz"
    n_valid = edit_plate.write_edit_dataset(str(path), 3, 48, 48, SCALE,
                                            device="cpu")
    return EditDataset.load(str(path)), n_valid


def test_x_term_lies_on_the_plate(dataset):
    ds, _ = dataset
    _, center, half = lego_class_scene()[0][:3]
    center, half = np.array(center), np.array(half)
    for v in ds.views:
        n = v["n_valid"]
        q = v["x_term"][:n].astype(np.float64)
        # ngp (q0, q1, q2) = scale * blender (p1, p2, p0)
        p = np.stack([q[:, 2], q[:, 0], q[:, 1]], -1) / SCALE
        rel = np.abs(p - center) / half
        assert np.all(rel <= 1 + 1e-4)  # inside or on the box
        assert np.allclose(rel.max(axis=1), 1.0, atol=1e-4)  # on a face
        d = v["dirs"][:n]
        assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)


def test_layout_matches_edit_dataset(dataset):
    ds, n_valid = dataset
    assert ds.n_pad % 4096 == 0 and ds.n_pad >= max(n_valid)
    assert [v["n_valid"] for v in ds.views] == n_valid
    for v in ds.views:
        n = v["n_valid"]
        assert v["valid"].dtype == bool
        assert v["valid"][:n].all() and not v["valid"][n:].any()
        assert (v["inds"][n:] == ds.H * ds.W).all()
        assert (v["inds"][:n] < ds.H * ds.W).all()
        assert (v["x_term"][n:] == 0).all()
        assert v["targets"][:n].min() >= 0 and v["targets"][:n].max() <= 1
        cx, cy = v["crop_origin"]
        assert 0 <= cx <= ds.H - ds.crop_h and 0 <= cy <= ds.W - ds.crop_w
        assert v["cut_gt"].shape == (ds.crop_h, ds.crop_w, 3)
        assert v["cut_smooth"].shape == (ds.crop_h, ds.crop_w)
        f = v["dist_factor"][:n]
        assert f.min() >= 0 and f.max() <= 1
        assert v["depth_factor"] > 0
