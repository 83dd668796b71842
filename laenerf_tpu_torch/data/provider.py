"""Blender-format dataset loading and host-side ray sampling (counterpart of
laenerf_tpu/data/provider.py, blender layout only).

Reads transforms_{split}.json and the RGBA pngs (with Pillow), applies the
instant-ngp pose convention (axis cycle + scale/offset), derives intrinsics
from fl_x / camera_angle_x, and serves batches of uniformly sampled pixels
as numpy arrays, with each view's depth target once distillation has
filled `depths` (editing/distill.py). The colmap layout, error-map and
patch sampling, and the linear color space are not ported yet.
"""

import json
import os

import numpy as np
from PIL import Image


def nerf_matrix_to_ngp(pose, scale=0.33, offset=(0, 0, 0)):
    """NeRF (blender) cam2world -> instant-ngp convention: cycle axes
    (y, z, x), flip the y/z columns, scale + offset the origin."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def _read_image(path):
    return np.asarray(Image.open(path))


def _resize(img, H, W):
    arr = img if img.dtype == np.uint8 else np.clip(img, 0, 255).astype(
        np.uint8)
    return np.asarray(Image.fromarray(arr).resize((W, H), Image.LANCZOS))


class NeRFDataset:
    """Loads a blender-format NeRF scene and serves ray batches."""

    def __init__(self, path: str, split: str = "train", downscale: int = 1,
                 scale: float = 0.33, offset=(0, 0, 0), num_rays: int = 4096,
                 seed: int = 0):
        self.root_path = path
        self.split = split
        self.downscale = downscale
        self.scale = scale
        self.offset = tuple(offset)
        self.training = split in ("train", "all", "trainval")
        self.num_rays = num_rays if self.training else -1
        self.rng = np.random.RandomState(seed)
        if not os.path.exists(os.path.join(path, "transforms_train.json")):
            raise FileNotFoundError(
                f"no blender-format transforms_train.json under {path}")
        self.mode = "blender"

        with open(os.path.join(path, f"transforms_{split}.json")) as f:
            transform = json.load(f)
        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // downscale
            self.W = int(transform["w"]) // downscale
        else:
            self.H = self.W = None

        poses, images = [], []
        for frame in transform["frames"]:
            f_path = os.path.join(path, frame["file_path"])
            if "." not in os.path.basename(f_path):
                f_path += ".png"
            if not os.path.exists(f_path):
                continue
            image = _read_image(f_path)
            if self.H is None:
                self.H = image.shape[0] // downscale
                self.W = image.shape[1] // downscale
            if image.shape[0] != self.H or image.shape[1] != self.W:
                image = _resize(image, self.H, self.W)
            poses.append(nerf_matrix_to_ngp(
                np.array(frame["transform_matrix"], np.float32), self.scale,
                self.offset))
            images.append(image.astype(np.float32) / 255.0)

        self.poses = np.stack(poses, axis=0)
        self.images = np.stack(images, axis=0)  # [B, H, W, C]
        self.depths = []  # [H * W] per view, filled by distillation
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3],
                                           axis=-1).mean())
        self.intrinsics = self._load_intrinsics(transform)

    def _load_intrinsics(self, transform):
        d = self.downscale
        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / d
            fl_y = transform.get("fl_y", transform.get("fl_x")) / d
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = fl_y = None
            if "camera_angle_x" in transform:
                fl_x = self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
            if "camera_angle_y" in transform:
                fl_y = self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("no focal length in transforms json")
        cx = transform.get("cx", self.W * d / 2) / d
        cy = transform.get("cy", self.H * d / 2) / d
        return np.array([fl_x, fl_y, cx, cy], np.float32)

    def __len__(self):
        return len(self.poses)

    def sample_pixel_inds(self, index: int):
        """num_rays uniform pixel indices for one view."""
        return self.rng.randint(0, self.H * self.W,
                                self.num_rays).astype(np.int32)

    def get_batch(self, index: int):
        """One training batch for view `index` as host numpy arrays."""
        inds = self.sample_pixel_inds(index)
        flat = self.images[index].reshape(-1, self.images.shape[-1])
        batch = {
            "pose": self.poses[index],
            "intrinsics": self.intrinsics,
            "inds": inds,
            "index": index,
            "H": self.H,
            "W": self.W,
            "pixels": flat[inds],
        }
        if len(self.depths) > 0:  # the fine-tune's depth supervision
            batch["depth"] = np.asarray(self.depths[index])[inds]
        return batch

    def epoch_indices(self, shuffle=None):
        idx = np.arange(len(self.poses))
        if shuffle if shuffle is not None else self.training:
            self.rng.shuffle(idx)
        return idx
