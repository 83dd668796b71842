"""Dataset loading and host-side ray sampling (counterpart of
laenerf_tpu/data/provider.py).

Detects the layout: colmap (one transforms.json; val is frame 0, train the
rest, test the n_test + 1 slerp poses between two random frames, with no
ground truth) or blender (transforms_{split}.json, plus the `all`,
`trainval` and `video` splits). Applies the instant-ngp pose convention
(axis cycle + scale/offset), reads the images and any *_mask.png with
Pillow, derives intrinsics from fl_x / camera_angle_x, optionally converts
the images to linear colour, and serves batches of pixel indices (uniform,
by a 128x128 error map per image, or as independent patches) as numpy
arrays, with each view's depth target once distillation has filled
`depths` (editing/distill.py).

All randomness is one np.random.RandomState(seed), drawn in the JAX
package's order, so both packages give equal indices, shuffles and slerp
poses for one seed.
"""

import glob
import json
import os
from typing import Optional

import numpy as np
from PIL import Image

from ..utils.color import srgb_to_linear
from ..utils.timers import span


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


def _slerp(r0, r1, t):
    """Quaternion slerp between two rotation matrices."""
    from scipy.spatial.transform import Rotation, Slerp

    rots = Rotation.from_matrix(np.stack([r0, r1]))
    return Slerp([0, 1], rots)(t).as_matrix()


def rand_poses(n, rng, radius=1.0, theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0, 2 * np.pi)):
    """Random orbit-camera poses looking at the origin; [n, 4, 4]
    cam2world."""
    thetas = rng.uniform(*theta_range, n)
    phis = rng.uniform(*phi_range, n)
    centers = np.stack([
        radius * np.sin(thetas) * np.sin(phis),
        radius * np.cos(thetas),
        radius * np.sin(thetas) * np.cos(phis),
    ], axis=-1)
    fwd = -centers / (np.linalg.norm(centers, axis=-1, keepdims=True) + 1e-10)
    up = np.tile(np.array([0.0, -1.0, 0.0]), (n, 1))
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=-1, keepdims=True) + 1e-10
    up = np.cross(right, fwd)
    up /= np.linalg.norm(up, axis=-1, keepdims=True) + 1e-10
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, fwd], axis=-1)
    poses[:, :3, 3] = centers
    return poses


def _read_image(path):
    return np.asarray(Image.open(path))


def _resize(img, H, W):
    arr = img if img.dtype == np.uint8 else np.clip(img, 0, 255).astype(
        np.uint8)
    return np.asarray(Image.fromarray(arr).resize((W, H), Image.LANCZOS))


class NeRFDataset:
    """Loads a NeRF scene (colmap or blender layout) and serves ray
    batches."""

    def __init__(self, path: str, split: str = "train", downscale: int = 1,
                 scale: float = 0.33, offset=(0, 0, 0), num_rays: int = 4096,
                 error_map: bool = False, patch_size: int = 1,
                 n_test: int = 10, seed: int = 0, color_space: str = "srgb"):
        self.root_path = path
        self.split = split
        self.downscale = downscale
        self.scale = scale
        self.offset = tuple(offset)
        self.color_space = color_space
        self.training = split in ("train", "all", "trainval")
        self.num_rays = num_rays if self.training else -1
        self.patch_size = patch_size
        self.rng = np.random.RandomState(seed)

        if os.path.exists(os.path.join(path, "transforms.json")):
            self.mode = "colmap"
        elif os.path.exists(os.path.join(path, "transforms_train.json")):
            self.mode = "blender"
        else:
            raise FileNotFoundError(f"no transforms*.json under {path}")

        transform = self._load_transform(split)
        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // downscale
            self.W = int(transform["w"]) // downscale
        else:
            self.H = self.W = None
        frames = transform["frames"]

        self.poses, self.images, self.masks = [], [], []
        self.depths = []  # [H * W] per view, filled by distillation

        if self.mode == "colmap" and split == "test":
            # a trajectory between two random frames
            f0, f1 = self.rng.choice(frames, 2, replace=False)
            p0, p1 = (nerf_matrix_to_ngp(
                np.array(f["transform_matrix"], np.float32), self.scale,
                self.offset) for f in (f0, f1))
            for i in range(n_test + 1):
                ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = _slerp(p0[:3, :3], p1[:3, :3], ratio)
                pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
                self.poses.append(pose)
            self.images = None
        else:
            if self.mode == "colmap":
                frames = frames[1:] if split == "train" else (
                    frames[:1] if split == "val" else frames)
            for f in frames:
                f_path = self._frame_path(f)
                if not os.path.exists(f_path) and split != "video":
                    continue
                pose = nerf_matrix_to_ngp(
                    np.array(f["transform_matrix"], np.float32), self.scale,
                    self.offset)
                self.poses.append(pose)
                if split == "video":
                    continue
                image = _read_image(f_path)
                if self.H is None:
                    self.H = image.shape[0] // downscale
                    self.W = image.shape[1] // downscale
                if image.shape[0] != self.H or image.shape[1] != self.W:
                    image = _resize(image, self.H, self.W)
                self.images.append(image.astype(np.float32) / 255.0)
                mask_path = f_path[: f_path.find(".")] + "_mask.png"
                mask = None
                if os.path.exists(mask_path):
                    mask = _read_image(mask_path)
                    if mask.shape[:2] != (self.H, self.W):
                        mask = _resize(mask, self.H, self.W)
                self.masks.append(mask)
            if split == "video":
                self.images = None

        # the video split reads no image: take H and W from the first
        # frame that exists
        if self.H is None:
            for f in frames:
                f_path = self._frame_path(f)
                if os.path.exists(f_path):
                    img = _read_image(f_path)
                    self.H = img.shape[0] // downscale
                    self.W = img.shape[1] // downscale
                    break

        self.poses = np.stack(self.poses, axis=0)
        if self.images is not None and len(self.images) > 0:
            self.images = np.stack(self.images, axis=0)  # [B, H, W, C]
            if color_space == "linear":
                # images serve only as ground truth: convert once at load;
                # alpha stays as it is
                self.images[..., :3] = srgb_to_linear(self.images[..., :3])
        self.radius = float(np.linalg.norm(self.poses[:, :3, 3],
                                           axis=-1).mean())

        # a 128x128 error map per image for importance sampling
        if self.training and error_map and self.images is not None:
            self.error_map = np.ones((self.images.shape[0], 128 * 128),
                                     np.float32)
        else:
            self.error_map = None
        self.intrinsics = self._load_intrinsics(transform)

    def _frame_path(self, frame):
        f_path = os.path.join(self.root_path, frame["file_path"])
        if self.mode == "blender" and "." not in os.path.basename(f_path):
            f_path += ".png"
        return f_path

    def _load_transform(self, split):
        def read(name):
            with open(os.path.join(self.root_path, name)) as f:
                return json.load(f)

        if self.mode == "colmap":
            return read("transforms.json")
        if split == "all":
            transform = None
            for p in sorted(glob.glob(os.path.join(self.root_path,
                                                   "*.json"))):
                t = read(os.path.basename(p))
                if transform is None:
                    transform = t
                else:
                    transform["frames"].extend(t["frames"])
            return transform
        if split == "trainval":
            transform = read("transforms_train.json")
            transform["frames"].extend(read("transforms_val.json")["frames"])
            return transform
        if split == "video" and os.path.exists(
                os.path.join(self.root_path, "transforms_video.json")):
            return read("transforms_video.json")
        name = "test" if split == "video" else split
        return read(f"transforms_{name}.json")

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

    @property
    def has_gt(self):
        return self.images is not None

    def sample_pixel_inds(self, index: int):
        """num_rays pixel indices of one view: patch_size^2-pixel patches
        at random corners when patch_size > 1, else drawn by the view's
        error map (a 128x128 cell without replacement, then a uniform pixel
        inside it) when there is one, else uniform. Returns (inds int32,
        inds_coarse int32 or None: the error-map cells)."""
        H, W, N = self.H, self.W, self.num_rays
        if self.patch_size > 1:
            ps = self.patch_size
            num_patch = N // (ps ** 2)
            ix = self.rng.randint(0, H - ps, num_patch)
            iy = self.rng.randint(0, W - ps, num_patch)
            px, py = np.meshgrid(np.arange(ps), np.arange(ps),
                                 indexing="ij")
            gx = (ix[:, None] + px.reshape(-1)[None, :]).reshape(-1)
            gy = (iy[:, None] + py.reshape(-1)[None, :]).reshape(-1)
            return (gx * W + gy).astype(np.int32), None
        if self.error_map is None:
            return self.rng.randint(0, H * W, N).astype(np.int32), None
        em = self.error_map[index]
        inds_coarse = self.rng.choice(128 * 128, N, replace=False,
                                      p=em / em.sum())
        ix, iy = inds_coarse // 128, inds_coarse % 128
        sx, sy = H / 128, W / 128
        ix = np.clip((ix * sx + self.rng.rand(N) * sx).astype(np.int64), 0,
                     H - 1)
        iy = np.clip((iy * sy + self.rng.rand(N) * sy).astype(np.int64), 0,
                     W - 1)
        return (ix * W + iy).astype(np.int32), inds_coarse.astype(np.int32)

    def get_batch(self, index: int):
        """One training batch for view `index` as host numpy arrays."""
        with span("data.batch"):
            inds, inds_coarse = self.sample_pixel_inds(index)
            batch = {
                "pose": self.poses[index],
                "intrinsics": self.intrinsics,
                "inds": inds,
                "index": index,
                "H": self.H,
                "W": self.W,
            }
            if self.images is not None:
                flat = self.images[index].reshape(-1, self.images.shape[-1])
                batch["pixels"] = flat[inds]
            if inds_coarse is not None:
                batch["inds_coarse"] = inds_coarse
            if len(self.depths) > 0:  # the fine-tune's depth supervision
                batch["depth"] = np.asarray(self.depths[index])[inds]
        return batch

    def update_error_map(self, index: int, inds_coarse, errors):
        """EMA update of the sampled cells: 0.1 old + 0.9 new error."""
        if self.error_map is None:
            return
        em = self.error_map[index]
        em[inds_coarse] = 0.1 * em[inds_coarse] + 0.9 * errors

    def epoch_indices(self, shuffle: Optional[bool] = None):
        idx = np.arange(len(self.poses))
        if shuffle if shuffle is not None else self.training:
            self.rng.shuffle(idx)
        return idx
