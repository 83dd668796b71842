"""The lego-class procedural scene and its blender-layout writer.

A frozen copy of `laenerf_tpu_torch/data/synthetic.py` (`lego_class_scene`,
`_prim_arrays`, `_eval_scene`, `_render_chunk`, `_render_view_offset`,
`_look_at_pose` and the camera draw of `generate_synthetic_scene`), so that
the traffic stays what it is whatever later changes make of the program's
generator. It imports nothing of the program. Only the chunk of rays a
view is rendered in differs (a whole view), which changes no pixel.

Also the exact geometry the edit dataset needs: the first hit of a ray on
each primitive (`first_hits`) and the scene's colour at a point (`texture`).
"""

import json
import math
import os

import numpy as np
import torch
from PIL import Image


def lego_class_scene():
    """A textured base plate, a lattice of thin pillars, two beams and three
    textured hollow spheres. ('box', center, half_extents, rgb, sigma, freq,
    phase) and ('shell', center, radius, thickness, rgb, sigma, freq,
    phase). The plate is primitive 0."""
    prims = [
        ("box", (0.0, 0.0, -0.52), (0.62, 0.62, 0.05),
         (0.72, 0.65, 0.35), 200.0, 4.0, 0.0),
    ]
    rng = np.random.RandomState(7)
    for ix in range(-2, 3):
        for iy in range(-2, 3):
            if (ix + iy) % 2 == 0:
                h = 0.18 + 0.22 * rng.rand()
                prims.append((
                    "box", (0.22 * ix, 0.22 * iy, -0.47 + h),
                    (0.035, 0.035, h),
                    (0.75, 0.25 + 0.1 * ((ix + 2) % 3), 0.2), 200.0,
                    6.0, 0.7 * ix + iy,
                ))
    prims.append(("box", (0.0, 0.0, 0.1), (0.5, 0.04, 0.035),
                  (0.25, 0.45, 0.8), 200.0, 8.0, 1.1))
    prims.append(("box", (0.0, 0.0, 0.22), (0.04, 0.5, 0.035),
                  (0.3, 0.75, 0.3), 200.0, 8.0, 2.3))
    prims.append(("shell", (0.25, -0.2, 0.33), 0.13, 0.045,
                  (0.9, 0.75, 0.2), 160.0, 10.0, 0.4))
    prims.append(("shell", (-0.28, 0.22, 0.4), 0.16, 0.045,
                  (0.35, 0.4, 0.85), 160.0, 9.0, 2.8))
    prims.append(("shell", (0.0, 0.0, 0.5), 0.1, 0.04,
                  (0.85, 0.3, 0.3), 160.0, 12.0, 1.9))
    return prims


def prim_arrays(prims, device):
    """Primitives as typed tensors (kind 1 shell, 2 box), in list order,
    which decides the first-hit colour."""
    rows = []
    for prim in prims:
        if prim[0] == "shell":
            _, center, radius, th, rgb, s, freq, phase = prim
            rows.append((1, center, (radius, th, 0), rgb, s, freq, phase))
        else:
            _, center, half, rgb, s, freq, phase = prim
            rows.append((2, center, half, rgb, s, freq, phase))
    cols = ("kind", "center", "shape", "rgb", "sigma", "freq", "phase")
    out = {}
    for i, name in enumerate(cols):
        dtype = torch.int32 if name == "kind" else torch.float32
        out[name] = torch.tensor(np.array([r[i] for r in rows]), dtype=dtype,
                                 device=device)
    return out


def texture(pts, rgb, freq, phase):
    """The scene's colour at points [B, 3] of primitives with colour rgb
    [B, 3], frequency freq [B] and phase phase [B]."""
    mod = 0.5 + 0.5 * torch.sin(
        2 * torch.pi * freq * (pts[:, 0] + 0.7 * pts[:, 1] + 0.41 * pts[:, 2])
        + phase)
    tex = rgb * (0.55 + 0.45 * mod[:, None])
    return torch.where((freq > 0)[:, None], tex, rgb)


def _eval_scene(pa, pts):
    """Density [B] and first-hit colour [B, 3] at points [B, 3]."""
    rel = pts[:, None, :] - pa["center"][None]
    r2 = torch.sum(rel * rel, -1)
    rad = pa["shape"][:, 0][None]
    th = pa["shape"][:, 1][None]
    in_shell = (r2 < rad ** 2) & (r2 > (rad - th) ** 2)
    in_box = torch.all(rel.abs() < pa["shape"][None], dim=-1)
    inside = torch.where(pa["kind"][None] == 1, in_shell, in_box)
    first = inside.to(torch.int32).argmax(dim=1)
    any_in = inside.any(dim=1)
    sigma = torch.amax(torch.where(inside, pa["sigma"][None], 0.0), dim=1)
    color = texture(pts, pa["rgb"][first], pa["freq"][first],
                    pa["phase"][first])
    return sigma, torch.where(any_in[:, None], color, 0.0)


def _render_chunk(pa, origin, d, ts, dt: float):
    """Dense quadrature along rays origin + t d at the given t values."""
    B = d.shape[0]
    T = torch.ones((B,), device=d.device)
    img = torch.zeros((B, 3), device=d.device)
    acc = torch.zeros((B,), device=d.device)
    for t in ts:
        sigma, color = _eval_scene(pa, origin[None] + t * d)
        a = 1.0 - torch.exp(-sigma * dt)
        w = a * T
        img = img + w[:, None] * color
        acc = acc + w
        T = T * (1.0 - a)
    return img, acc


def pixel_dirs_blender(pose, H, W, focal):
    """Unit ray directions [H*W, 3] (float64 numpy) through the pixel
    centres of a blender-convention camera (looking along -z)."""
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5, indexing="xy")
    dirs_cam = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    dirs = dirs_cam @ pose[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.reshape(-1, 3)


@torch.no_grad()
def render_view(pose, H, W, focal, prims, device, n_steps=384):
    """Ground-truth RGB [H, W, 3] and alpha [H, W] of one view."""
    pa = prim_arrays(prims, device)
    dirs = torch.tensor(pixel_dirs_blender(pose, H, W, focal),
                        dtype=torch.float32, device=device)
    origin = torch.tensor(pose[:3, 3], dtype=torch.float32, device=device)
    ts = torch.linspace(1.0, 7.0, n_steps, dtype=torch.float32, device=device)
    dt = float((7.0 - 1.0) / (n_steps - 1))
    # a whole 800x800 view in one chunk: each ray's quadrature is its own,
    # so the chunk changes only how many launches a view takes
    chunk = 1 << 20
    imgs, accs = [], []
    for s in range(0, H * W, chunk):
        im, ac = _render_chunk(pa, origin, dirs[s:s + chunk], ts, dt)
        imgs.append(im)
        accs.append(ac)
    img = torch.cat(imgs).cpu().numpy().reshape(H, W, 3)
    acc = torch.cat(accs).cpu().numpy().reshape(H, W)
    return img, acc


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    """Blender-convention cam2world (camera looks along -z)."""
    eye = np.asarray(eye, np.float32)
    f = np.asarray(target, np.float32) - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float32))
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = r
    pose[:3, 1] = u
    pose[:3, 2] = -f
    pose[:3, 3] = eye
    return pose


def camera_poses(n, radius=3.5, seed=0):
    """The generator's train cameras: an orbit at `radius`, polar angle
    0.7-1.2 rad drawn from RandomState(seed), looking at the origin."""
    rng = np.random.RandomState(seed)
    poses = []
    for k in range(n):
        phi = 2 * np.pi * (k / n)
        theta = 0.7 + 0.5 * rng.rand()
        eye = (radius * np.sin(theta) * np.cos(phi),
               radius * np.sin(theta) * np.sin(phi),
               radius * np.cos(theta))
        poses.append(look_at_pose(eye))
    return poses


def focal_of(W, camera_angle_x):
    return W / (2 * np.tan(camera_angle_x / 2))


def write_blender_scene(out_dir, n_views, H, W, camera_angle_x=0.8,
                        radius=3.5, *, device):
    """Render the train split of the lego-class scene into out_dir in the
    blender layout (transforms_train.json and RGBA PNGs)."""
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)
    prims = lego_class_scene()
    focal = focal_of(W, camera_angle_x)
    frames = []
    for k, pose in enumerate(camera_poses(n_views, radius)):
        img, alpha = render_view(pose, H, W, focal, prims, device)
        rgba = np.concatenate([img, alpha[..., None]], -1)
        rgba = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(rgba).save(os.path.join(out_dir, f"train/r_{k}.png"))
        frames.append({"file_path": f"./train/r_{k}",
                       "transform_matrix": pose.tolist()})
    with open(os.path.join(out_dir, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    return out_dir


def first_hits(origin, dirs, prims):
    """Distance along each unit ray (origin [3], dirs [B, 3], float64
    tensors) to its first hit on each primitive's outer surface, [B, P]
    (inf where it misses). A box by the slab test, a shell by its outer
    sphere; rays start outside every primitive."""
    cols = []
    for prim in prims:
        if prim[0] == "shell":
            _, center, radius = prim[:3]
            oc = origin - torch.tensor(center, dtype=dirs.dtype,
                                       device=dirs.device)
            b = dirs @ oc
            c = float(oc @ oc) - radius * radius
            disc = b * b - c
            t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
            hit = (disc > 0) & (t > 0)
        else:
            _, center, half = prim[:3]
            lo = torch.tensor(center, dtype=dirs.dtype, device=dirs.device) \
                - torch.tensor(half, dtype=dirs.dtype, device=dirs.device)
            hi = 2 * torch.tensor(center, dtype=dirs.dtype,
                                  device=dirs.device) - lo
            t1 = (lo - origin) / dirs
            t2 = (hi - origin) / dirs
            t_near = torch.amax(torch.minimum(t1, t2), dim=-1)
            t_far = torch.amin(torch.maximum(t1, t2), dim=-1)
            t = t_near
            hit = (t_near <= t_far) & (t_near > 0)
        cols.append(torch.where(hit, t, torch.full_like(t, math.inf)))
    return torch.stack(cols, dim=-1)
