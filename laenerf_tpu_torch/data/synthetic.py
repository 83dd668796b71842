"""Procedural synthetic dataset generator (counterpart of
laenerf_tpu/data/synthetic.py).

Writes a miniature blender-format scene (transforms_{train,val,test}.json +
RGBA pngs) by densely volume-rendering an analytic scene of colored
constant-density spheres, or the typed primitives of `lego_class_scene`
(a textured base plate, thin pillars, beams and hollow shells standing in
for nerf_synthetic/lego). The ground-truth renderer and
`scene_density_color` run in torch on the given device, the card unless
the caller asks for the CPU.
"""

import json
import math
import os

import numpy as np
import torch
from PIL import Image

# (center, radius, rgb, sigma)
DEFAULT_SPHERES = [
    ((0.0, 0.0, 0.0), 0.42, (0.85, 0.25, 0.2), 60.0),
    ((0.45, 0.3, 0.1), 0.22, (0.2, 0.7, 0.3), 60.0),
    ((-0.4, -0.25, 0.25), 0.18, (0.25, 0.35, 0.9), 60.0),
    ((0.1, -0.45, -0.35), 0.15, (0.9, 0.8, 0.2), 60.0),
]


def _texture(pts, rgb, freq: float, phase: float):
    """Procedural 3D color texture at points [N, 3] f32: the base color
    modulated by a sinusoidal field (exercises the fine hash-grid levels
    the way lego's decals do)."""
    base = torch.tensor(rgb, dtype=torch.float32, device=pts.device)
    if freq <= 0:
        return base.expand(pts.shape[:-1] + (3,))
    mod = 0.5 + 0.5 * torch.sin(
        (2 * math.pi * freq) * (pts[..., 0] + 0.7 * pts[..., 1]
                                + 0.41 * pts[..., 2]) + phase)
    return base * (0.55 + 0.45 * mod[..., None])


def lego_class_scene():
    """A 'lego-class' procedural scene: a textured base plate, a lattice of
    thin pillars, beams, and textured hollow spheres: thin geometry plus
    high-frequency appearance, standing in for nerf_synthetic/lego (not
    shipped). Primitives: ('box', center, half_extents, rgb, sigma, freq,
    phase) and ('shell', center, radius, thickness, rgb, sigma, freq,
    phase)."""
    prims = [
        ("box", (0.0, 0.0, -0.52), (0.62, 0.62, 0.05),
         (0.72, 0.65, 0.35), 200.0, 4.0, 0.0),
    ]
    # pillar lattice (thin structures ~0.035 world units)
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
    # cross beams
    prims.append(("box", (0.0, 0.0, 0.1), (0.5, 0.04, 0.035),
                  (0.25, 0.45, 0.8), 200.0, 8.0, 1.1))
    prims.append(("box", (0.0, 0.0, 0.22), (0.04, 0.5, 0.035),
                  (0.3, 0.75, 0.3), 200.0, 8.0, 2.3))
    # textured hollow spheres on top (shells, so interiors prune from the
    # occupancy grid like lego's hollow geometry)
    prims.append(("shell", (0.25, -0.2, 0.33), 0.13, 0.045,
                  (0.9, 0.75, 0.2), 160.0, 10.0, 0.4))
    prims.append(("shell", (-0.28, 0.22, 0.4), 0.16, 0.045,
                  (0.35, 0.4, 0.85), 160.0, 9.0, 2.8))
    prims.append(("shell", (0.0, 0.0, 0.5), 0.1, 0.04,
                  (0.85, 0.3, 0.3), 160.0, 12.0, 1.9))
    return prims


@torch.no_grad()
def scene_density_color(pts, spheres=None, *, device="cuda"):
    """Analytic scene: density [N] and color [N, 3] at points [N, 3] (an
    array or tensor, f32), as f32 tensors on `device`.

    Accepts the sphere tuples (center, radius, rgb, sigma) or the typed
    primitives of lego_class_scene(). A point takes the largest sigma of
    the primitives holding it and the color of the first of them; sphere
    and shell distances are squared in f64, as the JAX package's numpy
    version computes them."""
    pts = torch.as_tensor(pts, dtype=torch.float32, device=device)
    sigma = torch.zeros(pts.shape[:-1], dtype=torch.float32, device=device)
    color = torch.zeros(pts.shape[:-1] + (3,), dtype=torch.float32,
                        device=device)

    def dist2(center):
        d = pts.double() - torch.tensor(center, dtype=torch.float64,
                                        device=device)
        return d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2

    for prim in spheres or DEFAULT_SPHERES:
        if isinstance(prim[0], str):
            kind = prim[0]
            if kind == "sphere":
                _, center, radius, rgb, s, freq, phase = prim
                inside = dist2(center) < radius ** 2
            elif kind == "shell":
                _, center, radius, th, rgb, s, freq, phase = prim
                r2 = dist2(center)
                inside = (r2 < radius ** 2) & (r2 > (radius - th) ** 2)
            else:  # box
                _, center, half, rgb, s, freq, phase = prim
                d = (pts - torch.tensor(center, dtype=torch.float32,
                                        device=device)).abs()
                inside = torch.all(d < torch.tensor(
                    half, dtype=torch.float32, device=device), dim=-1)
        else:
            center, radius, rgb, s = prim
            freq, phase = 0.0, 0.0
            inside = dist2(center) < radius ** 2
        new = inside & (sigma == 0)
        color[new] = _texture(pts[new], rgb, freq, phase)
        sigma = torch.where(inside, torch.clamp(sigma, min=s), sigma)
    return sigma, color


def _look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
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


def _prim_arrays(spheres, device):
    """Primitives as typed tensors (kind 0 sphere, 1 shell, 2 box), in list
    order, which decides the first-hit color."""
    rows = []
    for prim in spheres or DEFAULT_SPHERES:
        if isinstance(prim[0], str):
            kind = prim[0]
            if kind == "sphere":
                _, center, radius, rgb, s, freq, phase = prim
                rows.append((0, center, (radius, 0, 0), rgb, s, freq, phase))
            elif kind == "shell":
                _, center, radius, th, rgb, s, freq, phase = prim
                rows.append((1, center, (radius, th, 0), rgb, s, freq, phase))
            else:
                _, center, half, rgb, s, freq, phase = prim
                rows.append((2, center, half, rgb, s, freq, phase))
        else:
            center, radius, rgb, s = prim
            rows.append((0, center, (radius, 0, 0), rgb, s, 0.0, 0.0))
    cols = ("kind", "center", "shape", "rgb", "sigma", "freq", "phase")
    out = {}
    for i, name in enumerate(cols):
        dtype = torch.int32 if name == "kind" else torch.float32
        out[name] = torch.tensor(np.array([r[i] for r in rows]), dtype=dtype,
                                 device=device)
    return out


def _eval_scene(pa, pts):
    """Density [B] and first-hit color [B, 3] at points [B, 3]."""
    rel = pts[:, None, :] - pa["center"][None]  # [B, P, 3]
    r2 = torch.sum(rel * rel, -1)
    rad = pa["shape"][:, 0][None]
    th = pa["shape"][:, 1][None]
    in_sphere = r2 < rad ** 2
    in_shell = in_sphere & (r2 > (rad - th) ** 2)
    in_box = torch.all(rel.abs() < pa["shape"][None], dim=-1)
    kind = pa["kind"][None]
    inside = torch.where(kind == 0, in_sphere,
                         torch.where(kind == 1, in_shell, in_box))
    first = inside.to(torch.int32).argmax(dim=1)  # lowest containing prim
    any_in = inside.any(dim=1)
    sigma = torch.amax(torch.where(inside, pa["sigma"][None], 0.0), dim=1)
    c = pa["rgb"][first]
    fr = pa["freq"][first]
    ph = pa["phase"][first]
    mod = 0.5 + 0.5 * torch.sin(
        2 * torch.pi * fr * (pts[:, 0] + 0.7 * pts[:, 1] + 0.41 * pts[:, 2])
        + ph)
    tex = c * (0.55 + 0.45 * mod[:, None])
    color = torch.where((fr > 0)[:, None], tex, c)
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


@torch.no_grad()
def _render_view_offset(pose, H, W, focal, spheres, n_steps, ox, oy, device):
    pa = _prim_arrays(spheres, device)
    i, j = np.meshgrid(np.arange(W) + 0.5 + ox, np.arange(H) + 0.5 + oy,
                       indexing="xy")
    dirs_cam = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1)
    dirs = dirs_cam @ pose[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = torch.tensor(dirs.reshape(-1, 3), dtype=torch.float32,
                        device=device)
    origin = torch.tensor(pose[:3, 3], dtype=torch.float32, device=device)
    ts = torch.linspace(1.0, 7.0, n_steps, dtype=torch.float32,
                        device=device)
    dt = float((7.0 - 1.0) / (n_steps - 1))
    chunk = 1 << 16
    imgs, accs = [], []
    for s in range(0, H * W, chunk):
        im, ac = _render_chunk(pa, origin, dirs[s:s + chunk], ts, dt)
        imgs.append(im)
        accs.append(ac)
    img = torch.cat(imgs).cpu().numpy().reshape(H, W, 3)
    acc = torch.cat(accs).cpu().numpy().reshape(H, W)
    return img, acc


def _render_view(pose, H, W, focal, spheres, n_steps=384, aa: int = 1, *,
                 device):
    """Ground-truth render of one view; aa > 1 supersamples aa^2 sub-pixel
    rays per pixel."""
    if aa <= 1:
        return _render_view_offset(pose, H, W, focal, spheres, n_steps,
                                   0.0, 0.0, device)
    img = acc = 0.0
    offs = (np.arange(aa) + 0.5) / aa - 0.5
    for oy in offs:
        for ox in offs:
            im, ac = _render_view_offset(pose, H, W, focal, spheres,
                                         n_steps, ox, oy, device)
            img, acc = img + im, acc + ac
    return img / aa ** 2, acc / aa ** 2


def generate_synthetic_scene(out_dir, n_train=20, n_val=2, n_test=3, H=100,
                             W=100, radius=3.5, camera_angle_x=0.8,
                             spheres=None, seed=0, aa: int = 1, *,
                             device="cuda"):
    """Write a blender-format scene under out_dir. Returns out_dir."""
    spheres = spheres or DEFAULT_SPHERES
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    focal = W / (2 * np.tan(camera_angle_x / 2))

    def make_split(name, n, start=0.0):
        frames = []
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        for k in range(n):
            phi = 2 * np.pi * (k / n) + start
            theta = 0.7 + 0.5 * rng.rand()
            eye = (
                radius * np.sin(theta) * np.cos(phi),
                radius * np.sin(theta) * np.sin(phi),
                radius * np.cos(theta),
            )
            pose = _look_at_pose(eye)
            img, alpha = _render_view(pose, H, W, focal, spheres, aa=aa,
                                      device=device)
            rgba = np.concatenate([img, alpha[..., None]], -1)
            rgba = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
            rel = f"{name}/r_{k}.png"
            Image.fromarray(rgba).save(os.path.join(out_dir, rel))
            frames.append({
                "file_path": f"./{name}/r_{k}",
                "transform_matrix": pose.tolist(),
            })
        with open(os.path.join(out_dir, f"transforms_{name}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)

    make_split("train", n_train)
    make_split("val", n_val, start=0.3)
    make_split("test", n_test, start=0.15)
    return out_dir
