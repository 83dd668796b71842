"""An edit dataset for LAENeRF recolor training, from the lego-class
scene's exact geometry: the region is the base plate (primitive 0).

For every pixel of every camera the ray's first hit on each primitive is
found analytically (`lego_class.first_hits`). A region ray is one whose
first hit is the plate: its `x_term` is that hit, its target the scene's
colour there, its density and edit weights 1 (the plate is opaque). This
stands in for the distill render of a converged NeRF
(`editing/edit_dataset.py::EditDataset._extract_view`). The smooth-
transition factor measures each region point's distance to the first hits
on the other primitives, which is what the grow grid's termination points
are near the region. The views are padded and cropped as
`EditDataset._pad_view` lays them out, and written with the keys of
`EditDataset.save` (uncompressed), so the program's `EditDataset.load`
reads them. Coordinates are the program's: blender poses through the
instant-ngp convention (`nerf_matrix_to_ngp`, frozen here).
"""

import numpy as np
import torch

from .lego_class import (camera_poses, first_hits, focal_of,
                         lego_class_scene, texture)

DEPTH_DIFF = 0.65
MAX_DIST = 0.12
NUM_STEPS = 512


def nerf_matrix_to_ngp(pose, scale=0.33, offset=(0, 0, 0)):
    """Blender cam2world -> instant-ngp convention (a frozen copy of
    data/provider.py::nerf_matrix_to_ngp)."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def _round_up(x, m):
    return int(-(-x // m) * m)


def _ngp_rays(pose_ngp, H, W, focal):
    """Unit directions [H*W, 3] float64 through the pixel centres, as
    data/rays.py::get_rays lays them out, and the origin [3]."""
    row, col = np.divmod(np.arange(H * W), W)
    d = np.stack([(col + 0.5 - W / 2) / focal, (row + 0.5 - H / 2) / focal,
                  np.ones(H * W)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return d @ pose_ngp[:3, :3].astype(np.float64).T, \
        pose_ngp[:3, 3].astype(np.float64)


def _min_dist(pts, others, block=4096):
    out = torch.full((pts.shape[0],), torch.inf, device=pts.device)
    for s in range(0, others.shape[0], block):
        d = torch.cdist(pts, others[s:s + block])
        out = torch.minimum(out, d.amin(dim=1))
    return out


@torch.no_grad()
def _extract_view(pose_b, H, W, focal, scale, prims, device):
    pose_q = nerf_matrix_to_ngp(pose_b, scale)
    d_q, o_q = _ngp_rays(pose_q, H, W, focal)
    # ngp (q0, q1, q2) = scale * blender (p1, p2, p0)
    d_b = torch.tensor(d_q[:, [2, 0, 1]], dtype=torch.float64, device=device)
    o_b = torch.tensor(o_q[[2, 0, 1]] / scale, dtype=torch.float64,
                       device=device)
    hits = first_hits(o_b, d_b, prims)
    t_first, first = hits.min(dim=1)
    region = torch.isfinite(t_first) & (first == 0)
    mask = torch.nonzero(region).squeeze(1)
    if mask.numel() == 0:
        return None
    d_qt = torch.tensor(d_q, dtype=torch.float64, device=device)
    o_qt = torch.tensor(o_q, dtype=torch.float64, device=device)
    t_q = scale * t_first
    x_term = (o_qt + t_q[:, None] * d_qt)[mask]
    p_b = (o_b + t_first[mask, None] * d_b[mask]).float()
    plate = prims[0]
    n = mask.numel()
    targets = texture(p_b, torch.tensor(plate[3], device=device).expand(n, 3),
                      torch.full((n,), plate[5], device=device),
                      torch.full((n,), plate[6], device=device))
    other = torch.isfinite(t_first) & (first != 0)
    x_grow = (o_qt + t_q[:, None] * d_qt)[other].float()
    if x_grow.shape[0]:
        min_d = torch.clamp(_min_dist(x_term.float(), x_grow), max=MAX_DIST)
        dist_factor = 1.0 - min_d / torch.clamp(min_d.max(), min=1e-8)
    else:
        dist_factor = torch.zeros((n,), device=device)
    mask_np = mask.cpu().numpy().astype(np.int32)
    depths = t_q[mask].float().cpu().numpy()
    xs, ys = np.divmod(mask_np, W)
    return {
        "mask_inds": mask_np,
        "w8s": np.ones(n, np.float32),
        "targets": targets.cpu().numpy().astype(np.float32),
        "x_term": x_term.float().cpu().numpy(),
        "dirs": d_q[mask_np].astype(np.float32),
        "depths": depths,
        "pred_img": targets.cpu().numpy().astype(np.float32),
        "w_density": np.ones(n, np.float32),
        "w_edit": np.ones(n, np.float32),
        "dist_factor": dist_factor.float().cpu().numpy(),
        "bbox": (int(xs.min()), int(xs.max()) + 1, int(ys.min()),
                 int(ys.max()) + 1),
        "depth_factor": float((depths.max() - depths.min()) / NUM_STEPS),
    }


def _pad_view(idx, v, H, W, P, crop_h, crop_w):
    """A frozen copy of editing/edit_dataset.py::EditDataset._pad_view."""
    n = v["mask_inds"].shape[0]

    def pad1(a, fill=0):
        out = np.full((P,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    x0, x1, y0, y1 = v["bbox"]
    cx = min(max(0, (x0 + x1 - crop_h) // 2), H - crop_h)
    cy = min(max(0, (y0 + y1 - crop_w) // 2), W - crop_w)

    def cut(vals, width):
        full = np.zeros((H * W, width), np.float32)
        full[v["mask_inds"]] = vals.reshape(n, width)
        return full.reshape(H, W, width)[cx:cx + crop_h, cy:cy + crop_w]

    w_map = cut(v["w8s"], 1)[..., 0]
    cut_gt = cut(v["targets"], 3)
    cut_depth = cut(v["depths"], 1)[..., 0]
    cut_smooth = cut(v["dist_factor"], 1)[..., 0]

    w = w_map.copy()
    w[w < 0.98] = 0
    w_h = w[:-1, :] * w[1:, :]
    w_h[1:] = w_h[1:] * (w[:-2, :] * w[2:, :])
    w_v = w[:, :-1] * w[:, 1:]
    w_v[:, 1:] = w_v[:, 1:] * (w[:, :-2] * w[:, 2:])
    rgb_h = np.abs(cut_gt[:-1] - cut_gt[1:]).sum(-1)
    rgb_v = np.abs(cut_gt[:, :-1] - cut_gt[:, 1:]).sum(-1)
    tv_h = np.abs(cut_depth[:-1] - cut_depth[1:]) * w_h * rgb_h
    tv_v = np.abs(cut_depth[:, :-1] - cut_depth[:, 1:]) * w_v * rgb_v

    return {
        "view_index": idx,
        "n_valid": n,
        "inds": pad1(v["mask_inds"], fill=H * W),
        "valid": np.arange(P) < n,
        "w8s": pad1(v["w8s"]),
        "targets": pad1(v["targets"]),
        "x_term": pad1(v["x_term"]),
        "dirs": pad1(v["dirs"]),
        "depths": pad1(v["depths"]),
        "dist_factor": pad1(v["dist_factor"]),
        "w_density": pad1(v["w_density"]),
        "w_edit": pad1(v["w_edit"]),
        "pred_img": pad1(v["pred_img"]),
        "crop_origin": np.array([cx, cy], np.int32),
        "cut_gt": cut_gt,
        "cut_smooth": cut_smooth.astype(np.float32),
        "tv_h": tv_h.astype(np.float32),
        "tv_v": tv_v.astype(np.float32),
        "depth_factor": v["depth_factor"],
    }


def write_edit_dataset(path, n_views, H, W, scale, camera_angle_x=0.8,
                       radius=3.5, *, device):
    """Build the plate's edit dataset over the generator's n_views cameras
    and write it to the file `path` (npz, EditDataset.save's keys). Returns
    the number of region rays of each view."""
    prims = lego_class_scene()
    focal = focal_of(W, camera_angle_x)
    raw, occluded = [], []
    for i, pose in enumerate(camera_poses(n_views, radius)):
        v = _extract_view(pose, H, W, focal, scale, prims, device)
        if v is None:
            occluded.append(i)
        else:
            raw.append((i, v))
    if not raw:
        raise RuntimeError("the plate is occluded in every view")
    P = _round_up(max(v["mask_inds"].shape[0] for _, v in raw), 4096)
    crop_h = min(_round_up(max(v["bbox"][1] - v["bbox"][0] for _, v in raw),
                           8), H)
    crop_w = min(_round_up(max(v["bbox"][3] - v["bbox"][2] for _, v in raw),
                           8), W)
    views = [_pad_view(i, v, H, W, P, crop_h, crop_w) for i, v in raw]
    flat = {}
    for k in views[0]:
        if k in ("view_index", "n_valid", "depth_factor"):
            flat[k] = np.array([v[k] for v in views])
        else:
            flat[k] = np.stack([v[k] for v in views])
    with open(path, "wb") as f:
        np.savez(f, occluded=np.array(occluded, np.int32), H=H, W=W,
                 n_pad=P, crop_h=crop_h, crop_w=crop_w,
                 depth_diff=DEPTH_DIFF, max_dist=MAX_DIST,
                 num_steps=NUM_STEPS, **flat)
    return [int(v["n_valid"]) for v in views]
