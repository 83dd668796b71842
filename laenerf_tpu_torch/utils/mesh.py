"""Mesh extraction from the density field (counterpart of
laenerf_tpu/utils/mesh.py): marching tetrahedra over a dense grid (the
6-tet cube decomposition, no lookup tables) in numpy, a binary PLY writer,
and save_density_mesh, which evaluates the EMA network's density on the
trainer's device in chunks.
"""

import numpy as np
import torch

# standard 6-tet decomposition of the unit cube with corners indexed by
# bit pattern (x + 2y + 4z)
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 5, 7],
    [0, 2, 3, 7],
    [0, 2, 6, 7],
    [0, 4, 5, 7],
    [0, 4, 6, 7],
], dtype=np.int32)

_CUBE_CORNERS = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)],
    dtype=np.int32,
)  # corner i = bits (x, y, z) of i


def marching_tetrahedra(field, threshold):
    """Extract an isosurface from a dense scalar field.

    Args:
      field: [X, Y, Z] float array.
      threshold: iso value.
    Returns:
      verts [V, 3] (grid coordinates), faces [F, 3] int32.
    """
    X, Y, Z = field.shape
    # corner values for every cell: [X-1, Y-1, Z-1, 8]
    c = np.empty((X - 1, Y - 1, Z - 1, 8), field.dtype)
    for i, (dx, dy, dz) in enumerate(_CUBE_CORNERS):
        c[..., i] = field[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]

    base = np.stack(np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                                np.arange(Z - 1), indexing="ij"), -1)
    cells = base.reshape(-1, 3)
    vals = c.reshape(-1, 8)

    # quick reject cells fully inside/outside
    mask = (vals.max(1) >= threshold) & (vals.min(1) < threshold)
    cells, vals = cells[mask], vals[mask]
    if cells.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    verts_list = []
    for tet in _TETS:
        tv = vals[:, tet]  # [N, 4]
        inside = tv >= threshold  # [N, 4]
        code = (inside * np.array([1, 2, 4, 8])).sum(1)
        corner_pos = (cells[:, None, :] + _CUBE_CORNERS[tet][None]).astype(
            np.float32
        )  # [N, 4, 3]

        def interp(ai, bi, sel):
            va, vb = tv[sel, ai], tv[sel, bi]
            t = (threshold - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12,
                                            vb - va)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return corner_pos[sel, ai] * (1 - t) + corner_pos[sel, bi] * t

        # enumerate the 14 non-trivial sign configurations
        for cfg in range(1, 15):
            sel = np.nonzero(code == cfg)[0]
            if sel.size == 0:
                continue
            bits = [(cfg >> k) & 1 for k in range(4)]
            ins = [k for k in range(4) if bits[k]]
            outs = [k for k in range(4) if not bits[k]]
            if len(ins) == 1:
                a = ins[0]
                tri = np.stack([interp(a, outs[0], sel),
                                interp(a, outs[1], sel),
                                interp(a, outs[2], sel)], axis=1)
                verts_list.append(tri.reshape(-1, 3))
            elif len(ins) == 3:
                a = outs[0]
                tri = np.stack([interp(ins[0], a, sel),
                                interp(ins[1], a, sel),
                                interp(ins[2], a, sel)], axis=1)
                verts_list.append(tri.reshape(-1, 3))
            else:  # 2 in / 2 out -> quad = 2 triangles
                a, b = ins
                p, q = outs
                e_ap = interp(a, p, sel)
                e_aq = interp(a, q, sel)
                e_bp = interp(b, p, sel)
                e_bq = interp(b, q, sel)
                tri1 = np.stack([e_ap, e_aq, e_bq], axis=1)
                tri2 = np.stack([e_ap, e_bq, e_bp], axis=1)
                verts_list.append(tri1.reshape(-1, 3))
                verts_list.append(tri2.reshape(-1, 3))

    tri_verts = np.concatenate(verts_list, axis=0)
    # weld duplicate vertices
    quant = np.round(tri_verts * 4096).astype(np.int64)
    uniq, inv = np.unique(quant, axis=0, return_inverse=True)
    verts = uniq.astype(np.float32) / 4096.0
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return verts, faces[ok]


def write_ply(path, verts, faces):
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        verts.astype("<f4").tofile(f)
        rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = faces
        rec.tofile(f)


@torch.no_grad()
def save_density_mesh(trainer, path, resolution: int = 256,
                      threshold: float = 10.0, chunk: int = 65536):
    """Evaluate the EMA network's density on a resolution^3 grid over
    [-bound, bound]^3 and write its threshold isosurface to path (PLY).
    Returns (verts [V, 3] world coordinates, faces [F, 3])."""
    from ..models.nerf import gather_table_for, nerf_density

    bound = trainer.model_cfg.bound
    xs = np.linspace(-bound, bound, resolution, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    net = trainer.ema_net
    table = gather_table_for(net)
    sig = np.empty(pts.shape[0], np.float32)
    for s in range(0, pts.shape[0], chunk):
        x = torch.as_tensor(pts[s:s + chunk], device=trainer.device)
        sig[s:s + chunk] = nerf_density(net, x, gather_table=table)[
            "sigma"].float().cpu().numpy()
    field = sig.reshape(resolution, resolution, resolution)

    verts, faces = marching_tetrahedra(field, threshold)
    verts = verts / (resolution - 1) * 2 * bound - bound  # grid -> world
    write_ply(path, verts, faces)
    return verts, faces
