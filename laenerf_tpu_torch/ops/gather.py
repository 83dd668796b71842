"""The gather probes (kernels K2, K3, K4 in csrc/gather_probes.cu).

    take_rows   out[i, j] = tbl[rows[i, j], j]    the hash-grid corner gather
    take_lanes  out[r, q] = tbl[r, idx[r, q]]     idx may be one row, broadcast
    grid_probe  out[q, j] = grid[row[q], col[q]]  one occupancy probe per ray,
                                                  written into `lanes` lanes

Counterparts of the TPU probes in perf/microbench_pallas.py and
perf/microbench_gather.py (csrc/gather_probes.cu lists which kernel replaces
which). Tables are float32, int32 or int8; indices are int32 and must lie in
range, as the TPU kernels' mode="promise_in_bounds" promises. Each wrapper
launches its kernel on a CUDA tensor, counts the launch in `<fn>.launches`,
and runs its plain version (`<fn>_plain`) on a CPU tensor. The plain versions
raise on indices out of range, as torch.gather does; the kernels do not check.
"""

import torch

from .cuda_build import I64, P, launch, on_cpu

_SOURCE = "gather_probes.cu"
_DTYPES = {torch.float32: "f32", torch.int32: "i32", torch.int8: "i8"}


def take_rows_plain(tbl, rows):
    """Plain PyTorch version of K2."""
    _check_take_rows(tbl, rows)
    return torch.gather(tbl, 0, rows.long())


def take_lanes_plain(tbl, idx):
    """Plain PyTorch version of K3."""
    _check_take_lanes(tbl, idx)
    return torch.gather(tbl, 1, idx.long().expand(tbl.shape[0], -1))


def grid_probe_plain(grid, row, col, lanes: int = 1, out_dtype=None):
    """Plain PyTorch version of K4."""
    out_dtype = _check_grid_probe(grid, row, col, lanes, out_dtype)
    R, C = grid.shape
    if bool(((row < 0) | (row >= R) | (col < 0) | (col >= C)).any()):
        raise IndexError(f"grid_probe: cell index out of range for a "
                         f"[{R}, {C}] grid")
    got = grid.reshape(-1)[row.long() * C + col.long()]
    return got.to(out_dtype)[:, None].expand(-1, lanes).contiguous()


def take_rows(tbl, rows):
    """out[i, j] = tbl[rows[i, j], j].

    Args:
      tbl: [R, W] float32, int32 or int8 table.
      rows: [Q, W] int32 row of each output element, in [0, R).
    Returns:
      [Q, W] of tbl's dtype.
    """
    if on_cpu("take_rows", tbl, rows):
        return take_rows_plain(tbl, rows)
    _check_take_rows(tbl, rows)
    Q, W = rows.shape
    out = torch.empty((Q, W), dtype=tbl.dtype, device=tbl.device)
    if out.numel():
        launch(_SOURCE, f"take_rows_{_DTYPES[tbl.dtype]}",
               [P, P, P, I64, I64], tbl, rows, out, Q, W)
        take_rows.launches += 1
    return out


def take_lanes(tbl, idx):
    """out[r, q] = tbl[r, idx[r, q]], or tbl[r, idx[0, q]] for a one-row idx.

    Args:
      tbl: [R, L] float32, int32 or int8 table.
      idx: [R, N] or [1, N] int32 lane of each output element, in [0, L). A
        one-row idx serves every table row (the kernel reads it with row
        stride 0; it is never expanded).
    Returns:
      [R, N] of tbl's dtype.
    """
    if on_cpu("take_lanes", tbl, idx):
        return take_lanes_plain(tbl, idx)
    _check_take_lanes(tbl, idx)
    R, L = tbl.shape
    N = idx.shape[1]
    out = torch.empty((R, N), dtype=tbl.dtype, device=tbl.device)
    if out.numel():
        row_stride = N if idx.shape[0] == R else 0
        launch(_SOURCE, f"take_lanes_{_DTYPES[tbl.dtype]}",
               [P, P, P, I64, I64, I64, I64], tbl, idx, out, R, L, N,
               row_stride)
        take_lanes.launches += 1
    return out


def grid_probe(grid, row, col, lanes: int = 1, out_dtype=None):
    """out[q, j] = grid[row[q], col[q]] for j < lanes.

    Args:
      grid: [R, C] float32, int32 or int8 occupancy grid.
      row, col: [Q] int32 cell of each ray, in [0, R) and [0, C).
      lanes: output lanes per ray (1 for one value per ray; the TPU probe
        P4 writes the value into all 128 lanes of its row).
      out_dtype: grid's dtype (default), or torch.int32 for an int8 grid.
    Returns:
      [Q, lanes] of out_dtype.
    """
    if on_cpu("grid_probe", grid, row, col):
        return grid_probe_plain(grid, row, col, lanes, out_dtype)
    out_dtype = _check_grid_probe(grid, row, col, lanes, out_dtype)
    Q = row.shape[0]
    out = torch.empty((Q, lanes), dtype=out_dtype, device=grid.device)
    if out.numel():
        launch(_SOURCE,
               f"grid_probe_{_DTYPES[grid.dtype]}_{_DTYPES[out_dtype]}",
               [P, P, P, P, I64, I64, I64], grid, row, col, out, Q, lanes,
               grid.shape[1])
        grid_probe.launches += 1
    return out


take_rows.launches = 0
take_lanes.launches = 0
grid_probe.launches = 0


def _check_table(name, tbl):
    if tbl.dim() != 2:
        raise ValueError(f"{name}: want a 2-D table, got {tuple(tbl.shape)}")
    if tbl.dtype not in _DTYPES:
        raise TypeError(f"{name}: table must be float32, int32 or int8, got "
                        f"{tbl.dtype}")


def _check_index(name, idx, dim):
    if idx.dim() != dim:
        raise ValueError(f"{name}: want a {dim}-D index, got "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {idx.dtype}")


def _check_take_rows(tbl, rows):
    _check_table("take_rows", tbl)
    _check_index("take_rows", rows, 2)
    if rows.shape[1] != tbl.shape[1]:
        raise ValueError(f"take_rows: rows {tuple(rows.shape)} and table "
                         f"{tuple(tbl.shape)} differ in width")


def _check_take_lanes(tbl, idx):
    _check_table("take_lanes", tbl)
    _check_index("take_lanes", idx, 2)
    if idx.shape[0] not in (1, tbl.shape[0]):
        raise ValueError(f"take_lanes: idx {tuple(idx.shape)} needs 1 or "
                         f"{tbl.shape[0]} rows")


def _check_grid_probe(grid, row, col, lanes, out_dtype):
    _check_table("grid_probe", grid)
    _check_index("grid_probe", row, 1)
    _check_index("grid_probe", col, 1)
    if row.shape != col.shape:
        raise ValueError(f"grid_probe: row {tuple(row.shape)} and col "
                         f"{tuple(col.shape)} differ")
    if lanes < 1:
        raise ValueError(f"grid_probe: lanes must be >= 1, got {lanes}")
    out_dtype = grid.dtype if out_dtype is None else out_dtype
    if out_dtype not in (grid.dtype, torch.int32) or (
            out_dtype == torch.int32 and grid.dtype == torch.float32):
        raise TypeError(f"grid_probe: cannot write a {grid.dtype} grid as "
                        f"{out_dtype}")
    return out_dtype
