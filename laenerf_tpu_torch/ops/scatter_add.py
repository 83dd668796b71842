"""Row scatter-add: the hash-grid backward's accumulation (kernel K1).

    out[t, c] = sum over update rows q with idx[q] == t of g[q, c]

Counterpart of laenerf_tpu/ops/scatter_add.py. The TPU kernel there sorts the
updates and accumulates (table tile, update block) work items with one-hot MXU
matmuls, because XLA's TPU scatter serializes. On the H100 the same function
is a CUDA kernel of f32 atomics (csrc/scatter_add.cu, which also says what
bounds it on the card). `scatter_add_rows_plain` computes the same function
with `index_add_`; the wrapper uses it only for tensors on the CPU.
"""

import torch

from .cuda_build import I32, I64, P, launch

_SOURCE = "scatter_add.cu"


def scatter_add_rows_plain(idx, g, table_rows: int, *,
                           precision: str = "bf16", out_dtype=None):
    """Plain PyTorch version of K1 (f32 `index_add_`)."""
    _check_args(idx, g, table_rows, precision)
    rows = _rows(g, precision).float()
    out = torch.zeros((table_rows, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    keep = (idx >= 0) & (idx < table_rows)
    out.index_add_(0, idx[keep].long(), rows[keep])
    return out if out_dtype in (None, torch.float32) else out.to(out_dtype)


def scatter_add_rows(idx, g, table_rows: int, *, precision: str = "bf16",
                     out_dtype=None):
    """grad[t, c] = sum over updates q with idx[q] == t of g[q, c].

    Args:
      idx: [Q] int32 destination rows, any order and duplication; rows
        outside [0, table_rows) are dropped.
      g: [Q, C] float32 or bfloat16 update rows.
      table_rows: T, number of output rows.
      precision: "bf16" rounds each update row to bf16 before the f32
        accumulation (the reference's default); "f32" accumulates the rows
        as they are.
      out_dtype: torch.float32 (default) or torch.bfloat16, converted once
        after the f32 accumulation.
    Returns:
      [T, C] accumulated gradient.

    On a CUDA tensor this launches K1 and counts the launch in
    `scatter_add_rows.launches`; on a CPU tensor it runs the plain version.
    """
    if g.device.type == "cpu":
        return scatter_add_rows_plain(idx, g, table_rows,
                                      precision=precision,
                                      out_dtype=out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {g.device}")
    _check_args(idx, g, table_rows, precision)
    if idx.device != g.device:
        raise ValueError("scatter_add_rows: idx and g on different devices")
    if idx.dtype != torch.int32:
        raise TypeError(f"scatter_add_rows: idx must be int32, got {idx.dtype}")
    rows = _rows(g, precision)
    if not (idx.is_contiguous() and rows.is_contiguous()):
        raise ValueError("scatter_add_rows: idx and g must be contiguous")
    Q, C = rows.shape
    out = torch.zeros((table_rows, C), dtype=torch.float32, device=g.device)
    if Q > 0:
        name = ("scatter_add_rows_bf16" if rows.dtype == torch.bfloat16
                else "scatter_add_rows_f32")
        launch(_SOURCE, name, [P, P, P, I64, I32, I64], idx, rows, out, Q,
               C, table_rows)
        scatter_add_rows.launches += 1
    return out if out_dtype in (None, torch.float32) else out.to(out_dtype)


scatter_add_rows.launches = 0


def _rows(g, precision):
    if precision == "bf16":
        return g.to(torch.bfloat16)
    return g.to(torch.float32)


def _check_args(idx, g, table_rows, precision):
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got {precision}")
    if g.dim() != 2 or idx.dim() != 1 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"scatter_add_rows: want idx [Q] and g [Q, C], got "
                         f"{tuple(idx.shape)} and {tuple(g.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_add_rows: g must be float32 or bfloat16, "
                        f"got {g.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"scatter_add_rows: idx must be integer, got "
                        f"{idx.dtype}")
    if table_rows < 0:
        raise ValueError("scatter_add_rows: table_rows must be >= 0")
