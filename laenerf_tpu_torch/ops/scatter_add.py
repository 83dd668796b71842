"""Row scatter-add: the hash-grid backward's accumulation (kernel K1).

    out[t, c] = sum over update rows q with idx[q] == t of g[q, c]

Counterpart of laenerf_tpu/ops/scatter_add.py. The TPU kernel there sorts the
updates and accumulates (table tile, update block) work items with one-hot MXU
matmuls, because XLA's TPU scatter serializes. On the H100 the same function
is a CUDA kernel of f32 vector atomics (csrc/scatter_add.cu, which also
says what bounds it on the card): a thread owns whole update rows, and runs
of one row down a column of a 2-D idx [S, P] are summed in registers before
one atomic add. `scatter_add_rows_plain` computes the same function with
`index_add_`; the wrapper uses it only for tensors on the CPU.
"""

import torch

from ..utils.timers import span
from .cuda_build import I32, I64, P, launch

_SOURCE = "scatter_add.cu"
# rows of a 2-D idx's column one lane walks, summing runs of one row
# (chosen by K1's time inside train steps, PERF.md)
RUN_SPAN = 16
ROW_SPLIT = 32  # a 1-D idx [Q] runs as [ceil(Q / 32), 32], a row a lane


def scatter_add_rows_plain(idx, g, table_rows: int, *,
                           precision: str = "bf16", out_dtype=None):
    """Plain PyTorch version of K1 (f32 `index_add_`)."""
    _check_args(idx, g, table_rows, precision)
    C = g.shape[-1]
    idx, rows = idx.reshape(-1), _rows(g, precision).float().reshape(-1, C)
    out = torch.zeros((table_rows, C), dtype=torch.float32, device=g.device)
    keep = (idx >= 0) & (idx < table_rows)
    out.index_add_(0, idx[keep].long(), rows[keep])
    return out if out_dtype in (None, torch.float32) else out.to(out_dtype)


def scatter_add_rows(idx, g, table_rows: int, *, precision: str = "bf16",
                     out_dtype=None):
    """grad[t, c] = sum over updates q with idx[q] == t of g[q, c].

    Args:
      idx: [Q] or [S, P] int32 destination rows, any order and
        duplication; rows outside [0, table_rows) are dropped. The 2-D form
        computes the same function as its flattening; it says that rows
        tend to repeat down a column (the backward's [samples, levels x
        corners], samples in ray order), and the kernel sums such runs
        before it adds them.
      g: [Q, C] (or [S, P, C]) float32 or bfloat16 update rows.
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
    Either runs inside the tracer's span "k1", with attributes rows (idx's
    size), C and table_rows.
    """
    _check_args(idx, g, table_rows, precision)
    with span("k1", rows=idx.numel(), C=g.shape[-1], table_rows=table_rows):
        if g.device.type == "cpu":
            return scatter_add_rows_plain(idx, g, table_rows,
                                          precision=precision,
                                          out_dtype=out_dtype)
        return _scatter_add_rows_cuda(idx, g, table_rows, precision,
                                      out_dtype)


def _scatter_add_rows_cuda(idx, g, table_rows, precision, out_dtype):
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {g.device}")
    if idx.device != g.device:
        raise ValueError("scatter_add_rows: idx and g on different devices")
    if idx.dtype != torch.int32:
        raise TypeError(f"scatter_add_rows: idx must be int32, got {idx.dtype}")
    rows = _rows(g, precision)
    if not (idx.is_contiguous() and rows.is_contiguous()):
        raise ValueError("scatter_add_rows: idx and g must be contiguous")
    Q, C = idx.numel(), rows.shape[-1]
    S, cols = idx.shape if idx.dim() == 2 else (-(-Q // ROW_SPLIT), ROW_SPLIT)
    out = torch.zeros((table_rows, C), dtype=torch.float32, device=g.device)
    if Q > 0:
        name = ("scatter_add_rows_bf16" if rows.dtype == torch.bfloat16
                else "scatter_add_rows_f32")
        # a 1-D idx says nothing of repeats, so each lane takes one row
        run_span = RUN_SPAN if idx.dim() == 2 else 1
        launch(_SOURCE, name, [P, P, P, I64, I64, I64, I32, I64, I32], idx,
               rows, out, S, cols, Q, C, table_rows, run_span)
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
    if idx.dim() not in (1, 2) or g.dim() != idx.dim() + 1 \
            or g.shape[:-1] != idx.shape:
        raise ValueError(f"scatter_add_rows: want idx [Q] and g [Q, C], or "
                         f"idx [S, P] and g [S, P, C], got "
                         f"{tuple(idx.shape)} and {tuple(g.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_add_rows: g must be float32 or bfloat16, "
                        f"got {g.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"scatter_add_rows: idx must be integer, got "
                        f"{idx.dtype}")
    if table_rows < 0:
        raise ValueError("scatter_add_rows: table_rows must be >= 0")
