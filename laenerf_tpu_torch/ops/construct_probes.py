"""The construct probes (kernel K7 in csrc/construct_probes.cu).

perf/bisect_mosaic.py ran one Pallas construct per kernel to find the one the
TPU compiler refused. Each function here is the Hopper counterpart of one of
them; each writes an f32 [n_tiles * tile, C] output, tile k in rows
[k * tile, (k + 1) * tile):

  k1  prefetch_write(lo, n_tiles, tile, C)   tile k = lo[k]
  k2  static_copy(g, n_tiles, tile)          tile k = g[0:tile]
  k3  dynamic_copy(g, lo, n_tiles, tile)     tile k = g[lo[k]:lo[k] + tile]
  k4  copy_1d(q, lo, n_tiles, tile, C)       row r of tile k = q[lo[k] + r]
  k5  dynamic_loop(lo, n_tiles, tile, C)     tile k = 1 added lo[k] times
  k6  onehot_dot(local, g, tile)             tile k = onehot(local[k]) @ g[k],
                                             the one-hot [tile, maxu] with
                                             (r, m) = local[k, m] == r, times
                                             g[k] [maxu, C] bf16, f32 sums;
                                             k6b is C = 128
  k7  iota_rows(n_tiles, tile, C)            row r of tile k = r

k1, k5 and k7 share one fill body: each tile in 2 KB slices, one block
each, a 16-byte store a thread (a tile that starts off 16 bytes stores its
head and tail a float at a time); k5's thread runs the loop of lo[k] trips
once, and k7's float4 lies in one row where C % 4 == 0 (other C: a float a
thread, on the same kind of grid). k2-k4 are bulk asynchronous copies into
shared memory that complete on an mbarrier (k2 and k3 one block per 2 KB
slice of a tile, stored back with a bulk copy out; k4 one block per 64 rows
of a tile, converted and stored with 16-byte stores); k6 buckets each
tile's columns by 32-row window and runs the product over each window's
columns on the tensor cores, one block per (tile, window, channel chunk).
Each wrapper launches its kernel on a CUDA tensor, counts the launch in
`<fn>.launches`, and runs its plain version (`<fn>_plain`) on a CPU tensor.
Offsets must lie in range: the plain versions raise, the kernels do not
check. Every output is exact (copies, integer
counts, a one-hot product whose rows sum bf16 values in f32), so a kernel
and its plain version agree bit for bit wherever no output row sums two
nonzero terms of g.
"""

import torch

from .cuda_build import I32, I64, P, check_int32, launch, on_cpu

_SOURCE = "construct_probes.cu"
_MAX_TRIP = 1 << 24  # k5 adds 1.0 in f32: exact up to 2^24


def prefetch_write_plain(lo, n_tiles: int, tile: int, C: int):
    """Plain PyTorch version of k1."""
    check_int32("lo", lo, n_tiles)
    return _tiles(lo[:n_tiles].float(), tile, C)


def static_copy_plain(g, n_tiles: int, tile: int):
    """Plain PyTorch version of k2."""
    _check_rows("static_copy", g, tile)
    return g[:tile].repeat(n_tiles, 1)


def dynamic_copy_plain(g, lo, n_tiles: int, tile: int):
    """Plain PyTorch version of k3."""
    _check_rows("dynamic_copy", g, tile)
    start = _check_offsets("dynamic_copy", lo, n_tiles, g.shape[0] - tile)
    rows = start[:, None] + torch.arange(tile, device=g.device)
    return g[rows.reshape(-1)]


def copy_1d_plain(q, lo, n_tiles: int, tile: int, C: int):
    """Plain PyTorch version of k4."""
    _check_1d(q)
    start = _check_offsets("copy_1d", lo, n_tiles, q.shape[0] - tile)
    rows = start[:, None] + torch.arange(tile, device=q.device)
    return q[rows.reshape(-1)].float()[:, None].expand(-1, C).contiguous()


def dynamic_loop_plain(lo, n_tiles: int, tile: int, C: int):
    """Plain PyTorch version of k5."""
    trips = _check_offsets("dynamic_loop", lo, n_tiles, _MAX_TRIP, low=None)
    return _tiles(trips.clamp(min=0).float(), tile, C)


def onehot_dot_plain(local, g, tile: int):
    """Plain PyTorch version of k6: f32 index_add_ of the bf16 rows whose
    local row lies in [0, tile)."""
    n_tiles, maxu, C = _check_onehot(local, g, tile)
    out = torch.zeros((n_tiles * tile, C), dtype=torch.float32,
                      device=g.device)
    loc = local.long()
    keep = (loc >= 0) & (loc < tile)
    rows = loc + torch.arange(n_tiles, device=g.device)[:, None] * tile
    return out.index_add_(0, rows[keep], g[keep].float())


def iota_rows_plain(n_tiles: int, tile: int, C: int, device="cpu"):
    """Plain PyTorch version of k7."""
    rows = torch.arange(tile, device=device).float().repeat(n_tiles)
    return rows[:, None].expand(-1, C).contiguous()


def prefetch_write(lo, n_tiles: int, tile: int, C: int):
    """k1: tile k = lo[k] (lo: int32 [>= n_tiles])."""
    if on_cpu("prefetch_write", lo):
        return prefetch_write_plain(lo, n_tiles, tile, C)
    check_int32("lo", lo, n_tiles)
    out = _out(n_tiles, tile, C, lo.device)
    _launch(prefetch_write, n_tiles, "probe_prefetch_write",
            [P, P, I64, I32, I32], lo, out, n_tiles, tile, C)
    return out


def static_copy(g, n_tiles: int, tile: int):
    """k2: tile k = g[0:tile] (g: f32 [R >= tile, C], C % 4 == 0)."""
    if on_cpu("static_copy", g):
        return static_copy_plain(g, n_tiles, tile)
    _check_rows("static_copy", g, tile)
    out = _out(n_tiles, tile, g.shape[1], g.device)
    _launch(static_copy, n_tiles, "probe_static_copy",
            [P, P, I64, I32, I32], g, out, n_tiles, tile, g.shape[1])
    return out


def dynamic_copy(g, lo, n_tiles: int, tile: int):
    """k3: tile k = g[lo[k]:lo[k] + tile], lo[k] in [0, R - tile]."""
    if on_cpu("dynamic_copy", g, lo):
        return dynamic_copy_plain(g, lo, n_tiles, tile)
    _check_rows("dynamic_copy", g, tile)
    check_int32("lo", lo, n_tiles)
    out = _out(n_tiles, tile, g.shape[1], g.device)
    _launch(dynamic_copy, n_tiles, "probe_dynamic_copy",
            [P, P, P, I64, I32, I32], g, lo, out, n_tiles, tile, g.shape[1])
    return out


def copy_1d(q, lo, n_tiles: int, tile: int, C: int):
    """k4: row r of tile k = q[lo[k] + r] in all C lanes; q int32 [N],
    N % 4 == 0, lo[k] in [0, N - tile]."""
    if on_cpu("copy_1d", q, lo):
        return copy_1d_plain(q, lo, n_tiles, tile, C)
    _check_1d(q)
    check_int32("lo", lo, n_tiles)
    out = _out(n_tiles, tile, C, q.device)
    _launch(copy_1d, n_tiles, "probe_copy_1d", [P, P, P, I64, I32, I32], q,
            lo, out, n_tiles, tile, C)
    return out


def dynamic_loop(lo, n_tiles: int, tile: int, C: int):
    """k5: tile k = 1.0 added lo[k] times (0 for lo[k] <= 0; lo[k] <=
    2^24)."""
    if on_cpu("dynamic_loop", lo):
        return dynamic_loop_plain(lo, n_tiles, tile, C)
    check_int32("lo", lo, n_tiles)
    out = _out(n_tiles, tile, C, lo.device)
    _launch(dynamic_loop, n_tiles, "probe_dynamic_loop",
            [P, P, I64, I32, I32], lo, out, n_tiles, tile, C)
    return out


def onehot_dot(local, g, tile: int):
    """k6/k6b: tile k = onehot(local[k]) @ g[k] on the tensor cores.

    Args:
      local: [n_tiles, maxu] int32 row of each update within its tile;
        rows outside [0, tile) add nothing; 16-byte aligned.
      g: [n_tiles, maxu, C] bfloat16 update rows; C == 8 or a multiple of
        16; 32-byte aligned.
      tile: rows per tile, a multiple of 32; maxu a multiple of 16.
    Returns:
      [n_tiles * tile, C] float32.
    """
    if on_cpu("onehot_dot", local, g):
        return onehot_dot_plain(local, g, tile)
    n_tiles, maxu, C = _check_onehot(local, g, tile)
    out = _out(n_tiles, tile, C, g.device)
    _launch(onehot_dot, n_tiles, "probe_onehot_dot",
            [P, P, P, I64, I32, I32, I32], local, g, out, n_tiles, tile, maxu,
            C)
    return out


def iota_rows(n_tiles: int, tile: int, C: int, device="cuda"):
    """k7: row r of each tile = r."""
    device = torch.device(device)
    if device.type == "cpu":
        return iota_rows_plain(n_tiles, tile, C)
    if device.type != "cuda":
        raise ValueError(f"iota_rows: unsupported device {device}")
    out = _out(n_tiles, tile, C, device)
    _launch(iota_rows, n_tiles, "probe_iota", [P, I64, I32, I32], out,
            n_tiles, tile, C)
    return out


# each wrapper and its plain version
PLAIN = {prefetch_write: prefetch_write_plain, static_copy: static_copy_plain,
         dynamic_copy: dynamic_copy_plain, copy_1d: copy_1d_plain,
         dynamic_loop: dynamic_loop_plain, onehot_dot: onehot_dot_plain,
         iota_rows: iota_rows_plain}
for _fn in PLAIN:
    _fn.launches = 0


def _launch(wrapper, n_tiles, fn_name, argtypes, *args):
    if n_tiles:
        launch(_SOURCE, fn_name, argtypes, *args)
        wrapper.launches += 1


def _out(n_tiles, tile, C, device):
    if n_tiles < 0 or tile < 1 or C < 1:
        raise ValueError(f"want n_tiles >= 0, tile >= 1, C >= 1, got "
                         f"{n_tiles}, {tile}, {C}")
    return torch.empty((n_tiles * tile, C), dtype=torch.float32,
                       device=device)


def _tiles(values, tile, C):
    return values.repeat_interleave(tile)[:, None].expand(-1, C).contiguous()


def _check_offsets(name, lo, n_tiles, high=None, low=0):
    """lo[:n_tiles] as int64, raising where an entry leaves [low, high]."""
    check_int32("lo", lo, n_tiles)
    start = lo[:n_tiles].long()
    bad = torch.zeros_like(start, dtype=torch.bool)
    if low is not None:
        bad |= start < low
    if high is not None:
        bad |= start > high
    if bool(bad.any()):
        raise IndexError(f"{name}: an offset leaves [{low}, {high}]")
    return start


def _check_rows(name, g, tile):
    if g.dim() != 2 or g.dtype != torch.float32:
        raise TypeError(f"{name}: g must be a 2-D float32 tensor, got "
                        f"{g.dtype} {tuple(g.shape)}")
    if g.shape[1] % 4 or g.shape[0] < tile:
        raise ValueError(f"{name}: want g [R >= {tile}, C % 4 == 0] (16-byte "
                         f"rows), got {tuple(g.shape)}")
    if g.data_ptr() % 16:
        raise ValueError(f"{name}: g must be 16-byte aligned")


def _check_1d(q):
    check_int32("q", q)
    if q.shape[0] % 4 or q.data_ptr() % 16:
        raise ValueError(f"copy_1d: q needs a length that is a multiple of 4 "
                         f"and a 16-byte aligned start, got {q.shape[0]}")


def _check_onehot(local, g, tile):
    if local.dim() != 2 or local.dtype != torch.int32:
        raise TypeError(f"onehot_dot: local must be 2-D int32, got "
                        f"{local.dtype} {tuple(local.shape)}")
    if g.dim() != 3 or g.dtype != torch.bfloat16 or \
            g.shape[:2] != local.shape:
        raise TypeError(f"onehot_dot: g must be bf16 [n_tiles, maxu, C] "
                        f"matching local {tuple(local.shape)}, got {g.dtype} "
                        f"{tuple(g.shape)}")
    n_tiles, maxu, C = g.shape
    if g.data_ptr() % 32 or local.data_ptr() % 16:
        raise ValueError("onehot_dot: g must be 32-byte and local 16-byte "
                         "aligned")
    if tile % 32 or maxu % 16 or not (C == 8 or C % 16 == 0):
        raise ValueError(f"onehot_dot: want tile % 32 == 0, maxu % 16 == 0 "
                         f"and C == 8 or C % 16 == 0, got {tile}, {maxu}, "
                         f"{C}")
    return n_tiles, maxu, C
