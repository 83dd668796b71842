"""The sorted scatter-add (kernels K5 and K6 in csrc/sorted_scatter.cu).

    out[t, c] = sum over update rows q with qs[q] == t of gs[q, c]

over update rows sorted by destination row, into a table of n_tiles tiles of
`tile` rows; rows outside the table are dropped.

  tile_scatter      K5: even chunks of the sorted updates, whose runs of
                    one row are summed in registers and stored (or, at a
                    chunk's 32-update edge, added with vector atomics) into
                    a zero-filled output; an update counts only in its
                    tile's slab [lo[k], lo[k+1])
  worklist_scatter  K6: one block per (table tile wt, update block wb) work
                    item, combined with f32 atomics into a zero-filled output

Counterparts of the TPU prototypes perf/microbench_scatter2.py:137 (K5) and
perf/probe_worklist.py:71, perf/probe_worklist2.py:71 (K6, f32 and bf16
rows); csrc/sorted_scatter.cu says what bounds them. Beside them, the tensor
code that surrounds those TPU calls, as XLA ran it:

  sort_stage      argsort, take, searchsorted (microbench_scatter2.py:118-125)
  build_worklist  the work list (probe_worklist.py:122-139)

Each kernel wrapper launches its kernel on a CUDA tensor, counts the launch in
`<fn>.launches`, and runs its plain version (`<fn>_plain`, `index_add_` of the
kept rows, bf16 rows cast to f32) on a CPU tensor.
"""

from typing import NamedTuple

import torch

from .cuda_build import I32, I64, P, check_int32, launch, on_cpu

_SOURCE = "sorted_scatter.cu"
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100


class WorkSizes(NamedTuple):
    """Sizes of a sorted scatter of Q updates into T rows
    (probe_worklist.py:42-46, :65)."""
    t_pad: int  # T rounded up to whole tiles
    n_tiles: int
    q_blks: int  # update blocks of maxu, plus one block of padding
    w_cap: int  # work-list capacity


def work_sizes(Q: int, T: int, tile: int, maxu: int) -> WorkSizes:
    t_pad = -(-T // tile) * tile
    n_tiles = t_pad // tile
    blocks = -(-Q // maxu)
    return WorkSizes(t_pad, n_tiles, blocks + 1, n_tiles + blocks + 8)


def sort_stage(idx, g, tile: int, n_tiles: int):
    """Updates sorted by row and each tile's slab start.

    Returns qs [Q] int32 (idx sorted, stable), gs [Q, C] (g's rows in that
    order) and lo [n_tiles + 1] int32, lo[k] = first q with qs[q] >= k*tile.
    """
    qs, order = torch.sort(idx, stable=True)
    gs = g.index_select(0, order)
    bounds = torch.arange(n_tiles + 1, dtype=qs.dtype,
                          device=qs.device) * tile
    lo = torch.searchsorted(qs, bounds).to(torch.int32)
    return qs, gs, lo


def build_worklist(lo, maxu: int, w_cap: int, q_blks: int):
    """The work list of (table tile, update block) items.

    Each tile with updates gets one item per maxu-update block its slab
    [lo[k], lo[k+1]) touches; a tile without gets one dummy item. Returns
    int32 [w_cap] arrays wt (tile), wb (block), wfirst (1 on a tile's first
    item), wreal (1 where the item has updates); items past the list's end
    have wfirst = wreal = 0.
    """
    lo = lo.long()
    n_tiles = lo.shape[0] - 1
    cnt = lo[1:] - lo[:-1]
    blk_lo = lo[:-1] // maxu
    blk_hi = (lo[1:].clamp(min=1) - 1) // maxu  # inclusive
    n_work = torch.where(cnt > 0, blk_hi - blk_lo + 1, 1)
    cum = torch.cumsum(n_work, 0)
    w_ids = torch.arange(w_cap, device=lo.device)
    wt = torch.searchsorted(cum, w_ids, right=True).clamp(max=n_tiles - 1)
    w_off = w_ids - torch.where(wt > 0, cum[(wt - 1).clamp(min=0)], 0)
    live = w_ids < cum[-1]
    wreal = live & (cnt[wt] > 0)
    wfirst = (w_off == 0) & live
    wb = torch.where(wreal, blk_lo[wt] + w_off, q_blks - 1).clamp(
        0, q_blks - 1)
    return wt.int(), wb.int(), wfirst.int(), wreal.int()


def tile_scatter_plain(qs, gs, lo, tile: int):
    """Plain PyTorch version of K5."""
    n_tiles = _check_tile(qs, gs, lo, tile)
    Q, C = gs.shape
    out = torch.zeros((n_tiles * tile, C), dtype=torch.float32,
                      device=gs.device)
    q = torch.arange(Q, device=gs.device)
    k = torch.searchsorted(lo.long(), q, right=True) - 1  # q's slab
    keep = ((k >= 0) & (k < n_tiles) & (qs >= k * tile)
            & (qs < (k + 1) * tile))
    return out.index_add_(0, qs[keep].long(), gs[keep].float())


def worklist_scatter_plain(qs, gs, wt, wb, wreal, tile: int, maxu: int,
                           n_tiles: int):
    """Plain PyTorch version of K6."""
    _check_worklist(qs, gs, wt, wb, wreal, tile, maxu, n_tiles)
    Q, C = gs.shape
    out = torch.zeros((n_tiles * tile, C), dtype=torch.float32,
                      device=gs.device)
    real = (wreal != 0) & (wt >= 0) & (wt < n_tiles)
    begin = (wb[real].long() * maxu).clamp(0, Q)
    q = begin[:, None] + torch.arange(maxu, device=gs.device)
    t = wt[real].long()[:, None].expand_as(q)
    in_q = q < Q
    q, t = q[in_q], t[in_q]
    row = qs[q].long()
    keep = (row >= t * tile) & (row < (t + 1) * tile)
    return out.index_add_(0, row[keep], gs[q[keep]].float())


def tile_scatter(qs, gs, lo, tile: int):
    """out[t, c] = sum of gs[q, c] over q in tile k's slab with qs[q] == t.

    Args:
      qs: [Q] int32 destination rows, sorted (the kernel stores a row whose
        kept updates it finds together, so it needs them adjacent; the
        plain version takes any order).
      gs: [Q, C] float32 or bfloat16 update rows in qs's order.
      lo: [n_tiles + 1] int32 slab starts, non-decreasing in [0, Q]: tile k
        reads updates [lo[k], lo[k+1]) and keeps those whose row lies in
        [k * tile, (k + 1) * tile) (sort_stage gives lo).
      tile: rows per tile.
    Returns:
      [n_tiles * tile, C] float32, zero where nothing was added.
    """
    if on_cpu("tile_scatter", qs, gs, lo):
        return tile_scatter_plain(qs, gs, lo, tile)
    n_tiles = _check_tile(qs, gs, lo, tile)
    Q, C = gs.shape
    out = torch.zeros((n_tiles * tile, C), dtype=torch.float32,
                      device=gs.device)
    if n_tiles and Q and C:
        launch(_SOURCE, f"tile_scatter_{_DTYPES[gs.dtype]}",
               [P, P, P, P, I64, I64, I32, I32], qs, gs, lo, out, Q, n_tiles,
               tile, C)
        tile_scatter.launches += 1
    return out


def worklist_scatter(qs, gs, wt, wb, wreal, tile: int, maxu: int,
                     n_tiles: int):
    """out[t, c] = sum over real work items w with wt[w] == t // tile of the
    gs[q, c] in update block wb[w] with qs[q] == t.

    Args:
      qs: [Q] int32 destination rows (sorted, for a work list from
        build_worklist); a block that runs past Q stops at Q.
      gs: [Q, C] float32 or bfloat16 update rows in qs's order.
      wt, wb, wreal: [W] int32 work items (build_worklist); wfirst is not
        needed, the output is zero-filled.
      tile, maxu: rows per tile, updates per block.
      n_tiles: tiles in the output.
    Returns:
      [n_tiles * tile, C] float32.
    """
    if on_cpu("worklist_scatter", qs, gs, wt, wb, wreal):
        return worklist_scatter_plain(qs, gs, wt, wb, wreal, tile, maxu,
                                      n_tiles)
    _check_worklist(qs, gs, wt, wb, wreal, tile, maxu, n_tiles)
    Q, C = gs.shape
    out = torch.zeros((n_tiles * tile, C), dtype=torch.float32,
                      device=gs.device)
    if wt.numel() and n_tiles:
        launch(_SOURCE, f"worklist_scatter_{_DTYPES[gs.dtype]}",
               [P, P, P, P, P, P, I64, I64, I64, I32, I32, I32], qs, gs, wt,
               wb, wreal, out, Q, wt.numel(), n_tiles, tile, maxu, C)
        worklist_scatter.launches += 1
    return out


tile_scatter.launches = 0
worklist_scatter.launches = 0


def _check_updates(qs, gs, tile, extra_smem=0):
    """qs [Q] int32, gs [Q, C] f32 or bf16, and a [tile, C] f32 tile (plus
    extra_smem bytes) that fits a block's shared memory."""
    check_int32("qs", qs)
    if gs.dim() != 2 or gs.shape[0] != qs.shape[0]:
        raise ValueError(f"want qs [Q] and gs [Q, C], got {tuple(qs.shape)} "
                         f"and {tuple(gs.shape)}")
    if gs.dtype not in _DTYPES:
        raise TypeError(f"gs must be float32 or bfloat16, got {gs.dtype}")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    smem = tile * gs.shape[1] * 4 + extra_smem
    if smem > _MAX_SMEM:
        raise ValueError(f"a [{tile}, {gs.shape[1]}] f32 tile needs {smem} B "
                         f"of shared memory, more than {_MAX_SMEM}")


def _check_tile(qs, gs, lo, tile):
    """Checks K5's arguments; returns the tile count."""
    _check_updates(qs, gs, tile)
    check_int32("lo", lo)
    if lo.shape[0] < 1:
        raise ValueError("lo needs n_tiles + 1 >= 1 entries")
    return lo.shape[0] - 1


def _check_worklist(qs, gs, wt, wb, wreal, tile, maxu, n_tiles):
    """Checks K6's arguments (its tile also keeps a touched flag a row)."""
    _check_updates(qs, gs, tile, extra_smem=tile)
    for name, t in (("wt", wt), ("wb", wb), ("wreal", wreal)):
        check_int32(name, t)
    if not wt.shape == wb.shape == wreal.shape:
        raise ValueError("wt, wb and wreal differ in length")
    if maxu < 1 or n_tiles < 0:
        raise ValueError(f"want maxu >= 1 and n_tiles >= 0, got {maxu}, "
                         f"{n_tiles}")
