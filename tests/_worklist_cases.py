"""Hand-made work lists for K6 (worklist_scatter), shared by the CPU tests of
its plain version (tests/test_torch_sorted_scatter.py) and the card tests of
its kernel (tests/test_torch_cuda.py). numpy and the port only, no JAX.

Each case is (qs [Q] int32, g [Q, C] float64, wt, wb, wreal [W] int32, tile,
maxu, n_tiles) as numpy arrays, at 64-row tiles and 300-update blocks (not a
multiple of a warp's 32 updates, so windows end inside a block).
"""

import numpy as np
import torch

from laenerf_tpu_torch.ops.sorted_scatter import (build_worklist, sort_stage,
                                                  work_sizes)

TILE, MAXU, C = 64, 300, 8


def _listed(rows, T, rng):
    """Sorted rows, their update rows and build_worklist's list."""
    qs = np.sort(np.asarray(rows)).astype(np.int32)
    g = rng.randn(qs.shape[0], C)
    sizes = work_sizes(qs.shape[0], T, TILE, MAXU)
    lo = sort_stage(torch.from_numpy(qs), torch.zeros((qs.shape[0], 1)),
                    TILE, sizes.n_tiles)[2]
    wt, wb, _, wreal = (a.numpy() for a in build_worklist(
        lo, MAXU, sizes.w_cap, sizes.q_blks))
    return qs, g, wt, wb, wreal, TILE, MAXU, sizes.n_tiles


def _with_items(case, items):
    """case with the (wt, wb, wreal) items appended."""
    qs, g, wt, wb, wreal, tile, maxu, n_tiles = case
    extra = np.asarray(items, np.int64).reshape(-1, 3).T
    wt, wb, wreal = (np.concatenate([a, e]).astype(np.int32)
                     for a, e in zip((wt, wb, wreal), extra))
    return qs, g, wt, wb, wreal, tile, maxu, n_tiles


def duplicated_item(rng):
    # the heaviest tile's first item listed twice: its updates add twice
    case = _listed(rng.randint(0, 2000, 3000), 2000, rng)
    wt, wb, wreal = case[2:5]
    heavy = np.bincount(case[0] // TILE).argmax()
    w = np.flatnonzero((wt == heavy) & (wreal == 1))[0]
    return _with_items(case, [(wt[w], wb[w], 1)])


def unsorted_qs(rng):
    # unsorted rows, some outside the table, under every (tile, block) pair:
    # each kept update counts in exactly one item
    T, Q = 500, 2000
    qs = rng.randint(-20, T + 100, Q).astype(np.int32)
    n_tiles, n_blocks = -(-T // TILE), -(-Q // MAXU)
    wt = np.repeat(np.arange(n_tiles), n_blocks).astype(np.int32)
    wb = np.tile(np.arange(n_blocks), n_tiles).astype(np.int32)
    return (qs, rng.randn(Q, C), wt, wb, np.ones_like(wt), TILE, MAXU,
            n_tiles)


def past_q(rng):
    # Q = 1000: block 3 runs past Q (the list's last items); block 5 starts
    # past it (adds nothing); block -1 is cut to [0, 300) as the plain
    # version cuts it (tile 1's updates there add twice)
    case = _listed(rng.randint(0, 640, 1000), 640, rng)
    return _with_items(case, [(0, 5, 1), (1, -1, 1)])


def dead_items(rng):
    # items that must add nothing: wreal == 0 over real updates, and tiles
    # below 0 or at and past n_tiles
    case = _listed(rng.randint(0, 1280, 2400), 1280, rng)
    wt, wb, wreal, n_tiles = case[2], case[3], case[4], case[7]
    real = np.flatnonzero(wreal == 1)[[0, 7]]
    return _with_items(case, [(wt[w], wb[w], 0) for w in real]
                       + [(-1, 1, 1), (n_tiles, 2, 1), (2 ** 31 - 1, 4, 1)])


def slab_over_three_blocks(rng):
    # tile 1's slab [250, 750) straddles blocks 0, 1 and 2
    rows = np.concatenate([rng.randint(0, 64, 250), rng.randint(64, 128, 500),
                           rng.randint(128, 1000, 900)])
    return _listed(rows, 1000, rng)


def one_row_block(rng):
    # row 70 holds updates [150, 1050): all of blocks 1 and 2
    rows = np.concatenate([rng.randint(0, 70, 150), np.full(900, 70),
                           rng.randint(71, 900, 600)])
    return _listed(rows, 900, rng)


WORKLIST_CASES = {f.__name__: f for f in (
    duplicated_item, unsorted_qs, past_q, dead_items, slab_over_three_blocks,
    one_row_block)}


def worklist_case(name, seed=0):
    return WORKLIST_CASES[name](np.random.RandomState(seed))


def worklist_reference(qs, g, wt, wb, wreal, tile, maxu, n_tiles):
    """The work list's sum item by item, in float64: each real item with a
    tile in range adds the rows of its block (cut to [0, Q)) that lie in
    its tile."""
    Q = qs.shape[0]
    out = np.zeros((n_tiles * tile, g.shape[1]))
    for t, b, real in zip(wt.tolist(), wb.tolist(), wreal.tolist()):
        if real == 0 or not 0 <= t < n_tiles:
            continue
        begin = min(max(b * maxu, 0), Q)
        q = np.arange(begin, min(begin + maxu, Q))
        q = q[(qs[q] >= t * tile) & (qs[q] < (t + 1) * tile)]
        np.add.at(out, qs[q], g[q])
    return out
