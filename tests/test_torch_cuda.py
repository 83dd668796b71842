"""Tests of the port's CUDA kernels against their plain PyTorch versions, on
the card. They skip without an NVIDIA GPU: a CUDA kernel has no CPU mode.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: the scatter-adds (K1, K5, K6) at relative 1e-5 of the max (f32
atomics sum in another order on every run); the gathers and the construct
probes (K7) exactly (they move values, count, or sum terms that add
exactly).
"""

import numpy as np
import pytest
import torch

from laenerf_tpu_torch.ops import construct_probes as cp
from laenerf_tpu_torch.ops.gather import (grid_probe, grid_probe_plain,
                                          take_lanes, take_lanes_plain,
                                          take_rows, take_rows_plain)
from laenerf_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode
from laenerf_tpu_torch.ops.scatter_add import (scatter_add_rows,
                                               scatter_add_rows_plain)
from laenerf_tpu_torch.ops.sorted_scatter import (build_worklist, sort_stage,
                                                  tile_scatter,
                                                  tile_scatter_plain,
                                                  work_sizes,
                                                  worklist_scatter,
                                                  worklist_scatter_plain)
from laenerf_tpu_torch.perf import bisect_mosaic

REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _rel_err(got, ref):
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-12)).item()


def _uniform(seed, Q, T, C):
    rng = np.random.RandomState(seed)
    return rng.randint(0, T, Q).astype(np.int32), rng.randn(Q, C), T


CASES = {
    "uniform": lambda: _uniform(0, 10000, 5000, 8),
    "all_one_row": lambda: (np.full(8192, 17, np.int32), np.ones((8192, 4)),
                            4096),
    "clustered": lambda: ((5000 + np.random.RandomState(1).randint(
        0, 300, 20000)).astype(np.int32),
        np.random.RandomState(2).randn(20000, 8), 40000),
    "block_straddle": lambda: (np.concatenate(
        [np.full(2047, 2047), np.full(2049, 2048),
         np.full(2048, 4095)]).astype(np.int32), np.ones((6144, 2)), 6144),
    "tiny_table": lambda: _uniform(2, 3000, 100, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_add_kernel_matches_plain(cuda, case, precision):
    idx, g, T = CASES[case]()
    i = torch.from_numpy(idx).to(cuda)
    gg = torch.tensor(g, dtype=torch.float32, device=cuda)
    before = scatter_add_rows.launches
    got = scatter_add_rows(i, gg, T, precision=precision)
    ref = scatter_add_rows_plain(i, gg, T, precision=precision)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    assert _rel_err(got, ref) < REL_TOL


@pytest.mark.cuda
def test_scatter_add_kernel_edges(cuda):
    empty = scatter_add_rows(torch.zeros(0, dtype=torch.int32, device=cuda),
                             torch.zeros((0, 4), device=cuda), 100)
    assert empty.shape == (100, 4) and not empty.any()
    idx = torch.tensor([0, 5, -1, 7, 3], dtype=torch.int32, device=cuda)
    g = torch.ones((5, 2), device=cuda)
    got = scatter_add_rows(idx, g, 6, precision="f32")
    assert got.sum().item() == 6.0  # rows -1 and 7 are dropped
    with pytest.raises(TypeError):
        scatter_add_rows(idx.long(), g, 6)
    with pytest.raises(ValueError):
        scatter_add_rows(idx, g.t(), 6)  # shape [2, 5]


@pytest.mark.cuda
def test_hashgrid_backward_on_card_matches_cpu(cuda):
    """The encoder backward through K1 against the same backward on the
    CPU, where the plain scatter-add runs."""
    spec = HashGridSpec(num_levels=4, level_dim=4, log2_hashmap_size=14,
                        gather_dtype="bf16")
    gen = torch.Generator().manual_seed(0)
    table = torch.rand((spec.table_rows, spec.level_dim), generator=gen) - 0.5
    x = torch.rand((2048, 3), generator=gen) * 2.2 - 1.1
    cot = torch.randn((2048, spec.output_dim), generator=gen)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        t = table.to(dev).requires_grad_(True)
        (hashgrid_encode(t, x.to(dev), spec) * cot.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    assert _rel_err(grads[0], grads[1]) < REL_TOL


GATHER_DTYPES = {"f32": torch.float32, "i32": torch.int32, "i8": torch.int8}


def _gather_table(rng, shape, dtype, dev):
    if dtype == torch.float32:
        return torch.tensor(rng.randn(*shape), dtype=dtype, device=dev)
    return torch.tensor(rng.randint(-128, 128, shape), dtype=dtype,
                        device=dev)


def _idx(rng, high, shape, dev):
    return torch.tensor(rng.randint(0, high, shape), dtype=torch.int32,
                        device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(GATHER_DTYPES))
def test_take_rows_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(0)
    tbl = _gather_table(rng, (1000, 128), GATHER_DTYPES[dtype], cuda)
    rows = _idx(rng, 1000, (3000, 128), cuda)
    before = take_rows.launches
    got = take_rows(tbl, rows)
    torch.cuda.synchronize()
    assert take_rows.launches == before + 1
    assert torch.equal(got, take_rows_plain(tbl, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", sorted(GATHER_DTYPES))
def test_take_lanes_kernel_matches_plain(cuda, dtype, broadcast):
    rng = np.random.RandomState(1)
    tbl = _gather_table(rng, (64, 5000), GATHER_DTYPES[dtype], cuda)
    idx = _idx(rng, 5000, (1 if broadcast else 64, 777), cuda)
    before = take_lanes.launches
    got = take_lanes(tbl, idx)
    torch.cuda.synchronize()
    assert take_lanes.launches == before + 1
    assert got.shape == (64, 777)
    assert torch.equal(got, take_lanes_plain(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 128])
@pytest.mark.parametrize("pair", ["f32_f32", "i32_i32", "i8_i8", "i8_i32"])
def test_grid_probe_kernel_matches_plain(cuda, pair, lanes):
    din, dout = (GATHER_DTYPES[p] for p in pair.split("_"))
    rng = np.random.RandomState(2)
    grid = _gather_table(rng, (4096, 96), din, cuda)
    row, col = _idx(rng, 4096, (5000,), cuda), _idx(rng, 96, (5000,), cuda)
    before = grid_probe.launches
    got = grid_probe(grid, row, col, lanes=lanes, out_dtype=dout)
    torch.cuda.synchronize()
    assert grid_probe.launches == before + 1
    assert got.shape == (5000, lanes) and got.dtype == dout
    assert torch.equal(got, grid_probe_plain(grid, row, col, lanes, dout))


@pytest.mark.cuda
def test_gather_kernels_reject_what_they_do_not_take(cuda):
    tbl = torch.zeros((16, 8), device=cuda)
    rows = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # int64 index
        take_rows(tbl, rows.long())
    with pytest.raises(TypeError):  # float64 table
        take_rows(tbl.double(), rows)
    with pytest.raises(ValueError):  # non-contiguous table
        take_rows(torch.zeros((8, 16), device=cuda).t(), rows)
    with pytest.raises(ValueError):  # CPU index, CUDA table
        take_rows(tbl, rows.cpu())
    idx = torch.zeros((16, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # non-contiguous index
        take_lanes(tbl, torch.zeros((4, 16), dtype=torch.int32,
                                    device=cuda).t())
    with pytest.raises(ValueError):  # CPU index, CUDA table
        take_lanes(tbl, idx.cpu())
    q = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # CPU col, CUDA grid
        grid_probe(tbl, q, q.cpu())
    with pytest.raises(TypeError):  # an f32 grid cannot be written as int32
        grid_probe(tbl, q, q, out_dtype=torch.int32)
    empty = take_rows(tbl, torch.zeros((0, 8), dtype=torch.int32,
                                       device=cuda))
    assert empty.shape == (0, 8)


def _clustered_with_strays():
    rng = np.random.RandomState(3)
    idx = np.concatenate([5000 + rng.randint(0, 300, 20000),
                          rng.randint(0, 40000, 5000),
                          [-1, -7, 40960, 50000, 1 << 30]]).astype(np.int32)
    return idx, rng.randn(idx.shape[0], 8), 40000


SORTED_CASES = {
    "uniform": lambda: _uniform(4, 100000, 50000, 8),
    "clustered_out_of_range": _clustered_with_strays,
    "all_one_row": lambda: (np.full(8192, 17, np.int32),
                            np.random.RandomState(5).randn(8192, 8), 4096),
    "q0": lambda: (np.zeros(0, np.int32), np.zeros((0, 8)), 4096),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1024, 2048])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SORTED_CASES))
def test_sorted_scatter_kernels_match_plain(cuda, case, dtype, tile):
    """K5 and K6 on sorted updates and their work list, against their plain
    versions; rows below 0 or past the tiles are dropped."""
    idx, g, T = SORTED_CASES[case]()
    rows = torch.tensor(g, dtype=torch.float32, device=cuda).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    sizes = work_sizes(idx.shape[0], T, tile, tile)
    qs, gs, lo = sort_stage(torch.from_numpy(idx).to(cuda), rows, tile,
                            sizes.n_tiles)
    before = tile_scatter.launches, worklist_scatter.launches
    got5 = tile_scatter(qs, gs, lo, tile)
    wt, wb, _, wreal = build_worklist(lo, tile, sizes.w_cap, sizes.q_blks)
    got6 = worklist_scatter(qs, gs, wt, wb, wreal, tile, tile, sizes.n_tiles)
    ref5 = tile_scatter_plain(qs, gs, lo, tile)
    ref6 = worklist_scatter_plain(qs, gs, wt, wb, wreal, tile, tile,
                                  sizes.n_tiles)
    torch.cuda.synchronize()
    # K5 has nothing to launch without updates (its output is the zero-fill)
    assert (tile_scatter.launches, worklist_scatter.launches) == (
        before[0] + (idx.shape[0] > 0), before[1] + 1)
    assert got5.shape == got6.shape == (sizes.t_pad, 8)
    assert torch.equal(ref5, ref6) or _rel_err(ref5, ref6) < REL_TOL
    assert _rel_err(got5, ref5) < REL_TOL
    assert _rel_err(got6, ref6) < REL_TOL
    if case == "q0":
        assert not got5.any() and not got6.any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [None, 1, 2])
def test_construct_probes_match_plain(cuda, seed):
    """K7: all eight constructs on the script's inputs and random ones."""
    for label, _, fn, args in bisect_mosaic.cases(cuda, seed):
        before = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, label
        assert torch.equal(got, cp.PLAIN[fn](*args)), label


def _onehot_case(case):
    """(local int32, g with small integer values, tile): an int case is
    C = case at tile 32, its sums of many columns on one row exact in any
    order; a named case is an edge of the kernel's window bucketing (its
    32-row windows, 1,024-column scan chunks and 64-wide channel chunks)."""
    if isinstance(case, int):
        rng = np.random.RandomState(case)
        local = rng.randint(-4, 40, (3, 64)).astype(np.int32)
        local[1] = 7  # every column of tile 1 on row 7
        return local, rng.randint(-8, 9, (3, 64, case)), 32
    rng = np.random.RandomState(len(case))
    n, maxu, tile, C = {"one_row_c128": (3, 1024, 1024, 128),
                        "empty_windows": (3, 256, 128, 16),
                        "maxu_2048_tile_64": (2, 2048, 64, 8),
                        "c16": (4, 512, 256, 16),
                        "tile_32": (5, 96, 32, 128),
                        "maxu_1552": (3, 1552, 128, 80)}[case]
    local = rng.randint(-8, tile + 8, (n, maxu))
    if case == "one_row_c128":
        local[:] = [[0], [517], [1023]]  # every column of a tile on one row
    if case == "empty_windows":
        # tile 0 leaves windows 0 and 2 empty; tile 1 lies wholly outside
        local[0] = rng.choice(np.r_[32:64, 96:128], maxu)
        local[1] = rng.choice([-1, tile, 5000, -2 ** 31, 2 ** 31 - 1], maxu)
    g = rng.randint(-8, 9, (n, maxu, C))
    return local.astype(np.int32), g, tile


@pytest.mark.cuda
@pytest.mark.parametrize("case", [8, 16, 128, "one_row_c128",
                                  "empty_windows", "maxu_2048_tile_64",
                                  "c16", "tile_32", "maxu_1552"])
def test_onehot_dot_sums_repeated_rows(cuda, case):
    """Many one-hot columns on one row, and columns outside the tile, with
    small integer rows (their sums are exact in any order); whole tiles on
    one row, empty windows, tiles wholly outside, more columns than one scan
    chunk (and not a multiple of it), C = 16 and C = 80 (a narrower last
    channel chunk), tile = 32. Exact, one launch a call."""
    local, g, tile = _onehot_case(case)
    lt = torch.from_numpy(local).to(cuda)
    gt = torch.tensor(g, dtype=torch.bfloat16, device=cuda)
    before = cp.onehot_dot.launches
    got = cp.onehot_dot(lt, gt, tile)
    torch.cuda.synchronize()
    assert cp.onehot_dot.launches == before + 1
    assert torch.equal(got, cp.onehot_dot_plain(lt, gt, tile))


K5_CHUNK = 2048  # updates a K5 block takes (csrc/sorted_scatter.cu kChunk)


def _k5_rows(case, rng):
    """(rows [Q] int32, unsorted, T, tile, C) of a K5 edge case."""
    if case == "heavy_tile":
        # 100,000 updates on 3 rows of tile 7: its slab spans ~50 blocks
        heavy = 7 * 1024 + rng.choice([0, 500, 1023], 100000)
        return np.concatenate([heavy, rng.randint(0, 200000, 60000)]), \
            200000, 1024, 8
    if case.startswith("chunk"):
        # a run boundary at exactly K5_CHUNK + o, and a run of 700 updates
        # across the second block boundary
        o = {"chunk-1": -1, "chunk": 0, "chunk+1": 1}[case]
        head = np.repeat(np.arange(K5_CHUNK), 3)[:K5_CHUNK + o]
        mid = np.full(2 * K5_CHUNK - 350 - head.shape[0], 9000)
        return np.concatenate([head, mid, np.full(700, 9001),
                               9002 + rng.randint(0, 3000, 2000)]), \
            12288, 1024, 8
    C = int(case[1:])  # "c<C>": many short runs and some long ones
    rows = np.concatenate([rng.randint(0, 30000, 20000),
                           np.repeat(rng.randint(0, 30000, 8), 300)])
    return rows, 30000, 512, C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["heavy_tile", "chunk-1", "chunk",
                                  "chunk+1", "c1", "c3", "c8", "c16", "c56"])
def test_tile_scatter_matches_plain(cuda, case, dtype):
    """K5 on a heavy tile whose slab spans many blocks, run boundaries at
    exactly one block's end and a run across the next, and C = 1, 3 (no
    16-byte loads), 8, 16 and 56 (several channel groups); one launch a
    call."""
    rng = np.random.RandomState(len(case))
    rows, T, tile, C = _k5_rows(case, rng)
    g = torch.tensor(rng.randn(rows.shape[0], C), dtype=torch.float32,
                     device=cuda).to(torch.float32 if dtype == "f32"
                                     else torch.bfloat16)
    n_tiles = -(-T // tile)
    qs, gs, lo = sort_stage(torch.from_numpy(rows.astype(np.int32)).to(cuda),
                            g, tile, n_tiles)
    before = tile_scatter.launches
    got = tile_scatter(qs, gs, lo, tile)
    torch.cuda.synchronize()
    assert tile_scatter.launches == before + 1
    assert got.shape == (n_tiles * tile, C)
    assert _rel_err(got, tile_scatter_plain(qs, gs, lo, tile)) < REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_tile_scatter_on_misaligned_views(cuda, offset, dtype):
    """Contiguous views whose rows start `offset` elements into their
    storage, so 16-byte loads are ruled out (narrower ones where the offset
    allows); also qs and lo views."""
    rng = np.random.RandomState(offset)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rows = np.sort(np.concatenate([rng.randint(0, 20000, 30000),
                                   np.full(900, 4321)])).astype(np.int32)
    Q, C, tile = rows.shape[0], 8, 1024
    flat = torch.tensor(rng.randn(Q * C + offset), dtype=torch.float32,
                        device=cuda).to(tdt)
    gs = flat[offset:].view(Q, C)
    qs = torch.from_numpy(np.concatenate([[0], rows]).astype(np.int32)).to(
        cuda)[1:]
    lo = sort_stage(qs, gs, tile, 20)[2]
    lo = torch.cat([lo[:1], lo])[1:]
    assert gs.is_contiguous() and gs.storage_offset() == offset
    before = tile_scatter.launches
    got = tile_scatter(qs, gs, lo, tile)
    torch.cuda.synchronize()
    assert tile_scatter.launches == before + 1
    assert _rel_err(got, tile_scatter_plain(qs, gs, lo, tile)) < REL_TOL


@pytest.mark.cuda
def test_tile_scatter_drops_rows_outside_their_tile(cuda):
    """The CPU case of tests/test_torch_sorted_scatter.py on the card: a
    hand-made lo puts row 40 in tile 0's slab, where it is dropped, as are
    rows below 0 and past the table; Q = 0 launches nothing."""
    qs = torch.tensor([-3, 0, 5, 40, 63, 64, 90], dtype=torch.int32,
                      device=cuda)
    g = torch.arange(14, dtype=torch.float32, device=cuda).reshape(7, 2)
    lo = torch.tensor([1, 4, 5], dtype=torch.int32, device=cuda)
    ref = torch.zeros((64, 2), device=cuda)
    ref[0], ref[5], ref[63] = g[1], g[2], g[4]
    before = tile_scatter.launches
    got = tile_scatter(qs, g, lo, 32)
    torch.cuda.synchronize()
    assert tile_scatter.launches == before + 1
    assert torch.equal(got, ref)
    assert torch.equal(tile_scatter_plain(qs, g, lo, 32), ref)
    empty = tile_scatter(qs[:0], g[:0], torch.zeros(3, dtype=torch.int32,
                                                    device=cuda), 32)
    torch.cuda.synchronize()
    assert tile_scatter.launches == before + 1
    assert empty.shape == (64, 2) and not empty.any()
