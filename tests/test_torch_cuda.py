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
    assert (tile_scatter.launches, worklist_scatter.launches) == (
        before[0] + 1, before[1] + 1)
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


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 16, 128])
def test_onehot_dot_sums_repeated_rows(cuda, C):
    """Many one-hot columns on one row, and columns outside the tile, with
    small integer rows (their sums are exact in any order)."""
    rng = np.random.RandomState(C)
    local = rng.randint(-4, 40, (3, 64)).astype(np.int32)
    local[1] = 7  # every column of tile 1 on row 7
    g = rng.randint(-8, 9, (3, 64, C))
    lt = torch.from_numpy(local).to(cuda)
    gt = torch.tensor(g, dtype=torch.bfloat16, device=cuda)
    got = cp.onehot_dot(lt, gt, 32)
    torch.cuda.synchronize()
    assert torch.equal(got, cp.onehot_dot_plain(lt, gt, 32))
