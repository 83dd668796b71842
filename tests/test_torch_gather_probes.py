"""Parity of the port's gather probes (laenerf_tpu_torch/ops/gather.py) with
the eight TPU gather kernels of perf/microbench_pallas.py and
perf/microbench_gather.py, run through pl.pallas_call(interpret=True) on the
CPU at small shapes.

Those scripts run their benchmarks when imported, so each kernel body below
is a copy, with the script's file:line above it; the specs
(memory_space=pltpu.VMEM, G2's query-block grid) are the scripts' own. The
same numpy inputs go through the port's wrapper, which on CPU tensors runs
its plain version. Gathers move values without arithmetic, so every check is
exact equality. The kernels themselves are held against the plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).

The last tests call every probe of the port's two microbenchmark scripts at
tiny sizes on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from laenerf_tpu_torch.ops.gather import (grid_probe, grid_probe_plain,
                                          take_lanes, take_lanes_plain,
                                          take_rows, take_rows_plain)
from laenerf_tpu_torch.perf import microbench_gather as mg
from laenerf_tpu_torch.perf import microbench_pallas as mp
from laenerf_tpu_torch.perf import phase_turns

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _pallas(kernel, out_shape, out_dtype, *args, n_in=None, **kw):
    specs = {} if "grid" in kw else {
        "in_specs": [VMEM] * (n_in or len(args)), "out_specs": VMEM}
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, out_dtype),
        interpret=True, **specs, **kw)(*[jnp.asarray(a) for a in args]))


def _table(rng, shape, dtype):
    if dtype == np.float32:
        return rng.randn(*shape).astype(np.float32)
    return rng.randint(-128 if dtype == np.int8 else -1000,
                       128 if dtype == np.int8 else 1000,
                       shape).astype(dtype)


# perf/microbench_pallas.py:77 (P1 :83, P2b :122)
def _k_ax0(tbl_ref, rows_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tbl_ref[:], rows_ref[:], axis=0,
                                     mode="promise_in_bounds")


# perf/microbench_pallas.py:99 (P2 :105)
def _k_ax0_i8(tbl_ref, rows_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tbl_ref[:], rows_ref[:], axis=0,
                                     mode="promise_in_bounds")


# perf/microbench_gather.py:174 (G, pallas_gather :178)
def _kernel(tbl_ref, rows_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tbl_ref[:], rows_ref[:], axis=0)


# perf/microbench_gather.py:200 (G2, pallas_gather_blocked :204)
def _kernel2(tbl_ref, rows_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tbl_ref[:], rows_ref[:], axis=0)


# perf/microbench_pallas.py:138 (P3 :144)
def _k_ax1(tbl_ref, lanes_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(tbl_ref[:], lanes_ref[:], axis=1,
                                     mode="promise_in_bounds")


def _make_k_wide(rows, nray):
    # perf/microbench_pallas.py:230 (P3x :235); rows and NRAY were globals
    def _k_wide(tbl_ref, idx_ref, out_ref):
        idx_b = jnp.broadcast_to(idx_ref[:], (rows, nray))
        out_ref[:] = jnp.take_along_axis(tbl_ref[:], idx_b, axis=1,
                                         mode="promise_in_bounds")
    return _k_wide


def _make_k_march_probe(NR, H):
    # perf/microbench_pallas.py:167 (P4 :177, P4b :191); NR, H were globals
    def _k_march_probe(grid_ref, rows_ref, z_ref, out_ref):
        rows_b = jnp.broadcast_to(rows_ref[:], (NR, H))
        cols = jnp.take_along_axis(grid_ref[:], rows_b, axis=0,
                                   mode="promise_in_bounds")
        z_b = jnp.broadcast_to(z_ref[:], (NR, H))
        out_ref[:] = jnp.take_along_axis(cols, z_b, axis=1,
                                         mode="promise_in_bounds")
    return _k_march_probe


def _make_k_two_step(R8, nray):
    # perf/microbench_pallas.py:261 (P6 :272); R8 and 16384 were constants
    def _k_two_step(tbl_ref, lane_ref, row_ref, out_ref):
        idx_b = jnp.broadcast_to(lane_ref[:], (R8, nray))
        got = jnp.take_along_axis(tbl_ref[:], idx_b, axis=1,
                                  mode="promise_in_bounds")  # [8, nray]
        sub = jax.lax.broadcasted_iota(jnp.int32, (R8, nray), 0)
        sel = jnp.where(sub == jnp.broadcast_to(row_ref[:], (R8, nray)),
                        got.astype(jnp.int32), 0)
        out_ref[:] = jnp.sum(sel, axis=0, keepdims=True)  # [1, nray]
    return _k_two_step


# (kernel, dtype, table rows R, queries Q, width W); W = 8 and 17 are the
# ragged widths (K2's scalar path for int8 at 8 and for every dtype at 17)
TAKE_ROWS_CASES = {
    "P1_k_ax0_f32": (_k_ax0, np.float32, 64, 64, 128),
    "P2b_k_ax0_i32": (_k_ax0, np.int32, 64, 64, 128),
    "P2_k_ax0_i8": (_k_ax0_i8, np.int8, 64, 64, 128),
    "G_kernel_f32": (_kernel, np.float32, 64, 128, 128),
    "P1_k_ax0_f32_W8": (_k_ax0, np.float32, 64, 64, 8),
    "P1_k_ax0_f32_W17": (_k_ax0, np.float32, 64, 64, 17),
    "P2_k_ax0_i8_W8": (_k_ax0_i8, np.int8, 64, 64, 8),
    "P2_k_ax0_i8_W17": (_k_ax0_i8, np.int8, 64, 64, 17),
}


@pytest.mark.parametrize("case", sorted(TAKE_ROWS_CASES))
def test_take_rows_matches_pallas(case):
    kernel, dtype, R, Q, W = TAKE_ROWS_CASES[case]
    rng = np.random.RandomState(len(case))
    tbl = _table(rng, (R, W), dtype)
    rows = rng.randint(0, R, (Q, W)).astype(np.int32)
    ref = _pallas(kernel, (Q, W), dtype, tbl, rows)
    got = take_rows(torch.from_numpy(tbl), torch.from_numpy(rows))
    assert got.dtype == torch.from_numpy(tbl).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_take_rows_matches_pallas_blocked():
    """G2: the query-block grid of pallas_gather_blocked, table resident."""
    rng = np.random.RandomState(5)
    R, Q, QB = 32, 128, 32
    tbl = rng.randn(R, 128).astype(np.float32)
    rows = rng.randint(0, R, (Q, 128)).astype(np.int32)
    ref = _pallas(
        _kernel2, (Q, 128), np.float32, tbl, rows, grid=(Q // QB,),
        in_specs=[pl.BlockSpec((R, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((QB, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((QB, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM))
    got = take_rows(torch.from_numpy(tbl), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_take_lanes_matches_pallas():
    """P3: per-row lane select."""
    rng = np.random.RandomState(6)
    tbl = rng.randn(64, 128).astype(np.float32)
    lanes = rng.randint(0, 128, (64, 128)).astype(np.int32)
    ref = _pallas(_k_ax1, (64, 128), np.float32, tbl, lanes)
    got = take_lanes(torch.from_numpy(tbl), torch.from_numpy(lanes))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rows,lanes", [(8, 2048), (16, 1024), (64, 256),
                                        (128, 128)])
def test_take_lanes_broadcast_matches_pallas(rows, lanes):
    """P3x: one index row broadcast over an int8 table's rows (the shapes
    of the script's four tables, cut by 128 in lanes)."""
    nray = 256
    rng = np.random.RandomState(rows)
    tbl = rng.randint(0, 8, (rows, lanes)).astype(np.int8)
    idx = rng.randint(0, lanes, (1, nray)).astype(np.int32)
    ref = _pallas(_make_k_wide(rows, nray), (rows, nray), np.int8, tbl, idx)
    got = take_lanes(torch.from_numpy(tbl), torch.from_numpy(idx))
    assert got.shape == (rows, nray) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kernel,rows,nray,view", [
    ("k_ax1", 1, 17, False), ("k_ax1", 1, 777, False),
    ("k_ax1", 3, 17, True), ("k_wide", 1, 17, False),
    ("k_wide", 1, 777, False), ("k_wide", 3, 777, False),
    ("k_wide", 1, 777, True), ("k_wide", 4, 16, True)])
def test_take_lanes_ragged_matches_pallas(kernel, rows, nray, view):
    """K3 at ragged widths: N = 17 and 777 (output rows off 16-byte
    boundaries, the kernel's scalar path) on one-row and three-row tables,
    through P3's _k_ax1 (f32, per-row lanes) and P3x's _k_wide (int8, one
    index row broadcast); with view, idx and tbl are contiguous views 4
    bytes into their storage, as the kernel may be handed them."""
    rng = np.random.RandomState(rows * nray)
    lanes = 300
    if kernel == "k_ax1":
        tbl = rng.randn(rows, lanes).astype(np.float32)
        idx = rng.randint(0, lanes, (rows, nray)).astype(np.int32)
        ref = _pallas(_k_ax1, (rows, nray), np.float32, tbl, idx)
    else:
        tbl = rng.randint(-128, 128, (rows, lanes)).astype(np.int8)
        idx = rng.randint(0, lanes, (1, nray)).astype(np.int32)
        ref = _pallas(_make_k_wide(rows, nray), (rows, nray), np.int8, tbl,
                      idx)
    t, i = torch.from_numpy(tbl), torch.from_numpy(idx)
    if view:
        k = 4 // t.element_size()
        t = torch.cat([t.new_zeros(k), t.reshape(-1)])[k:].view(t.shape)
        i = torch.cat([i.new_zeros(1), i.reshape(-1)])[1:].view(i.shape)
        assert t.is_contiguous() and t.storage_offset() == k
        assert i.is_contiguous() and i.storage_offset() == 1
    got = take_lanes(t, i)
    assert got.shape == (rows, nray) and got.dtype == t.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("H", [16, 24])
@pytest.mark.parametrize("dtype", [np.int32, np.int8])
def test_grid_probe_matches_pallas_march_probe(dtype, H):
    """P4 (int32) and P4b (int8): one cell per ray into all H lanes (H = 24
    is not a multiple of int8's 16-lane chunk: K4's scalar path)."""
    NR = H * H
    rng = np.random.RandomState(7)
    grid = _table(rng, (NR, H), dtype)
    rows = rng.randint(0, NR, (NR, 1)).astype(np.int32)
    z = rng.randint(0, H, (NR, 1)).astype(np.int32)
    ref = _pallas(_make_k_march_probe(NR, H), (NR, H), dtype, grid, rows, z)
    got = grid_probe(torch.from_numpy(grid), torch.from_numpy(rows[:, 0]),
                     torch.from_numpy(z[:, 0]), lanes=H)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_grid_probe_matches_pallas_two_step():
    """P6: wide gather plus one-hot row select, one int32 lane per ray."""
    R8, L8, nray = 8, 2048, 256
    rng = np.random.RandomState(8)
    tbl = rng.randint(-8, 8, (R8, L8)).astype(np.int8)
    lane = rng.randint(0, L8, (1, nray)).astype(np.int32)
    row = rng.randint(0, R8, (1, nray)).astype(np.int32)
    ref = _pallas(_make_k_two_step(R8, nray), (1, nray), np.int32, tbl, lane,
                  row)
    got = grid_probe(torch.from_numpy(tbl), torch.from_numpy(row[0]),
                     torch.from_numpy(lane[0]), out_dtype=torch.int32)
    assert got.shape == (nray, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[:, 0], ref[0])


def test_plain_versions_raise_out_of_range():
    tbl = torch.zeros((4, 8))
    with pytest.raises((IndexError, RuntimeError)):
        take_rows_plain(tbl, torch.full((2, 8), 4, dtype=torch.int32))
    with pytest.raises((IndexError, RuntimeError)):
        take_lanes_plain(tbl, torch.full((1, 3), -1, dtype=torch.int32))
    with pytest.raises((IndexError, RuntimeError)):
        grid_probe_plain(tbl, torch.tensor([-1], dtype=torch.int32),
                         torch.tensor([0], dtype=torch.int32))
    with pytest.raises((IndexError, RuntimeError)):
        grid_probe_plain(tbl, torch.tensor([0], dtype=torch.int32),
                         torch.tensor([8], dtype=torch.int32))


@pytest.mark.parametrize("call", [
    lambda: take_rows(torch.zeros((4, 8), dtype=torch.float64),
                      torch.zeros((2, 8), dtype=torch.int32)),
    lambda: take_rows(torch.zeros((4, 8)), torch.zeros((2, 8))),
    lambda: take_rows(torch.zeros((4, 8)),
                      torch.zeros((2, 4), dtype=torch.int32)),
    lambda: take_lanes(torch.zeros((4, 8)),
                       torch.zeros((2, 3), dtype=torch.int32)),
    lambda: grid_probe(torch.zeros((4, 8)), torch.zeros(3, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32)),
    lambda: grid_probe(torch.zeros((4, 8)), torch.zeros(3, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32),
                       out_dtype=torch.int32),
    lambda: grid_probe(torch.zeros((4, 8), dtype=torch.int8),
                       torch.zeros(3, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32), lanes=0),
    lambda: take_rows(torch.zeros((4, 8), device="meta"),
                      torch.zeros((2, 8), dtype=torch.int32, device="meta")),
], ids=["f64_table", "float_index", "width", "lane_rows", "row_col",
        "f32_as_int32", "lanes_0", "meta_device"])
def test_wrappers_reject_bad_args(call):
    with pytest.raises((TypeError, ValueError)):
        call()


PALLAS_PROBES = {
    "P1": lambda n: mp.probe_take_rows(16, torch.float32, n, "cpu"),
    "P2": lambda n: mp.probe_take_rows(16, torch.int8, n, "cpu"),
    "P2b": lambda n: mp.probe_take_rows(16, torch.int32, n, "cpu"),
    "P3": lambda n: mp.probe_take_lanes(16, n, "cpu"),
    "P4": lambda n: mp.probe_march(8, torch.int32, n, "cpu"),
    "P4b": lambda n: mp.probe_march(8, torch.int8, n, "cpu"),
    "P5": lambda n: mp.probe_flat_byte(8, n, "cpu"),
    "P3x": lambda n: mp.probe_wide_lanes(4, 64, 32, n, "cpu"),
    "P6": lambda n: mp.probe_two_step(8, 64, 32, n, "cpu"),
}
GATHER_PROBES = {
    "A": lambda n: mg.probe_row_gather(64, 8, 256, False, n, "cpu"),
    "B": lambda n: mg.probe_row_gather(64, 8, 256, True, n, "cpu"),
    "C": lambda n: mg.probe_argsort(64, 256, n, "cpu"),
    "D": lambda n: mg.probe_scatter("flat", 64, 8, 256, n, "cpu"),
    "E": lambda n: mg.probe_scatter("unique", 64, 8, 256, n, "cpu"),
    "F": lambda n: mg.probe_scatter("sorted", 64, 8, 256, n, "cpu"),
    "G": lambda n: mg.probe_take_rows(4096, 256, n, "cpu"),
    "H0": lambda n: mg.probe_small_gather(64, 8, 256, n, "cpu"),
    "H": lambda n: mg.probe_onehot(64, 8, 256, 64, n, "cpu"),
}


@pytest.mark.parametrize("probe", list(PALLAS_PROBES))
def test_microbench_pallas_probe_on_cpu(probe):
    t = PALLAS_PROBES[probe](3)
    assert math.isfinite(t) and t > 0


@pytest.mark.parametrize("probe", list(GATHER_PROBES))
def test_microbench_gather_probe_on_cpu(probe):
    t = GATHER_PROBES[probe](3)
    assert math.isfinite(t) and t > 0


def test_microbench_gather_rejects_unknown_scatter():
    with pytest.raises(ValueError):
        mg.probe_scatter("dense", 64, 8, 256, 1, "cpu")


@pytest.mark.parametrize("script,argv,rows", [
    (mp, ["--device", "cpu", "--n", "2"], 12),
    (mg, ["--device", "cpu", "--n", "2", "--big", "4096"], 11),
], ids=["microbench_pallas", "microbench_gather"])
def test_probe_script_main_on_cpu(script, argv, rows, capsys):
    """Each entry point prints the host line and one row per probe of the
    JAX script (P1-P6 with four P3x tables; A-H)."""
    res = script.main(argv)
    out = capsys.readouterr().out
    assert out.startswith("device=cpu")
    assert len(res) == rows
    assert all(math.isfinite(t) and t > 0 for t in res.values())
    assert all(label in out for label in res)


def test_phase_turns_sets_turns_side_by_side():
    """phase_turns' table: every site of any turn, one value per turn
    in turn order, None where a turn lacks the site or the key."""
    parent = [{"site": "P1", "device_ms": 0.006, "library_device_ms": 0.0063},
              {"site": "P6", "device_ms": 0.0017}]
    change = [{"site": "P1", "device_ms": 0.004, "library_device_ms": 0.0062},
              {"site": "P4", "device_ms": 0.003}]
    table = phase_turns.side_by_side([parent, change, change, parent])
    assert list(table) == ["P1", "P6", "P4"]
    assert table["P1"]["device_ms"] == [0.006, 0.004, 0.004, 0.006]
    assert table["P6"]["device_ms"] == [0.0017, None, None, 0.0017]
    assert table["P4"]["library_device_ms"] == [None] * 4
