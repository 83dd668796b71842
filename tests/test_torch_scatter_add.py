"""Parity of the port's scatter-add (laenerf_tpu_torch/ops/scatter_add.py)
with the JAX package's Pallas work-list kernel (interpret mode on the CPU)
and its plain XLA scatter, on the cases of tests/test_scatter_add.py plus
Q == 0 and out-of-range rows, and on the port's 2-D form idx [S, P], g [S,
P, C] (the JAX side takes its flattening): runs of one row down a column
that cross the kernel's span of rows, a column all one row, out-of-range
rows inside a run, S not a multiple of the span.

On the CPU the port's wrapper runs its plain version (f32 index_add_); the
CUDA kernel K1 is compared with it on the card by chip_smoke.py and by
tests/test_torch_cuda.py. Tolerances: f32 at 1e-4 relative to the max; the
bf16-row mode at 1.5e-2, the repo's bf16 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laenerf_tpu.ops.scatter_add import scatter_add_rows as jax_scatter
from laenerf_tpu.ops.scatter_add import scatter_add_rows_xla
from laenerf_tpu_torch.ops.scatter_add import (RUN_SPAN, scatter_add_rows,
                                               scatter_add_rows_plain)


def _uniform(seed, Q, T, C):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, T, Q).astype(np.int32),
            rng.randn(Q, C).astype(np.float32), T)


def _all_one_row():
    Q, T, C = 8192, 4096, 4
    return np.full(Q, 17, np.int32), np.ones((Q, C), np.float32), T


def _clustered():
    rng = np.random.RandomState(1)
    Q, T, C = 20000, 40000, 8
    return ((5000 + rng.randint(0, 300, Q)).astype(np.int32),
            rng.randn(Q, C).astype(np.float32), T)


def _block_straddle():
    Q, T, C = 6144, 6144, 2
    idx = np.concatenate([np.full(2047, 2047), np.full(2049, 2048),
                          np.full(2048, 4095)]).astype(np.int32)
    return idx, np.ones((Q, C), np.float32), T


def _skewed():
    rng = np.random.RandomState(4)
    Q, T, C = 30000, 16384, 8
    idx = np.concatenate([rng.randint(0, 2048, Q // 2),
                          rng.randint(8192, T, Q - Q // 2)]).astype(np.int32)
    return idx, rng.randn(Q, C).astype(np.float32), T


CASES = {
    "uniform": lambda: _uniform(0, 10000, 5000, 8),
    "all_one_row": _all_one_row,
    "clustered_empty_tiles": _clustered,
    "block_straddle": _block_straddle,
    "tiny_table": lambda: _uniform(2, 3000, 100, 8),
    "skewed": _skewed,
}


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    scale = float(np.max(np.abs(ref))) + 1e-8
    return float(np.max(np.abs(np.asarray(got, np.float32) - ref))) / scale


@pytest.mark.parametrize("precision,tol", [("f32", 1e-4), ("bf16", 1.5e-2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_add_matches_jax(case, precision, tol):
    idx, g, T = CASES[case]()
    ref_xla = scatter_add_rows_xla(jnp.asarray(idx), jnp.asarray(g), T)
    ref_pallas = jax_scatter(jnp.asarray(idx), jnp.asarray(g), T,
                             precision=precision, interpret=True)
    got = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), T,
                           precision=precision)
    assert got.shape == (T, g.shape[1]) and got.dtype == torch.float32
    # on CPU tensors the wrapper is exactly the plain version
    assert torch.equal(got, scatter_add_rows_plain(
        torch.from_numpy(idx), torch.from_numpy(g), T, precision=precision))
    assert _rel_err(got.numpy(), ref_xla) < tol
    assert _rel_err(got.numpy(), ref_pallas) < tol


def test_scatter_add_bf16_out():
    """out_dtype=bf16 is the f32 accumulation converted once, as in JAX."""
    idx, g, T = _skewed()
    ref = jax_scatter(jnp.asarray(idx), jnp.asarray(g), T, precision="bf16",
                      interpret=True, out_dtype=jnp.bfloat16)
    got = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), T,
                           precision="bf16", out_dtype=torch.bfloat16)
    f32 = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), T,
                           precision="bf16")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    assert _rel_err(got.float().numpy(), np.asarray(ref, np.float32)) < 1.5e-2


def test_scatter_add_empty():
    ref = jax_scatter(jnp.zeros((0,), jnp.int32), jnp.zeros((0, 4)), 100,
                      interpret=True)
    got = scatter_add_rows(torch.zeros((0,), dtype=torch.int32),
                           torch.zeros((0, 4)), 100)
    assert got.shape == (100, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_scatter_add_out_of_range_rows_dropped():
    idx, g, T = _uniform(3, 5000, 700, 4)
    idx[::97] = T
    idx[5::89] = T + 5
    idx[7::83] = -1
    idx[9::79] = -7
    ref_pallas = jax_scatter(jnp.asarray(idx), jnp.asarray(g), T,
                             precision="f32", interpret=True)
    keep = (idx >= 0) & (idx < T)
    ref_xla = scatter_add_rows_xla(jnp.asarray(idx[keep]),
                                   jnp.asarray(g[keep]), T)
    got = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), T,
                           precision="f32")
    assert _rel_err(got.numpy(), ref_pallas) < 1e-4
    assert _rel_err(got.numpy(), ref_xla) < 1e-4


def test_scatter_add_rejects_bad_args():
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        scatter_add_rows(idx, torch.zeros((5, 2)), 8)
    with pytest.raises(TypeError):
        scatter_add_rows(idx, torch.zeros((4, 2), dtype=torch.float64), 8)
    with pytest.raises(ValueError):
        scatter_add_rows(idx, torch.zeros((4, 2)), 8, precision="f16")
    idx2 = torch.zeros((4, 3), dtype=torch.int32)
    for g in (torch.zeros((12, 2)), torch.zeros((4, 2, 2))):
        with pytest.raises(ValueError):  # a 2-D idx wants g [S, P, C]
            scatter_add_rows(idx2, g, 8)
    with pytest.raises(ValueError):
        scatter_add_rows(torch.zeros((2, 2, 2), dtype=torch.int32),
                         torch.zeros((2, 2, 2, 2)), 8)


def _column_runs(seed, S, P, T, C, max_run):
    """idx [S, P] whose columns hold runs of one row of 1..max_run rows,
    placed without regard to the kernel's span of RUN_SPAN rows."""
    rng = np.random.RandomState(seed)
    idx = np.empty((S, P), np.int32)
    for p in range(P):
        s = 0
        while s < S:
            n = rng.randint(1, max_run + 1)
            idx[s:s + n, p] = rng.randint(0, T)
            s += n
    return idx, rng.randn(S, P, C).astype(np.float32), T


def _one_row_column():
    idx, g, T = _column_runs(5, 3 * RUN_SPAN + 5, 24, 900, 4, 6)
    idx[:, 7] = 123  # one whole column on one row, across every span
    idx[:, 8] = 123
    return idx, g, T


def _runs_across_spans():
    # every column one run from row RUN_SPAN - 3 to 2 * RUN_SPAN + 2, so the
    # run crosses two span boundaries
    idx, g, T = _column_runs(6, 3 * RUN_SPAN, 40, 2000, 8, 3)
    idx[RUN_SPAN - 3:2 * RUN_SPAN + 3] = np.arange(40, dtype=np.int32) * 7
    return idx, g, T


def _out_of_range_in_runs():
    idx, g, T = _column_runs(7, 2 * RUN_SPAN + 9, 33, 500, 4, 12)
    rng = np.random.RandomState(8)
    for s, p in zip(rng.randint(0, idx.shape[0], 120),
                    rng.randint(0, idx.shape[1], 120)):
        idx[s, p] = rng.choice([-1, -9, T, T + 3])
    idx[4:9, 0] = -1  # a run of dropped rows
    return idx, g, T


CASES_2D = {
    "ray_runs": lambda: _column_runs(4, 200, 64, 3000, 4, 20),
    "runs_across_spans": _runs_across_spans,
    "one_row_column": _one_row_column,
    "out_of_range_in_runs": _out_of_range_in_runs,
    "c3_ragged_s": lambda: _column_runs(9, RUN_SPAN + 1, 5, 50, 3, 4),
}


@pytest.mark.parametrize("precision,tol", [("f32", 1e-4), ("bf16", 1.5e-2)])
@pytest.mark.parametrize("case", sorted(CASES_2D))
def test_scatter_add_2d_matches_jax(case, precision, tol):
    idx, g, T = CASES_2D[case]()
    C = g.shape[-1]
    flat_idx, flat_g = idx.reshape(-1), g.reshape(-1, C)
    keep = (flat_idx >= 0) & (flat_idx < T)
    ref_xla = scatter_add_rows_xla(jnp.asarray(flat_idx[keep]),
                                   jnp.asarray(flat_g[keep]), T)
    ref_pallas = jax_scatter(jnp.asarray(flat_idx), jnp.asarray(flat_g), T,
                             precision=precision, interpret=True)
    got = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), T,
                           precision=precision)
    assert got.shape == (T, C) and got.dtype == torch.float32
    # the 2-D form is the same function as its flattening
    assert torch.equal(got, scatter_add_rows_plain(
        torch.from_numpy(flat_idx), torch.from_numpy(flat_g), T,
        precision=precision))
    assert _rel_err(got.numpy(), ref_xla) < tol
    assert _rel_err(got.numpy(), ref_pallas) < tol
