"""Parity of the port's scatter-add (laenerf_tpu_torch/ops/scatter_add.py)
with the JAX package's Pallas work-list kernel (interpret mode on the CPU)
and its plain XLA scatter, on the cases of tests/test_scatter_add.py plus
Q == 0 and out-of-range rows.

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
from laenerf_tpu_torch.ops.scatter_add import (scatter_add_rows,
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
