"""Parity of the port's construct probes (laenerf_tpu_torch/ops/
construct_probes.py, kernel K7) with the eight Pallas kernels of
perf/bisect_mosaic.py, run through pl.pallas_call(interpret=True) on the CPU
at the script's own shapes (8 tiles of 1,024 rows, C = 8; k6b C = 128).

The script runs its kernels when imported, so each kernel body below is a
copy with the script's file:line above it, and the grid specs are the
script's own. k1-k5 take their offsets and rows as inputs, so they run on
the script's inputs and on random ones; k6, k6b and k7 build theirs inside
the kernel. The port's wrappers run their plain versions on these CPU
tensors. Every check is exact equality: the constructs copy, count and sum
one-hot products of values that add exactly. The kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from laenerf_tpu_torch.ops import construct_probes as cp
from laenerf_tpu_torch.perf import bisect_mosaic

TILE, MAXU, C = 1024, 1024, 8
N_TILES = 8
T_PAD = N_TILES * TILE
Q = 4096


def _grid_spec(n_in, scratch=(), width=C):
    return pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(N_TILES,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * n_in,
        out_specs=pl.BlockSpec((TILE, width), lambda k, lo: (k, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=list(scratch))


def _run(kern, lo, *args, n_in=0, scratch=(), width=C):
    return np.asarray(pl.pallas_call(
        kern, grid_spec=_grid_spec(n_in, scratch, width),
        out_shape=jax.ShapeDtypeStruct((T_PAD, width), jnp.float32),
        interpret=True)(jnp.asarray(lo, jnp.int32), *args))


# perf/bisect_mosaic.py:29 (k1 :28)
def _k1(lo_ref, out_ref):
    out_ref[:] = jnp.full((TILE, C), lo_ref[pl.program_id(0)], jnp.float32)


# perf/bisect_mosaic.py:47 (k2 :46)
def _k2(lo_ref, gs_hbm, out_ref, scr, sem):
    cp_ = pltpu.make_async_copy(gs_hbm.at[pl.ds(0, MAXU), :], scr, sem)
    cp_.start()
    cp_.wait()
    out_ref[:] = scr[:TILE] * 1.0


# perf/bisect_mosaic.py:71 (k3 :70)
def _k3(lo_ref, gs_hbm, out_ref, scr, sem):
    k = pl.program_id(0)
    start = lo_ref[k]
    cp_ = pltpu.make_async_copy(gs_hbm.at[pl.ds(start, MAXU), :], scr, sem)
    cp_.start()
    cp_.wait()
    out_ref[:] = scr[:TILE] * 1.0


# perf/bisect_mosaic.py:98 (k4 :97)
def _k4(lo_ref, qs_hbm, out_ref, scr_q, sem):
    k = pl.program_id(0)
    start = lo_ref[k]
    cp_ = pltpu.make_async_copy(qs_hbm.at[pl.ds(start, MAXU)], scr_q, sem)
    cp_.start()
    cp_.wait()
    out_ref[:] = jnp.broadcast_to(
        scr_q[:TILE].astype(jnp.float32)[:, None], (TILE, C))


# perf/bisect_mosaic.py:125 (k5 :124)
def _k5(lo_ref, out_ref):
    k = pl.program_id(0)
    n = lo_ref[k]

    def body(j, acc):
        return acc + 1.0

    acc = jax.lax.fori_loop(0, n, body, jnp.zeros((TILE, C), jnp.float32))
    out_ref[:] = acc


# perf/bisect_mosaic.py:150 (k6 :149)
def _k6(lo_ref, out_ref):
    row_iota = jax.lax.broadcasted_iota(jnp.int32, (TILE, MAXU), 0)
    local = jax.lax.broadcasted_iota(jnp.int32, (MAXU,), 0)
    oh = (row_iota == local[None, :]).astype(jnp.float32)
    g = jnp.full((MAXU, C), 2.0, jnp.float32)
    out_ref[:] = jnp.dot(oh, g, preferred_element_type=jnp.float32)


# perf/bisect_mosaic.py:171 (k6b :170)
def _k6b(lo_ref, out_ref):
    row_iota = jax.lax.broadcasted_iota(jnp.int32, (TILE, MAXU), 0)
    local = jax.lax.broadcasted_iota(jnp.int32, (MAXU,), 0)
    oh = (row_iota == local[None, :]).astype(jnp.float32)
    g = jnp.full((MAXU, 128), 2.0, jnp.float32)
    out_ref[:] = jnp.dot(oh, g, preferred_element_type=jnp.float32)


# perf/bisect_mosaic.py:191 (k7 :190)
def _k7(lo_ref, out_ref):
    v = jax.lax.broadcasted_iota(jnp.int32, (MAXU,), 0)
    out_ref[:] = jnp.broadcast_to(
        v[:TILE].astype(jnp.float32)[:, None], (TILE, C))


def _dma_f32():
    return [pltpu.VMEM((MAXU, C), jnp.float32), pltpu.SemaphoreType.DMA]


def _jax_construct(label, args):
    """The Pallas kernel of `label` on the port wrapper's args (numpy)."""
    a = [x.numpy() if isinstance(x, torch.Tensor)
         and x.dtype != torch.bfloat16 else x for x in args]
    if label.startswith("k1"):
        return _run(_k1, a[0])
    if label.startswith("k2"):
        return _run(_k2, np.zeros(N_TILES + 1), jnp.asarray(a[0]), n_in=1,
                    scratch=_dma_f32())
    if label.startswith("k3"):
        return _run(_k3, a[1], jnp.asarray(a[0]), n_in=1, scratch=_dma_f32())
    if label.startswith("k4"):
        return _run(_k4, a[1], jnp.asarray(a[0]), n_in=1,
                    scratch=[pltpu.VMEM((MAXU,), jnp.int32),
                             pltpu.SemaphoreType.DMA])
    if label.startswith("k5"):
        return _run(_k5, a[0])
    if label.startswith("k6b"):
        return _run(_k6b, np.zeros(N_TILES + 1), width=128)
    if label.startswith("k6"):
        return _run(_k6, np.zeros(N_TILES + 1))
    return _run(_k7, np.zeros(N_TILES + 1))


SCRIPT_CASES = {c[0]: c for c in bisect_mosaic.cases("cpu")}
RANDOM_CASES = {c[0]: c for c in bisect_mosaic.cases("cpu", seed=11)
                if c[0][:2] in ("k1", "k2", "k3", "k4", "k5")}


@pytest.mark.parametrize("label", list(SCRIPT_CASES))
def test_construct_matches_pallas_on_script_inputs(label):
    _, _, fn, args = SCRIPT_CASES[label]
    ref = _jax_construct(label, args)
    got = fn(*args)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("label", list(RANDOM_CASES))
def test_construct_matches_pallas_on_random_inputs(label):
    """k1-k5 read their offsets and rows from their inputs: random offsets
    anywhere in range (k4's not 16-byte aligned), random rows, random trip
    counts (negative ones run no iteration)."""
    _, _, fn, args = RANDOM_CASES[label]
    np.testing.assert_array_equal(fn(*args).numpy(),
                                  _jax_construct(label, args))


@pytest.mark.parametrize("width", [8, 128])
def test_onehot_dot_random_matches_jnp_one_hot_product(width):
    """k6 on a random one-hot (a tenth of the columns dropped) and random
    bf16 rows, against the one-hot product in jnp: each output row holds at
    most one term, so the sums are exact."""
    label = "k6 onehot+dot C=8" if width == 8 else "k6b onehot+dot C=128"
    _, _, fn, (local, g, tile) = {c[0]: c for c in bisect_mosaic.cases(
        "cpu", seed=5)}[label]
    oh = jax.nn.one_hot(jnp.asarray(local.numpy()), tile, dtype=jnp.float32)
    gj = jnp.asarray(g.float().numpy())
    ref = jnp.einsum("kmr,kmc->krc", oh, gj,
                     precision=jax.lax.Precision.HIGHEST)
    got = fn(local, g, tile)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref).reshape(-1, width))


def test_onehot_dot_plain_sums_repeated_rows():
    """Several columns on one row add up (small integers: exact in any
    order); rows outside the tile add nothing."""
    local = torch.tensor([[3, 3, 3, -1, 32, 0] + [5] * 10,
                          [31] * 16], dtype=torch.int32)
    g = torch.arange(2 * 16 * 8, dtype=torch.float32).reshape(2, 16, 8)
    got = cp.onehot_dot(local, g.bfloat16(), 32)
    ref = torch.zeros(64, 8)
    for k in range(2):
        for m in range(16):
            if 0 <= local[k, m] < 32:
                ref[k * 32 + local[k, m]] += g[k, m]
    assert torch.equal(got, ref)


def test_bisect_main_on_cpu(capsys):
    """The entry point prints eight OK lines."""
    res = bisect_mosaic.main(["--device", "cpu", "--n", "2"])
    out = capsys.readouterr().out
    assert out.startswith("device=cpu")
    assert len(res) == 8 and all(res.values()), out
    assert out.count(" OK ") == 8 and out.rstrip().endswith("bisect done")


def test_plain_versions_raise_out_of_range():
    g = torch.zeros((64, 8))
    q = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(IndexError):
        cp.dynamic_copy(g, torch.tensor([33], dtype=torch.int32), 1, 32)
    with pytest.raises(IndexError):
        cp.copy_1d(q, torch.tensor([-1], dtype=torch.int32), 1, 32, 8)
    with pytest.raises(IndexError):
        cp.dynamic_loop(torch.tensor([1 << 25], dtype=torch.int32), 1, 32, 8)


@pytest.mark.parametrize("call", [
    lambda: cp.static_copy(torch.zeros((64, 6)), 1, 32),
    lambda: cp.static_copy(torch.zeros((16, 8)), 1, 32),
    lambda: cp.static_copy(torch.zeros((64, 8), dtype=torch.float64), 1, 32),
    lambda: cp.copy_1d(torch.zeros(62, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32), 1, 32, 8),
    lambda: cp.prefetch_write(torch.zeros(2), 1, 32, 8),
    lambda: cp.prefetch_write(torch.zeros(1, dtype=torch.int32), 2, 32, 8),
    lambda: cp.onehot_dot(torch.zeros((1, 16), dtype=torch.int32),
                          torch.zeros((1, 16, 8)), 32),
    lambda: cp.onehot_dot(torch.zeros((1, 16), dtype=torch.int32),
                          torch.zeros((1, 16, 24), dtype=torch.bfloat16), 32),
    lambda: cp.onehot_dot(torch.zeros((1, 16), dtype=torch.int32),
                          torch.zeros((1, 16, 8), dtype=torch.bfloat16), 48),
    lambda: cp.iota_rows(1, 32, 8, device="meta"),
], ids=["row_bytes", "short_g", "f64_g", "q_length", "float_lo", "short_lo",
        "f32_onehot_rows", "onehot_width", "onehot_tile", "meta_device"])
def test_wrappers_reject_bad_args(call):
    with pytest.raises((TypeError, ValueError)):
        call()
