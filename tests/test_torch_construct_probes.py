"""Parity of the port's construct probes (laenerf_tpu_torch/ops/
construct_probes.py, kernel K7) with the eight Pallas kernels of
perf/bisect_mosaic.py, run through pl.pallas_call(interpret=True) on the CPU
at the script's own shapes (8 tiles of 1,024 rows, C = 8; k6b C = 128), and
k5 and k7 also at ragged ones (their bodies and grid built from the shape).

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
Q = 4096


def _grid_spec(n_in, scratch=(), width=C, tile=TILE, n_tiles=N_TILES):
    return pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * n_in,
        out_specs=pl.BlockSpec((tile, width), lambda k, lo: (k, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=list(scratch))


def _run(kern, lo, *args, n_in=0, scratch=(), width=C, tile=TILE,
         n_tiles=N_TILES):
    return np.asarray(pl.pallas_call(
        kern, grid_spec=_grid_spec(n_in, scratch, width, tile, n_tiles),
        out_shape=jax.ShapeDtypeStruct((n_tiles * tile, width), jnp.float32),
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


def _k5_of(tile, width):
    """perf/bisect_mosaic.py:125 (k5 :124), tiles of tile rows by width."""
    def kern(lo_ref, out_ref):
        k = pl.program_id(0)
        n = lo_ref[k]

        def body(j, acc):
            return acc + 1.0

        acc = jax.lax.fori_loop(0, n, body,
                                jnp.zeros((tile, width), jnp.float32))
        out_ref[:] = acc

    return kern


_k5 = _k5_of(TILE, C)


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


def _k7_of(tile, width):
    """perf/bisect_mosaic.py:191 (k7 :190), tiles of tile <= MAXU rows by
    width."""
    def kern(lo_ref, out_ref):
        v = jax.lax.broadcasted_iota(jnp.int32, (MAXU,), 0)
        out_ref[:] = jnp.broadcast_to(
            v[:tile].astype(jnp.float32)[:, None], (tile, width))

    return kern


_k7 = _k7_of(TILE, C)


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


def test_copy_1d_matches_pallas_on_edge_offsets():
    """k4 at the script's grid (8 tiles of 1,024 rows, C = 8) with offsets
    at the edges of the kernel's 64-row slices and 16-byte windows: 0,
    len(q) - tile, and values that are 1, 2 and 3 mod 4
    (bisect_mosaic.edge_offsets, both of its lo vectors), on random q."""
    rng = np.random.RandomState(12)
    q = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, Q + MAXU)
                         .astype(np.int32))
    offsets = bisect_mosaic.edge_offsets(TILE, N_TILES, Q + MAXU)
    assert len(offsets) == 2 and {0, Q + MAXU - TILE} <= set(offsets[0])
    for lo in offsets:
        assert {int(v) % 4 for v in lo} == {0, 1, 2, 3}
        args = (q, torch.from_numpy(lo), N_TILES, TILE, C)
        np.testing.assert_array_equal(cp.copy_1d(*args).numpy(),
                                      _jax_construct("k4", args))


@pytest.mark.parametrize("tile,width,n_tiles", [(100, 3, 7), (1, 1, 7),
                                                (100, 8, 7), (1024, 128, 2)])
@pytest.mark.parametrize("construct", ["k5", "k7"])
def test_fill_matches_pallas_at_ragged_shapes(construct, tile, width,
                                              n_tiles):
    """k5 and k7 at the card tests' ragged shapes (tiles that start off 16
    bytes where tile * width % 4 != 0, one-row tiles, one lane, 128 lanes),
    the Pallas kernels' bodies and grid built from the shape. k5 on trips
    -5, 0, 1, 3 and 199 among random ones (np.random.RandomState)."""
    rng = np.random.RandomState(tile + width)
    lo = rng.randint(-5, 200, n_tiles + 1).astype(np.int32)
    lo[:min(5, n_tiles)] = (-5, 0, 1, 3, 199)[:n_tiles]
    if construct == "k5":
        ref = _run(_k5_of(tile, width), lo, width=width, tile=tile,
                   n_tiles=n_tiles)
        got = cp.dynamic_loop(torch.from_numpy(lo), n_tiles, tile, width)
    else:
        ref = _run(_k7_of(tile, width), np.zeros(n_tiles + 1), width=width,
                   tile=tile, n_tiles=n_tiles)
        got = cp.iota_rows(n_tiles, tile, width, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _onehot_case(case):
    """(local int32, g f32 of bf16 values, tile) of one one-hot product:
    for C = case (8, 128), k6's or k6b's random case of bisect_mosaic (a
    random one-hot, a tenth of the columns dropped: at most one term a row,
    so the sums are exact); for a named case, an edge of the kernel's window
    bucketing (32-row windows, 1,024-column scan chunks) with small integer
    rows, which add exactly in any order."""
    if isinstance(case, int):
        label = "k6 onehot+dot C=8" if case == 8 else "k6b onehot+dot C=128"
        _, _, _, (local, g, tile) = {c[0]: c for c in bisect_mosaic.cases(
            "cpu", seed=5)}[label]
        return local.numpy(), g.float().numpy(), tile
    rng = np.random.RandomState(len(case))
    n, maxu, tile, C = {"one_row_c128": (2, 1024, 256, 128),
                        "empty_windows_and_tile": (3, 256, 128, 16),
                        "maxu_2048_tile_64": (2, 2048, 64, 8)}[case]
    local = rng.randint(-8, tile + 8, (n, maxu))
    if case == "one_row_c128":
        local[:] = [[37], [255]]  # every column of a tile on one row
    if case == "empty_windows_and_tile":
        # tile 0 leaves windows 0 and 2 empty; tile 1 lies wholly outside
        local[0] = rng.choice(np.r_[32:64, 96:128], maxu)
        local[1] = rng.choice([-1, tile, 5000, -2 ** 31, 2 ** 31 - 1], maxu)
    g = rng.randint(-8, 9, (n, maxu, C)).astype(np.float32)
    return local.astype(np.int32), g, tile


@pytest.mark.parametrize("case", [8, 128, "one_row_c128",
                                  "empty_windows_and_tile",
                                  "maxu_2048_tile_64"])
def test_onehot_dot_random_matches_jnp_one_hot_product(case):
    """k6 and k6b on a random one-hot and random bf16 rows, and the edge
    cases of the kernel's window bucketing (many columns on one row, empty
    windows, a tile wholly outside, more columns than one scan chunk),
    against the one-hot product in jnp."""
    local, g, tile = _onehot_case(case)
    oh = jax.nn.one_hot(jnp.asarray(local), tile, dtype=jnp.float32)
    ref = jnp.einsum("kmr,kmc->krc", oh, jnp.asarray(g),
                     precision=jax.lax.Precision.HIGHEST)
    got = cp.onehot_dot(torch.from_numpy(local),
                        torch.from_numpy(g).bfloat16(), tile)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref).reshape(-1, g.shape[2]))


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
    lambda: cp.onehot_dot(torch.zeros(17, dtype=torch.int32)[1:].view(1, 16),
                          torch.zeros((1, 16, 8), dtype=torch.bfloat16), 32),
    lambda: cp.iota_rows(1, 32, 8, device="meta"),
], ids=["row_bytes", "short_g", "f64_g", "q_length", "float_lo", "short_lo",
        "f32_onehot_rows", "onehot_width", "onehot_tile", "onehot_local_align",
        "meta_device"])
def test_wrappers_reject_bad_args(call):
    with pytest.raises((TypeError, ValueError)):
        call()
