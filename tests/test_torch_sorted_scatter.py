"""Parity of the port's sorted scatter-add (laenerf_tpu_torch/ops/
sorted_scatter.py, kernels K5 and K6) with the TPU prototypes of
perf/microbench_scatter2.py, perf/probe_worklist.py and
perf/probe_worklist2.py, run through pl.pallas_call(interpret=True) on the
CPU at probe_worklist.py's --small shapes (256-row tiles and blocks, levels
of 1,024/4,096/8,192 rows, 2,048 samples x 6 rows: Q = 12,288, C = 8).

Those scripts run their benchmarks when imported, so the kernel bodies and
the XLA code around them below are copies, each with its file:line above
it. The same numpy inputs (perf/scatter_inputs.py, which the scripts'
generator is checked against) go through the JAX pipeline (sort + kernel)
and the port's (sort_stage / build_worklist + the wrapper, which on CPU
tensors runs its plain version).

Tolerances: the scatter sums at rel 1e-5 of max|ref| (f32 sums in another
order); the bf16-row pipeline also against the exact f32 `.at[].add` at
1.5e-2 (rows rounded to bf16); the sort stage and the work list exactly.
The kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from laenerf_tpu_torch.ops.sorted_scatter import (build_worklist, sort_stage,
                                                  tile_scatter,
                                                  tile_scatter_plain,
                                                  work_sizes,
                                                  worklist_scatter)
from laenerf_tpu_torch.perf import (microbench_scatter2, probe_worklist,
                                    probe_worklist2, tile_scatter_split)
from laenerf_tpu_torch.perf.scatter_inputs import FULL, SMALL, make_inputs

REL_TOL = 1e-5
BF16_TOL = 1.5e-2
C = 8
TILE = MAXU = SMALL.tile
T, Q = SMALL.T, SMALL.Q
SIZES = work_sizes(Q, T, TILE, MAXU)
T_PAD, N_TILES, Q_BLKS, W_CAP = SIZES


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)


@pytest.fixture(scope="module")
def small_inputs():
    idx, g = make_inputs(SMALL, C)
    return idx, g


def test_generator_matches_the_scripts():
    """perf/probe_worklist.py:48-63 with --small, copied: the same idx and
    g as make_inputs(SMALL)."""
    B, LK, LEVEL_SIZES = 2048, 6, [1024, 4096, 8192]
    rng = np.random.RandomState(0)
    level_offs = np.cumsum([0] + LEVEL_SIZES)[:-1]
    idx_np = np.zeros((B, LK), np.int32)
    blob = np.clip(rng.randn(B, 3) * 0.15 + 0.5, 0, 1)
    for l, (sz, off) in enumerate(zip(LEVEL_SIZES, level_offs)):
        for k in range(LK // len(LEVEL_SIZES)):
            kk = l * (LK // len(LEVEL_SIZES)) + k
            if sz < 500000:
                res = max(2, round(sz ** (1 / 3)))
                cell = np.minimum((blob * res).astype(np.int64), res - 1)
                flat = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2] + k
                idx_np[:, kk] = off + np.minimum(flat, sz - 1)
            else:
                idx_np[:, kk] = off + rng.randint(0, sz, B)
    g = rng.randn(B * LK, C).astype(np.float32)
    idx, g_port = make_inputs(SMALL, C)
    np.testing.assert_array_equal(idx, idx_np.reshape(-1))
    np.testing.assert_array_equal(g_port, g)


# perf/microbench_scatter2.py:118 sort_stage (idx, g, TILE, N_TILES were
# globals; the x[0] shift is 0)
def _jax_sort_stage(idx, g, tile, n_tiles):
    order = jnp.argsort(idx)
    qs = jnp.take(idx, order)
    gs = jnp.take(g, order, axis=0)
    bounds = jnp.arange(n_tiles + 1, dtype=jnp.int32) * tile
    lo = jnp.searchsorted(qs, bounds).astype(jnp.int32)
    return qs, gs, lo


def _make_scatter_tile_kernel(TILE, MAXU, C):
    # perf/microbench_scatter2.py:137 _scatter_tile_kernel
    def _scatter_tile_kernel(lo_ref, qs_hbm, gs_hbm, out_ref, scratch_q,
                             scratch_g, sem_q, sem_g):
        k = pl.program_id(0)
        lo_k = lo_ref[k]
        hi_k = lo_ref[k + 1]
        cnt = hi_k - lo_k
        base = k * TILE

        acc0 = jnp.zeros((TILE, C), jnp.float32)
        n_sub = jax.lax.div(cnt + MAXU - 1, MAXU)

        row_iota = jax.lax.broadcasted_iota(jnp.int32, (TILE, MAXU), 0)

        def body(j, acc):
            start = lo_k + j * MAXU
            cp_q = pltpu.make_async_copy(
                qs_hbm.at[pl.ds(start, MAXU)], scratch_q, sem_q)
            cp_g = pltpu.make_async_copy(
                gs_hbm.at[pl.ds(start, MAXU), :], scratch_g, sem_g)
            cp_q.start()
            cp_g.start()
            cp_q.wait()
            cp_g.wait()
            local = scratch_q[:] - base  # [MAXU]
            valid = (jax.lax.broadcasted_iota(jnp.int32, (MAXU,), 0)
                     < (cnt - j * MAXU))
            local = jnp.where(valid, local, -1)
            oh = (row_iota == local[None, :]).astype(jnp.float32)
            return acc + jnp.dot(oh, scratch_g[:],
                                 preferred_element_type=jnp.float32)

        acc = jax.lax.fori_loop(0, n_sub, body, acc0)
        out_ref[:] = acc
    return _scatter_tile_kernel


def _jax_s1(idx, g):
    """S1 as check() runs it (perf/microbench_scatter2.py:247-262)."""
    qs, gs, lo = _jax_sort_stage(jnp.asarray(idx), jnp.asarray(g), TILE,
                                 N_TILES)
    qs_p = jnp.concatenate([qs, jnp.full((MAXU,), T_PAD + 1, jnp.int32)])
    gs_p = jnp.concatenate([gs, jnp.zeros((MAXU, C), jnp.float32)])
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(N_TILES,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=pl.BlockSpec((TILE, C), lambda k, lo: (k, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((MAXU,), jnp.int32),
                        pltpu.VMEM((MAXU, C), jnp.float32),
                        pltpu.SemaphoreType.DMA, pltpu.SemaphoreType.DMA],
    )
    return np.asarray(pl.pallas_call(
        _make_scatter_tile_kernel(TILE, MAXU, C), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((T_PAD, C), jnp.float32),
        interpret=True)(lo, qs_p, gs_p))


def _make_worklist_kernel(TILE, MAXU, C, onehot_dtype):
    N_GRP = MAXU // 128

    # perf/probe_worklist.py:71 _kernel (perf/probe_worklist2.py:71: the
    # one-hot in bf16)
    def _kernel(wt_ref, wb_ref, wfirst_ref, wreal_ref, qs_ref, gs_ref,
                out_ref):
        w = pl.program_id(0)
        base = wt_ref[w] * TILE

        @pl.when(wfirst_ref[w] == 1)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)

        @pl.when(wreal_ref[w] == 1)
        def _():
            local = qs_ref[:] - base  # [N_GRP, 128]
            row_iota = jax.lax.broadcasted_iota(jnp.int32, (TILE, 128), 0)
            acc = jnp.zeros((TILE, C), jnp.float32)
            for grp in range(N_GRP):
                oh = (row_iota == local[grp, :][None, :]).astype(
                    onehot_dtype)
                acc = acc + jnp.dot(oh, gs_ref[grp * 128:(grp + 1) * 128, :],
                                    preferred_element_type=jnp.float32)
            out_ref[:] += acc
    return _kernel


def _jax_worklist(qs, n_tiles, tile, maxu, q_blks, w_cap):
    """perf/probe_worklist.py:122-139, on sorted qs (the script's globals
    N_TILES, TILE, MAXU, Q_BLKS, W_CAP as arguments)."""
    bounds = jnp.arange(n_tiles + 1, dtype=jnp.int32) * tile
    lo = jnp.searchsorted(qs, bounds).astype(jnp.int32)
    cnt = lo[1:] - lo[:-1]
    blk_lo = lo[:-1] // maxu
    blk_hi = (jnp.maximum(lo[1:], 1) - 1) // maxu  # inclusive; dummy if cnt=0
    n_work = jnp.where(cnt > 0, blk_hi - blk_lo + 1, 1)
    cum = jnp.cumsum(n_work)
    total = cum[-1]
    # expand: work item w -> tile via searchsorted, block via offset
    w_ids = jnp.arange(w_cap, dtype=jnp.int32)
    wt = jnp.searchsorted(cum, w_ids, side="right").astype(jnp.int32)
    wt_c = jnp.minimum(wt, n_tiles - 1)
    w_off = w_ids - jnp.where(wt_c > 0, cum[wt_c - 1], 0)
    wreal = ((w_ids < total) & (jnp.take(cnt, wt_c) > 0)).astype(jnp.int32)
    wfirst = ((w_off == 0) & (w_ids < total)).astype(jnp.int32)
    wb = jnp.where(wreal == 1, jnp.take(blk_lo, wt_c) + w_off, q_blks - 1)
    wb = jnp.clip(wb, 0, q_blks - 1).astype(jnp.int32)
    wt_final = jnp.minimum(wt, n_tiles - 1).astype(jnp.int32)
    return wt_final, wb, wfirst, wreal


def _jax_scatter_pallas(idx, g, dtype):
    """scatter_pallas (perf/probe_worklist.py:113-142; probe_worklist2.py
    casts g to bf16 before the take)."""
    idx, g = jnp.asarray(idx), jnp.asarray(g).astype(dtype)
    order = jnp.argsort(idx)
    qs = jnp.take(idx, order)
    gs = jnp.take(g, order, axis=0)
    pad = Q_BLKS * MAXU - Q
    qs_p = jnp.concatenate([qs, jnp.full((pad,), T_PAD + 7, jnp.int32)])
    gs_p = jnp.concatenate([gs, jnp.zeros((pad, C), dtype)])
    wt, wb, wfirst, wreal = _jax_worklist(qs, N_TILES, TILE, MAXU, Q_BLKS,
                                          W_CAP)
    N_GRP = MAXU // 128
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4,
        grid=(W_CAP,),
        in_specs=[
            pl.BlockSpec((N_GRP, 128), lambda w, wt, wb, wf, wr: (wb[w], 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((MAXU, C), lambda w, wt, wb, wf, wr: (wb[w], 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((TILE, C),
                               lambda w, wt, wb, wf, wr: (wt[w], 0),
                               memory_space=pltpu.VMEM),
    )
    return np.asarray(pl.pallas_call(
        _make_worklist_kernel(TILE, MAXU, C, dtype), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((T_PAD, C), jnp.float32),
        interpret=True)(wt, wb, wfirst, wreal,
                        qs_p.reshape(Q_BLKS * N_GRP, 128), gs_p))


def test_sort_stage_matches_jax(small_inputs):
    idx, g = small_inputs
    ref = _jax_sort_stage(jnp.asarray(idx), jnp.asarray(g), TILE, N_TILES)
    got = sort_stage(torch.from_numpy(idx), torch.from_numpy(g), TILE,
                     N_TILES)
    for a, b in zip(got, ref):
        assert a.dtype in (torch.int32, torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _skewed(idx, g):
    """The small inputs plus 1,500 updates on 3 rows of tile 5: that tile
    then holds more than four MAXU sub-blocks, in runs of 400-600."""
    rows = 5 * TILE + np.repeat([3, 100, TILE - 1], [500, 600, 400])
    extra = np.random.RandomState(9).randn(rows.shape[0], C)
    return (np.concatenate([idx, rows]).astype(np.int32),
            np.concatenate([g, extra]).astype(np.float32))


@pytest.mark.parametrize("case", ["script", "skewed"])
def test_tile_scatter_matches_pallas(small_inputs, case):
    """Row 10: sort + _scatter_tile_kernel against sort_stage + K5's
    plain version, on the script's inputs and on a skewed set whose heavy
    tile takes the Pallas kernel through more than four sub-blocks."""
    idx, g = small_inputs if case == "script" else _skewed(*small_inputs)
    if case == "skewed":
        cnt = np.bincount(idx // TILE)
        assert cnt.max() > 4 * MAXU
    ref = _jax_s1(idx, g)
    got = tile_scatter(*sort_stage(torch.from_numpy(idx),
                                   torch.from_numpy(g), TILE, N_TILES), TILE)
    assert got.shape == (T_PAD, C) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < REL_TOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_worklist_scatter_matches_pallas(small_inputs, dtype):
    """Rows 11 (f32 rows) and 12 (bf16 rows, bf16 one-hot, f32 sums): the
    JAX work-list pipeline against the port's."""
    idx, g = small_inputs
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = _jax_scatter_pallas(idx, g, jdt)
    got = probe_worklist.worklist_pipeline(
        torch.from_numpy(idx), torch.from_numpy(g), SIZES, TILE, MAXU, tdt)
    assert got.shape == (T_PAD, C) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < REL_TOL
    if dtype == "bf16":
        exact = jnp.zeros((T_PAD, C), jnp.float32).at[idx].add(g)
        assert _rel(got.numpy(), exact) < BF16_TOL


def _sorted(rows):
    return np.sort(np.asarray(rows, np.int32))


WORKLIST_CASES = {
    "script": lambda: _sorted(make_inputs(SMALL, C)[0]),
    # tiles 1, 3 and 4 empty
    "empty_tiles": lambda: _sorted([0, 5, 5, 200, 512, 513, 1300] * 3),
    # tile 0's slab of 300 updates straddles blocks 0 and 1; tile 1's runs
    # from block 1 into block 2
    "straddle": lambda: _sorted([7] * 300 + [256 + 9] * 400 + [1000] * 50),
    "q0": lambda: np.zeros(0, np.int32),
}


@pytest.mark.parametrize("case", list(WORKLIST_CASES))
def test_build_worklist_matches_jax(case):
    qs = WORKLIST_CASES[case]()
    T_case = T if case == "script" else 6 * TILE
    sizes = work_sizes(qs.shape[0], T_case, TILE, MAXU)
    ref = _jax_worklist(jnp.asarray(qs), sizes.n_tiles, TILE, MAXU,
                        sizes.q_blks, sizes.w_cap)
    qs_t = torch.from_numpy(qs)
    lo = sort_stage(qs_t, torch.zeros((qs.shape[0], C)), TILE,
                    sizes.n_tiles)[2]
    got = build_worklist(lo, MAXU, sizes.w_cap, sizes.q_blks)
    for name, a, b in zip(("wt", "wb", "wfirst", "wreal"), got, ref):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_worklist_scatter_on_special_lists():
    """K6's plain version on the work lists of the special cases against
    index_add_ of the rows; the last block stops at Q and the dummy items
    (block Q_BLKS - 1, past Q) add nothing."""
    for case in ("empty_tiles", "straddle", "q0"):
        qs = WORKLIST_CASES[case]()
        sizes = work_sizes(qs.shape[0], 6 * TILE, TILE, MAXU)
        g = np.random.RandomState(1).randn(qs.shape[0], C).astype(np.float32)
        qs_t, g_t = torch.from_numpy(qs), torch.from_numpy(g)
        lo = sort_stage(qs_t, g_t, TILE, sizes.n_tiles)[2]
        wt, wb, _, wreal = build_worklist(lo, MAXU, sizes.w_cap,
                                          sizes.q_blks)
        got = worklist_scatter(qs_t, g_t, wt, wb, wreal, TILE, MAXU,
                               sizes.n_tiles)
        ref = torch.zeros((sizes.t_pad, C)).index_add_(0, qs_t.long(), g_t)
        assert _rel(got.numpy(), ref.numpy()) < REL_TOL, case


def test_tile_scatter_plain_drops_rows_outside_their_tile():
    """Rows below 0 or past the table are dropped, and so is a row that a
    hand-made lo puts in another tile's slab."""
    qs = torch.tensor([-3, 0, 5, 40, 63, 64, 90], dtype=torch.int32)
    g = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    # 2 tiles of 32 rows; slab 0 holds rows 0, 5 and 40, slab 1 row 63
    lo = torch.tensor([1, 4, 5], dtype=torch.int32)
    ref = torch.zeros((64, 2))
    ref[0], ref[5], ref[63] = g[1], g[2], g[4]
    assert torch.equal(tile_scatter(qs, g, lo, 32), ref)
    ref[40] = g[3]  # searchsorted puts row 40 in slab 1
    lo_sorted = sort_stage(qs, g, 32, 2)[2]
    assert lo_sorted.tolist() == [1, 3, 5]
    assert torch.equal(tile_scatter_plain(qs, g, lo_sorted, 32), ref)


def _jax_s2_chunks(qs, gs, lo, maxu, chunk, tile, n_tiles, q):
    """do_chunk of perf/microbench_scatter2.py:220-235 (S2) over all
    chunks."""
    qs_p = jnp.concatenate([qs, jnp.full((maxu,), -1, jnp.int32)])
    gs_p = jnp.concatenate([gs, jnp.zeros((maxu, C), jnp.float32)])

    def do_chunk(c):
        tks = jnp.minimum(c * chunk + jnp.arange(chunk), n_tiles - 1)
        slots = lo[tks][:, None] + jnp.arange(maxu)[None, :]
        hi = lo[tks + 1][:, None]
        ok = slots < hi
        slots = jnp.minimum(slots, q + maxu - 1)
        tq = jnp.take(qs_p, slots)  # [chunk, maxu]
        tg = jnp.take(gs_p, slots.reshape(-1), axis=0).reshape(
            chunk, maxu, C)
        local = jnp.where(ok, tq - tks[:, None] * tile, -1)
        oh = jax.nn.one_hot(local, tile, dtype=jnp.float32)
        return jnp.einsum("kmr,kmc->krc", oh, tg,
                          precision=jax.lax.Precision.HIGHEST)

    n_chunks = (n_tiles + chunk - 1) // chunk
    grads = jax.lax.map(do_chunk, jnp.arange(n_chunks))
    return grads.reshape(n_chunks * chunk * tile, C)[:n_tiles * tile]


def test_padded_tile_einsum_matches_jax_s2(small_inputs):
    """S2 at the small shapes, 512 updates a tile, 16-tile chunks: the same
    dropped updates, the same sums."""
    idx, g = small_inputs
    qs, gs, lo = _jax_sort_stage(jnp.asarray(idx), jnp.asarray(g), TILE,
                                 N_TILES)
    ref = _jax_s2_chunks(qs, gs, lo, 512, 16, TILE, N_TILES, Q)
    t_qs, t_gs, t_lo = (torch.from_numpy(np.array(a)) for a in (qs, gs, lo))
    got = microbench_scatter2.padded_tile_einsum(t_qs, t_gs, t_lo, TILE, 512,
                                                 16)
    assert _rel(got.numpy(), ref) < REL_TOL
    cnt = np.diff(np.asarray(lo))
    assert microbench_scatter2.dropped_updates(t_lo, 512) == int(
        np.maximum(cnt - 512, 0).sum()) > 0


def test_s2_drops_539856_updates_at_full_shape():
    """The JAX S2 reads at most 2,048 updates per 1,024-row tile: with the
    script's own indices 76 tiles hold more, and 539,856 of 2,097,152
    updates are dropped."""
    idx, _ = make_inputs(FULL, 1)
    sizes = work_sizes(FULL.Q, FULL.T, 1024, 1024)
    qs = torch.sort(torch.from_numpy(idx)).values
    bounds = torch.arange(sizes.n_tiles + 1, dtype=torch.int32) * 1024
    lo = torch.searchsorted(qs, bounds).to(torch.int32)
    assert microbench_scatter2.dropped_updates(lo, 2048) == 539856
    assert int(((lo[1:] - lo[:-1]) > 2048).sum()) == 76


@pytest.mark.parametrize("script,rows", [
    (microbench_scatter2, 4), (probe_worklist, 6), (probe_worklist2, 6),
    (tile_scatter_split, 3)],
    ids=["microbench_scatter2", "probe_worklist", "probe_worklist2",
         "tile_scatter_split"])
def test_scatter_probe_main_on_cpu(script, rows, capsys):
    """Each entry point runs end to end at the --small shapes on the CPU,
    prints the host line and one row per probe of the JAX script."""
    res = script.main(["--device", "cpu", "--small", "--n", "2"])
    out = capsys.readouterr().out
    assert out.startswith("device=cpu") and out.rstrip().endswith("done")
    assert len(res) == rows
    assert all(math.isfinite(t) and t > 0 for t in res.values())
    assert all(label in out for label in res)


@pytest.mark.parametrize("call", [
    lambda: tile_scatter(torch.zeros(4, dtype=torch.int64), torch.zeros(4, 8),
                         torch.zeros(2, dtype=torch.int32), 32),
    lambda: tile_scatter(torch.zeros(4, dtype=torch.int32),
                         torch.zeros(4, 8, dtype=torch.float64),
                         torch.zeros(2, dtype=torch.int32), 32),
    lambda: tile_scatter(torch.zeros(4, dtype=torch.int32), torch.zeros(3, 8),
                         torch.zeros(2, dtype=torch.int32), 32),
    lambda: tile_scatter(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 8),
                         torch.zeros(0, dtype=torch.int32), 32),
    lambda: tile_scatter(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 8),
                         torch.zeros(2, dtype=torch.int32), 8192),
    lambda: worklist_scatter(torch.zeros(4, dtype=torch.int32),
                             torch.zeros(4, 8),
                             torch.zeros(3, dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32), 32, 32, 1),
    lambda: tile_scatter(torch.zeros(4, dtype=torch.int32, device="meta"),
                         torch.zeros(4, 8, device="meta"),
                         torch.zeros(2, dtype=torch.int32, device="meta"), 32),
], ids=["int64_rows", "f64_updates", "lengths", "empty_lo", "smem",
        "work_lengths", "meta_device"])
def test_wrappers_reject_bad_args(call):
    with pytest.raises((TypeError, ValueError)):
        call()
