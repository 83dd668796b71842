"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each, tagged with the seconds since the start
(any failure exits non-zero, before the last line):
  1. device: requires CUDA; prints the card's name and power limit.
  2. build: compiles the CUDA sources (csrc/scatter_add.cu: K1;
     csrc/gather_probes.cu: K2-K4; csrc/sorted_scatter.cu: K5, K6;
     csrc/construct_probes.cu: K7) with nvcc, one process per source, all
     started together.
  3. K1 against its plain PyTorch version on the card: the cases of the
     JAX package's scatter-add tests, the main-path shape (65,536 samples x
     8 levels x 8 corners of the L8C4 lg19 grid), and the hash-grid backward
     on the card against the same backward on the CPU.
  4. gather: K2 take_rows, K3 take_lanes and K4 grid_probe at the full
     width of every TPU call site they replace (P1, P2, P2b, G, G2; P3, P3x
     x4; P4, P4b, P6), each equal to its plain version and to the PyTorch
     call for the same function (torch.equal), timed against both (plain,
     library, kernel, kernel, library, plain) beside its bound, and its
     device time under the profiler.
  5. probes: the two gather-probe entry points (laenerf_tpu_torch.perf.
     microbench_pallas and microbench_gather, --n 16), with the launch
     counts of K2-K4 set to 0 before and read after; each must launch.
  6. scatter: K5 tile_scatter and K6 worklist_scatter at the full shapes of
     rows 10-12 of PERF.md's kernel table (2,097,152 sorted updates of
     C = 8 into 2,936,936 rows: K5 f32 at 1,024-row tiles, K6 f32 at 1,024
     and bf16 at 2,048), each within rel 1e-5 of its plain version and of
     index_add_ on the unsorted updates, timed against both and against K1
     on the same unsorted updates, beside its byte bound and its device
     time under the profiler; the largest per-tile update count and the
     longest run of one row. Then K5 on a skewed input (every update of
     the heaviest tile moved onto 3 of its rows), untimed, within rel 1e-5
     of its plain version.
  7. constructs: the eight K7 constructs (perf/bisect_mosaic.py's k1-k7,
     k6b), each equal to its plain version and, for the six that have one,
     to the PyTorch call for the same function (torch.equal) on the
     script's inputs and on random ones, timed against both on the random
     ones; then k6b's kernel on a skewed input (all 1,024 columns of each
     tile on one row, small integers) equal to its plain version.
  8. probes: the four scatter entry points (microbench_scatter2,
     probe_worklist, probe_worklist2 at --n 12; bisect_mosaic), with the
     launch counts of K5-K7 set to 0 before and read after; each must
     launch, and bisect_mosaic must print eight OK lines.
  9. train: the bench configuration (L8C4 lg19, 4096-ray batches of a
     16-view 100x100 synthetic scene), mark_untrained, then 272
     Trainer.train_one_batch steps (17 occupancy refreshes, the last one
     partial). The loss must fall, the density grid's mean must halve, and
     every step must launch K1.
  10. render: one 800x800 frame with Trainer.render_image, and the
     train-view PSNR at 100x100.
  11. profile: kernel launches and device-busy share of a few train steps.
Then one JSON line with every kernel of the path, the nvidia-smi line, and
the final {"ok": true, "device": ...} line.

Imports torch and the port only, never JAX.
"""

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TRAIN_STEPS = 272
RENDER_HW = 800
REL_TOL = 1e-5  # K1 vs plain, f32: atomics sum in another order each run
SOURCES = ("scatter_add.cu", "gather_probes.cu", "sorted_scatter.cu",
           "construct_probes.cu")
# the least time of a kernel: the larger of its bytes over the memory rate
# and its operations over the peak rate (NVIDIA's H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12  # dense bf16 on the tensor cores
SECTOR = 32  # bytes: the unit in which L2 and HBM serve a random read


START = time.perf_counter()


def phase(name, msg):
    """One line of a phase, tagged with the seconds since the script
    started (the time limit covers the whole run)."""
    print(f"[{name} {time.perf_counter() - START:.1f}s] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_of(n_bytes, n_ops=0, ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by) for n_bytes moved and n_ops done at
    ops_per_s (f32 outside the tensor cores by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(fn, reps=10):
    """Device time per call of fn: the sum of its CUDA kernels' times under
    torch.profiler, without the host's launch gaps; None if the profiler
    saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / 1e3 / reps if us else None


def rel_err(got, ref):
    scale = ref.abs().max().item() + 1e-12
    return (got - ref).abs().max().item() / scale


def k1_cases(dev):
    """(name, idx int32, g f32, table_rows) on the card."""
    g = torch.Generator().manual_seed(0)

    def uniform(Q, T, C):
        return (torch.randint(0, T, (Q,), generator=g, dtype=torch.int32),
                torch.randn(Q, C, generator=g), T)

    cases = [("uniform",) + uniform(10000, 5000, 8),
             ("all_one_row", torch.full((8192,), 17, dtype=torch.int32),
              torch.ones(8192, 4), 4096)]
    clustered = 5000 + torch.randint(0, 300, (20000,), generator=g,
                                     dtype=torch.int32)
    cases.append(("clustered_empty_tiles", clustered,
                  torch.randn(20000, 8, generator=g), 40000))
    straddle = torch.cat([torch.full((2047,), 2047), torch.full((2049,), 2048),
                          torch.full((2048,), 4095)]).to(torch.int32)
    cases.append(("block_straddle", straddle, torch.ones(6144, 2), 6144))
    cases.append(("tiny_table",) + uniform(3000, 100, 8))
    oob = uniform(5000, 700, 4)
    oob[0][::97] = 700
    oob[0][7::83] = -1
    cases.append(("out_of_range_rows",) + oob)
    return [(n, i.to(dev), x.to(dev), T) for n, i, x, T in cases]


def main_path_rows(spec, dev, n_samples=65536):
    """The encoder backward's K1 input at the main-path shape: corner rows
    and bf16 rows w_c * grad_out of n_samples points."""
    from laenerf_tpu_torch.ops.hashgrid import _octo_corners

    g = torch.Generator(device=dev).manual_seed(1)
    u = torch.rand((n_samples, 3), generator=g, device=dev)
    idx, w = _octo_corners(spec, u)
    grad_out = torch.randn((n_samples, spec.num_levels, spec.level_dim),
                           generator=g, device=dev)
    rows = (w[..., None] * grad_out[:, :, None, :]).to(torch.bfloat16)
    return idx.reshape(-1), rows.reshape(-1, spec.level_dim)


def phase_k1(card, dev, model_cfg):
    from laenerf_tpu_torch.ops.hashgrid import hashgrid_encode
    from laenerf_tpu_torch.ops.scatter_add import (scatter_add_rows,
                                                   scatter_add_rows_plain)

    worst = 0.0
    for name, idx, g, T in k1_cases(dev):
        for precision in ("f32", "bf16"):
            got = scatter_add_rows(idx, g, T, precision=precision)
            ref = scatter_add_rows_plain(idx, g, T, precision=precision)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            worst = max(worst, (got - ref).abs().max().item())
            if not err < REL_TOL:
                raise AssertionError(f"K1 {name} {precision}: rel err {err}")
    empty = scatter_add_rows(torch.zeros(0, dtype=torch.int32, device=dev),
                             torch.zeros(0, 4, device=dev), 100)
    if empty.shape != (100, 4) or empty.abs().max().item() != 0.0:
        raise AssertionError("K1 Q == 0 must return zeros")
    # bf16 out: the f32 sum rounded once, so within half a bf16 ulp (2^-8
    # relative) of the plain f32 sum, up to the atomics' sum order
    idx, g, T = k1_cases(dev)[0][1:]
    bf = scatter_add_rows(idx, g, T, precision="bf16",
                          out_dtype=torch.bfloat16)
    ref = scatter_add_rows_plain(idx, g, T, precision="bf16")
    bound = ref.abs() * 2.0 ** -8 + REL_TOL * ref.abs().max()
    if bf.dtype != torch.bfloat16 or not bool(
            ((bf.float() - ref).abs() <= bound).all()):
        raise AssertionError("K1 bf16 out must be the f32 sum rounded once")
    phase("k1", f"test cases: f32 and bf16 rows within rel {REL_TOL} of "
                f"index_add_, Q == 0 and bf16-out ok")

    spec = model_cfg.grid_spec
    idx, rows = main_path_rows(spec, dev)
    T = spec.table_rows
    got = scatter_add_rows(idx, rows, T)
    ref = scatter_add_rows_plain(idx, rows, T)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    max_abs = (got - ref).abs().max().item()
    if not err < REL_TOL:
        raise AssertionError(f"K1 main-path shape: rel err {err}")

    def k1():
        scatter_add_rows(idx, rows, T)

    def plain():
        scatter_add_rows_plain(idx, rows, T)

    idx64, rows32 = idx.long(), rows.float()

    def library():
        torch.zeros((T, rows.shape[1]), device=dev).index_add_(0, idx64,
                                                               rows32)

    # in turns on one card: plain, library, kernel, kernel, library, plain
    p0, l0, k0, k1_, l1, p1 = (cuda_ms(plain), cuda_ms(library), cuda_ms(k1),
                               cuda_ms(k1), cuda_ms(library), cuda_ms(plain))
    ms, plain_ms, library_ms = (k0 + k1_) / 2, (p0 + p1) / 2, (l0 + l1) / 2
    dev_ms, dev_library_ms = device_ms(k1), device_ms(library)
    # each input read once, the [T, C] f32 output written once; one f32 add
    # per update element
    bound_ms, bound_by = bound_of(
        idx.numel() * 4 + rows.numel() * rows.element_size()
        + T * rows.shape[1] * 4, n_ops=rows.numel())
    phase("k1", f"main path: {idx.shape[0]} rows x C={rows.shape[1]} into "
                f"{T} rows, rel err {err:.2e}; K1 {ms:.4f} ms vs plain "
                f"{plain_ms:.4f} ms, index_add_ alone {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}); device time under "
                f"the profiler: K1 {dev_ms} ms, index_add_ {dev_library_ms} "
                f"ms ({card})")

    # the hash-grid backward through K1 on the card against the same
    # backward on the CPU (the plain scatter-add)
    gen = torch.Generator().manual_seed(2)
    table = torch.rand((T, spec.level_dim), generator=gen) - 0.5
    x = torch.rand((4096, 3), generator=gen) * 2.2 - 1.1
    cot = torch.randn((4096, spec.output_dim), generator=gen)
    grads = []
    for d in (dev, torch.device("cpu")):
        tt = table.to(d).requires_grad_(True)
        (hashgrid_encode(tt, x.to(d), spec) * cot.to(d)).sum().backward()
        grads.append(tt.grad.cpu())
    err_bwd = rel_err(grads[0], grads[1])
    if not err_bwd < REL_TOL:
        raise AssertionError(f"hash-grid backward card vs CPU: {err_bwd}")
    phase("k1", f"hash-grid backward on the card vs CPU: rel err "
                f"{err_bwd:.2e}")
    return {"max_abs_err": max(worst, max_abs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms,
            "library_device_ms": dev_library_ms}


def gather_sites(dev):
    """(site, kernel, TPU kernel it replaces, args, kwargs, queries) at the
    full width of every call site of rows 1-8 of PERF.md's kernel table."""
    from laenerf_tpu_torch.ops.gather import grid_probe, take_lanes, take_rows

    g = torch.Generator(device=dev).manual_seed(5)
    f32, i32, i8 = torch.float32, torch.int32, torch.int8

    def ri(high, shape, dtype=i32):
        return torch.randint(0, high, shape, generator=g, device=dev,
                             dtype=dtype)

    def table(shape, dtype, high=2):
        if dtype == f32:
            return torch.randn(shape, generator=g, device=dev)
        return ri(high, shape, dtype)

    mp, mg = "perf/microbench_pallas.py", "perf/microbench_gather.py"
    sites = []
    for site, dtype, Q, tpu in (("P1", f32, 4096, f"{mp}:77"),
                                ("P2", i8, 4096, f"{mp}:99"),
                                ("P2b", i32, 4096, f"{mp}:77"),
                                ("G", f32, 8192, f"{mg}:174"),
                                ("G2", f32, 8192, f"{mg}:200")):
        sites.append((site, take_rows, tpu,
                      (table((4096, 128), dtype), ri(4096, (Q, 128))), {},
                      Q * 128))
    sites.append(("P3", take_lanes, f"{mp}:138",
                  (table((4096, 128), f32), ri(128, (4096, 128))), {},
                  4096 * 128))
    for rows, lanes in ((8, 262144), (16, 131072), (64, 32768),
                        (128, 16384)):
        sites.append((f"P3x[{rows}x{lanes}]", take_lanes, f"{mp}:230",
                      (table((rows, lanes), i8, 8), ri(lanes, (1, 16384))),
                      {}, 16384))
    for site, dtype in (("P4", i32), ("P4b", i8)):
        sites.append((site, grid_probe, f"{mp}:167",
                      (table((16384, 128), dtype), ri(16384, (16384,)),
                       ri(128, (16384,))), {"lanes": 128}, 16384))
    sites.append(("P6", grid_probe, f"{mp}:261",
                  (table((8, 262144), i8, 8), ri(8, (16384,)),
                   ri(262144, (16384,))), {"out_dtype": i32}, 16384))
    return sites


def gather_library_and_cells(kernel, args, kw):
    """The one PyTorch call that computes the kernel's function on the same
    inputs (int64 indices, made once), and the flat table element each
    output reads."""
    tbl = args[0]
    if kernel.__name__ == "take_rows":
        rows = args[1].long()
        W = tbl.shape[1]
        return (lambda: torch.gather(tbl, 0, rows),
                rows * W + torch.arange(W, device=tbl.device))
    if kernel.__name__ == "take_lanes":
        R, L = tbl.shape
        idx = args[1].long().expand(R, -1)
        return (lambda: torch.gather(tbl, 1, idx),
                torch.arange(R, device=tbl.device)[:, None] * L + idx)
    lanes = kw.get("lanes", 1)
    row = args[1].long()[:, None].expand(-1, lanes)
    col = args[2].long()[:, None].expand(-1, lanes)
    # advanced indexing gives the grid's dtype: P6's cast to int32 is left
    # out of the library call
    return lambda: tbl[row, col], row * tbl.shape[1] + col


def phase_gather(card, dev):
    from laenerf_tpu_torch.ops import gather

    plains = {gather.take_rows: gather.take_rows_plain,
              gather.take_lanes: gather.take_lanes_plain,
              gather.grid_probe: gather.grid_probe_plain}
    results = []
    for site, kernel, tpu, args, kw, queries in gather_sites(dev):
        got = kernel(*args, **kw)
        ref = plains[kernel](*args, **kw)
        library, cells = gather_library_and_cells(kernel, args, kw)
        lib = library()
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(
                got, lib.to(got.dtype).reshape(got.shape))):
            raise AssertionError(f"{kernel.__name__} {site}: differs from "
                                 f"its plain version or the library call")
        max_abs = (got.double() - ref.double()).abs().max().item()
        # bytes that must move: every index and output byte once, and the
        # table's distinct 32-byte sectors that this run's indices touch
        tbl = args[0]
        sectors = torch.unique(cells.reshape(-1) * tbl.element_size()
                               // SECTOR).numel()
        n_bytes = (sum(a.numel() * a.element_size() for a in args[1:])
                   + got.numel() * got.element_size()
                   + min(sectors * SECTOR, tbl.numel() * tbl.element_size()))
        bound_ms, bound_by = bound_of(n_bytes)

        def run():
            kernel(*args, **kw)

        def plain():
            plains[kernel](*args, **kw)

        # in turns on one card: plain, library, kernel, kernel, library, plain
        t = [cuda_ms(f) for f in (plain, library, run, run, library, plain)]
        ms, library_ms, plain_ms = ((t[2] + t[3]) / 2, (t[1] + t[4]) / 2,
                                    (t[0] + t[5]) / 2)
        dev_ms, dev_library_ms = device_ms(run), device_ms(library)
        results.append({"site": site, "kernel": kernel.__name__,
                        "replaces": tpu, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": n_bytes,
                        "device_ms": dev_ms,
                        "library_device_ms": dev_library_ms,
                        "max_abs_err": max_abs})
        phase("gather", f"{kernel.__name__} {site} ({tpu}): equal to plain "
                        f"and library; {ms:.4f} ms ({1e6 * ms / queries:.4f} "
                        f"ns/query) vs library {library_ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                        f"({n_bytes} B, {bound_by}); device time under the "
                        f"profiler: kernel {dev_ms} ms, library "
                        f"{dev_library_ms} ms ({card})")
    return results


def phase_probes(card):
    """The gather-probe entry points, as a user runs them, on the card."""
    from laenerf_tpu_torch.ops.gather import grid_probe, take_lanes, take_rows
    from laenerf_tpu_torch.perf import microbench_gather, microbench_pallas

    kernels = (take_rows, take_lanes, grid_probe)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    rows = {**microbench_pallas.main(["--n", "16"]),
            **microbench_gather.main(["--n", "16"])}
    launches = {k.__name__: k.launches for k in kernels}
    bad = [label for label, sec in rows.items()
           if not (math.isfinite(sec) and sec > 0)]
    if bad:
        raise AssertionError(f"probe rows without a time: {bad}")
    if not all(launches.values()):
        raise AssertionError(f"a gather kernel did not launch on the probe "
                             f"path: {launches}")
    phase("probes", f"{len(rows)} probe rows in "
                    f"{time.perf_counter() - t0:.1f} s; launches {launches} "
                    f"({card})")
    return launches


def tensor_bytes(args):
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


def longest_run(qs):
    """The most updates of one row in a row of sorted rows."""
    if not qs.numel():
        return 0
    return int(torch.unique_consecutive(qs, return_counts=True)[1].max())


def k5_skewed(idx, g, tile, n_tiles):
    """K5 on idx with every update of the heaviest tile moved onto 3 of
    its rows (first, middle, last, by update number), against its plain
    version; returns the longest run and the heavy tile's count."""
    from laenerf_tpu_torch.ops.sorted_scatter import (sort_stage,
                                                      tile_scatter,
                                                      tile_scatter_plain)

    tile_of = idx // tile
    heavy = int(torch.bincount(tile_of.long(), minlength=n_tiles).argmax())
    mine = tile_of == heavy
    q = torch.arange(idx.shape[0], device=idx.device, dtype=idx.dtype)
    three = torch.tensor([0, tile // 2, tile - 1], device=idx.device,
                         dtype=idx.dtype)
    skewed = torch.where(mine, heavy * tile + three[q % 3], idx)
    qs, gs, lo = sort_stage(skewed, g, tile, n_tiles)
    got, ref = tile_scatter(qs, gs, lo, tile), tile_scatter_plain(qs, gs, lo,
                                                                  tile)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    if not err < REL_TOL:
        raise AssertionError(f"K5 skewed (heaviest tile on 3 rows): rel err "
                             f"{err}")
    return longest_run(qs), int(mine.sum()), err


def phase_scatter(card, dev):
    """K5 and K6 at the full shapes of rows 10-12 of the kernel table."""
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.ops.sorted_scatter import (
        build_worklist, sort_stage, tile_scatter,
        tile_scatter_plain, work_sizes, worklist_scatter,
        worklist_scatter_plain)
    from laenerf_tpu_torch.perf.scatter_inputs import (FULL, FULL_2048,
                                                       make_inputs)

    t0 = time.perf_counter()
    idx_np, g_np = make_inputs(FULL)
    idx = torch.from_numpy(idx_np).to(dev)
    g = torch.from_numpy(g_np).to(dev)
    idx64 = idx.long()
    Q, C = g.shape
    phase("scatter", f"inputs: {Q} updates of C={C} into {FULL.T} rows "
                     f"(perf/scatter_inputs.py) in "
                     f"{time.perf_counter() - t0:.1f} s")
    results = []
    for site, kernel, shape, dtype, tpu in (
            ("row 10 K5 f32 tile 1024", tile_scatter, FULL, torch.float32,
             "perf/microbench_scatter2.py:137"),
            ("row 11 K6 f32 tile 1024", worklist_scatter, FULL,
             torch.float32, "perf/probe_worklist.py:71"),
            ("row 12 K6 bf16 tile 2048", worklist_scatter, FULL_2048,
             torch.bfloat16, "perf/probe_worklist2.py:71")):
        tile, maxu = shape.tile, shape.maxu
        sizes = work_sizes(Q, shape.T, tile, maxu)
        rows = g.to(dtype)
        qs, gs, lo = sort_stage(idx, rows, tile, sizes.n_tiles)
        if kernel is tile_scatter:
            args, plain = (qs, gs, lo, tile), tile_scatter_plain
        else:
            wt, wb, _, wreal = build_worklist(lo, maxu, sizes.w_cap,
                                              sizes.q_blks)
            args = (qs, gs, wt, wb, wreal, tile, maxu, sizes.n_tiles)
            plain = worklist_scatter_plain
        rows32 = rows.float()
        precision = "f32" if dtype == torch.float32 else "bf16"

        def run():
            return kernel(*args)

        def plain_run():
            return plain(*args)

        def library():
            return torch.zeros((sizes.t_pad, C), device=dev).index_add_(
                0, idx64, rows32)

        def k1():
            return scatter_add_rows(idx, rows, sizes.t_pad,
                                    precision=precision)

        got, ref, lib, k1_out = run(), plain_run(), library(), k1()
        torch.cuda.synchronize()
        errs = {"plain": rel_err(got, ref), "index_add_": rel_err(got, lib),
                "K1 vs index_add_": rel_err(k1_out, lib)}
        if not all(e < REL_TOL for e in errs.values()):
            raise AssertionError(f"{site}: rel errs {errs}")
        max_abs = (got - ref).abs().max().item()
        cnt = lo[1:] - lo[:-1]
        n_bytes = tensor_bytes(args) + got.numel() * got.element_size()
        # one f32 add per update element
        bound_ms, bound_by = bound_of(n_bytes, n_ops=Q * C)
        # in turns on one card
        t = [cuda_ms(f) for f in (plain_run, library, k1, run, run, k1,
                                  library, plain_run)]
        ms, k1_ms = (t[3] + t[4]) / 2, (t[2] + t[5]) / 2
        library_ms, plain_ms = (t[1] + t[6]) / 2, (t[0] + t[7]) / 2
        dev_t = {name: device_ms(f) for name, f in
                 (("kernel", run), ("library", library), ("k1", k1))}
        results.append({"site": site, "kernel": kernel.__name__,
                        "replaces": tpu, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "k1_ms": k1_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": n_bytes, "device_ms": dev_t["kernel"],
                        "library_device_ms": dev_t["library"],
                        "k1_device_ms": dev_t["k1"], "max_abs_err": max_abs})
        phase("scatter", f"{site} ({tpu}): {kernel.__name__} rel err "
                         f"{errs['plain']:.2e} vs plain, "
                         f"{errs['index_add_']:.2e} vs index_add_ of the "
                         f"unsorted updates; {sizes.n_tiles} tiles, largest "
                         f"{int(cnt.max())} updates, {int((cnt == 0).sum())} "
                         f"empty, longest run {longest_run(qs)}; "
                         f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                         f"index_add_ {library_ms:.4f} ms, K1 on the unsorted "
                         f"updates {k1_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({n_bytes} B, {bound_by}); device time under the "
                         f"profiler: kernel {dev_t['kernel']} ms, index_add_ "
                         f"{dev_t['library']} ms, K1 {dev_t['k1']} ms "
                         f"({card})")
        if kernel is tile_scatter:
            run_len, n_heavy, err = k5_skewed(idx, rows, tile, sizes.n_tiles)
            phase("scatter", f"{site} skewed: the heaviest tile's {n_heavy} "
                             f"updates on 3 of its rows (longest run "
                             f"{run_len}): rel err {err:.2e} vs plain")
    return results


def construct_library(fn, args):
    """The one PyTorch call that computes a K7 construct's function on the
    same inputs (index tensors and the kept one-hot rows made once, views
    free), or None where no single call does: k5's loop (a clamp, then a
    repeat) and k7's iota (an arange, then a repeat; it has no input). Where
    the construct casts int32 to f32 (k1, k4), the cast is left out."""
    from laenerf_tpu_torch.ops import construct_probes as cp

    name = fn.__name__
    if name == "prefetch_write":
        lo, n, tile, C = args
        lo_rows = lo[:n, None].expand(n, C)
        return lambda: torch.repeat_interleave(lo_rows, tile, dim=0)
    if name == "static_copy":
        g, n, tile = args
        head = g[:tile]
        return lambda: head.repeat(n, 1)
    if name in ("dynamic_copy", "copy_1d"):
        src, lo, n, tile = args[:4]
        rows = (lo[:n].long()[:, None]
                + torch.arange(tile, device=src.device)).reshape(-1)
        if name == "dynamic_copy":
            return lambda: torch.index_select(src, 0, rows)
        cells = rows[:, None].expand(-1, args[4])
        return lambda: torch.take(src, cells)
    if name == "onehot_dot":
        local, g, tile = args
        n, _, C = g.shape
        loc = local.long()
        keep = (loc >= 0) & (loc < tile)
        rows = (loc + torch.arange(n, device=g.device)[:, None] * tile)[keep]
        vals = g[keep].float()
        return lambda: torch.zeros((n * tile, C), device=g.device).index_add_(
            0, rows, vals)
    if fn in (cp.dynamic_loop, cp.iota_rows):
        return None
    raise ValueError(f"no library rule for {name}")


def phase_constructs(card, dev):
    """K7: every construct equal to its plain version and to its library
    call, where it has one, on the script's inputs and on random ones;
    timed on the random ones."""
    from laenerf_tpu_torch.ops.construct_probes import PLAIN, onehot_dot
    from laenerf_tpu_torch.perf import bisect_mosaic

    results = []
    for seed in (None, 7):
        for label, tpu, fn, args in bisect_mosaic.cases(dev, seed):
            got, ref = fn(*args), PLAIN[fn](*args)
            library = construct_library(fn, args)
            lib = library() if library else None
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K7 {label} (seed {seed}) differs "
                                     f"from its plain version")
            if lib is not None and not torch.equal(
                    got, lib.to(got.dtype).reshape(got.shape)):
                raise AssertionError(f"K7 {label} (seed {seed}) differs "
                                     f"from its library call")
            if seed is None:
                continue
            n_bytes = tensor_bytes(args) + got.numel() * got.element_size()
            n_ops, dense = 0, 0
            if fn is onehot_dot:
                # the product's terms that this run's one-hot holds, and
                # the dense [tile, maxu] @ [maxu, C] product beside them
                local, g, tile = args
                n_ops = 2 * int(((local >= 0) & (local < tile)).sum()) \
                    * g.shape[2]
                dense = 2 * local.shape[0] * tile * local.shape[1] \
                    * g.shape[2]
            bound_ms, bound_by = bound_of(n_bytes, n_ops, BF16_TC_OPS_PER_S)

            def run():
                fn(*args)

            def plain():
                PLAIN[fn](*args)

            # in turns on one card: plain, library, kernel, kernel,
            # library, plain (no library turns where there is none)
            t = [cuda_ms(f) if f else None
                 for f in (plain, library, run, run, library, plain)]
            ms, plain_ms = (t[2] + t[3]) / 2, (t[0] + t[5]) / 2
            library_ms = (t[1] + t[4]) / 2 if library else None
            dev_ms = device_ms(run)
            dev_library_ms = device_ms(library) if library else None
            results.append({"site": label, "kernel": fn.__name__,
                            "replaces": tpu, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "bytes": n_bytes,
                            "device_ms": dev_ms,
                            "library_device_ms": dev_library_ms,
                            "max_abs_err": 0.0})
            extra = (f", dense product {dense / 1e9:.2f} GFLOP = "
                     f"{1e3 * dense / BF16_TC_OPS_PER_S:.4f} ms at the bf16 "
                     f"tensor-core peak" if dense else "")
            lib_msg = (f"library {library_ms:.4f} ms" if library else
                       "no single library call")
            equal = "plain and library" if library else "plain"
            phase("constructs", f"{label} ({tpu}): equal to {equal} on the "
                                f"script's and random inputs; {ms:.4f} ms "
                                f"vs plain "
                                f"{plain_ms:.4f} ms, {lib_msg}, bound "
                                f"{bound_ms:.5f} ms ({n_bytes} B, {n_ops} "
                                f"ops, {bound_by}){extra}; device time "
                                f"under the profiler: kernel {dev_ms} ms, "
                                f"library {dev_library_ms} ms ({card})")

    # k6b skewed, a check only: all 1,024 columns of each tile on one row
    # (one window of each tile holds every column), small integer rows
    n_tiles, tile, maxu, C = (bisect_mosaic.N_TILES, bisect_mosaic.TILE,
                              bisect_mosaic.MAXU, 128)
    gen = torch.Generator(device=dev).manual_seed(8)
    local = (torch.arange(n_tiles, device=dev, dtype=torch.int32)[:, None]
             * 146 % tile).expand(-1, maxu).contiguous()
    g = torch.randint(-8, 9, (n_tiles, maxu, C), generator=gen,
                      device=dev).bfloat16()
    if not torch.equal(onehot_dot(local, g, tile),
                       PLAIN[onehot_dot](local, g, tile)):
        raise AssertionError("K7 k6b skewed (every column of a tile on one "
                             "row) differs from its plain version")
    phase("constructs", f"k6b skewed: {n_tiles} tiles x {maxu} columns, "
                        f"each tile on one row, C={C}: equal to plain")
    return results


def phase_scatter_probes(card):
    """The four scatter entry points, as a user runs them, on the card."""
    from laenerf_tpu_torch.ops.construct_probes import PLAIN
    from laenerf_tpu_torch.ops.sorted_scatter import (tile_scatter,
                                                      worklist_scatter)
    from laenerf_tpu_torch.perf import (bisect_mosaic, microbench_scatter2,
                                        probe_worklist, probe_worklist2)

    constructs = tuple(PLAIN)
    for k in (tile_scatter, worklist_scatter) + constructs:
        k.launches = 0
    t0 = time.perf_counter()
    rows = [script.main(["--n", "12"]) for script in
            (microbench_scatter2, probe_worklist, probe_worklist2)]
    bisect = bisect_mosaic.main(["--n", "16"])
    launches = {k.__name__: k.launches for k in
                (tile_scatter, worklist_scatter) + constructs}
    bad = [label for r in rows for label, sec in r.items()
           if not (math.isfinite(sec) and sec > 0)]
    if bad:
        raise AssertionError(f"probe rows without a time: {bad}")
    if not all(bisect.values()):
        raise AssertionError(f"bisect_mosaic: a construct failed {bisect}")
    if not all(launches.values()):
        raise AssertionError(f"a scatter or construct kernel did not launch "
                             f"on the probe path: {launches}")
    phase("probes", f"{sum(map(len, rows))} scatter probe rows and "
                    f"{len(bisect)} OK constructs in "
                    f"{time.perf_counter() - t0:.1f} s; launches {launches} "
                    f"({card})")
    return launches


def kernel_entry(name, source, results, launches):
    """One kernel's line entry: times and bounds summed over its call
    sites (one call at each), every site listed."""
    mine = [r for r in results if r["kernel"] == name]
    by_kind = {}
    for r in mine:
        by_kind[r["bound_by"]] = by_kind.get(r["bound_by"], 0.0) \
            + r["bound_ms"]
    libs = [r["library_ms"] for r in mine]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": ", ".join(dict.fromkeys(r["replaces"] for r in mine)),
        "launches": launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": sum(r["ms"] for r in mine),
        "plain_ms": sum(r["plain_ms"] for r in mine),
        "bound_ms": sum(by_kind.values()),
        "bound_by": max(by_kind, key=by_kind.get),
        "library_ms": None if None in libs else sum(libs),
        "sites": [{k: r.get(k) for k in (
            "site", "replaces", "ms", "plain_ms", "library_ms", "k1_ms",
            "bound_ms", "device_ms", "library_device_ms", "k1_device_ms")
            if k in r} for r in mine],
    }


def phase_train(card, dev, tmp):
    from laenerf_tpu_torch.data import NeRFDataset, generate_synthetic_scene
    from laenerf_tpu_torch.models import NeRFConfig, RenderConfig
    from laenerf_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    generate_synthetic_scene(tmp, n_train=16, n_val=1, n_test=4, H=100,
                             W=100, device=dev)
    ds = NeRFDataset(tmp, "train", num_rays=4096)
    phase("train", f"synthetic scene: {len(ds)} views {ds.H}x{ds.W} in "
                   f"{time.perf_counter() - t0:.1f} s")
    model_cfg = NeRFConfig(bound=1.0, num_levels=8, level_dim=4,
                           log2_hashmap_size=19)
    render_cfg = RenderConfig(bound=1.0, cascades=1, grid_size=128,
                              max_steps=256, march_iters=256,
                              m_cap_per_ray=16, density_thresh=10.0,
                              infer_chunk_events=16, infer_compact_factor=4)
    tr = Trainer(model_cfg, render_cfg, device=dev, lr=1e-2, iters=2000,
                 eval_chunk=16384)
    tr.mark_untrained(ds)
    losses, step_s, density = [], [], []
    for step in range(TRAIN_STEPS):
        s0 = time.perf_counter()
        aux = tr.train_one_batch(ds.get_batch(step % len(ds)),
                                 has_alpha=True)
        losses.append(float(aux["loss"]))  # syncs the step
        step_s.append(time.perf_counter() - s0)
        if step % tr.update_interval == 0:
            density.append(float(tr.occ_state.mean_density))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite training loss")
    # What the JAX reference does over these steps (16-view 100^2 scene,
    # L8C4, 1024 rays on the CPU, three seeds): the loss falls by 15-20%
    # but does not halve (it plateaus until the grid starts pruning, at
    # step 700 to past 1000, by seed), and the density grid's mean falls
    # from 0.75 after the first refresh to 0.35 by step 256 in every seed.
    first, last = float(np.mean(losses[:16])), float(np.mean(losses[-16:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    if not density[-1] <= 0.5 * density[0]:
        raise AssertionError(f"density grid mean did not halve: "
                             f"{density[0]} -> {density[-1]}")
    occ_frac = float(tr.occ_state.occupancy.float().mean())
    phase("train", f"{TRAIN_STEPS} steps, {tr.occ_state.iter_density} "
                   f"occupancy refreshes: loss {first:.5f} -> {last:.5f} "
                   f"(first/last 16 steps), grid mean density "
                   f"{density[0]:.4f} -> {density[-1]:.4f}, occ_frac "
                   f"{occ_frac:.4f}; {1e3 * np.mean(step_s):.1f} ms/step "
                   f"mean, {1e3 * np.median(step_s[16:]):.1f} ms/step median "
                   f"after 16 ({card})")
    return tr, ds


def phase_render(card, tr, ds):
    H = W = RENDER_HW
    intr = ds.intrinsics * (H / ds.H)
    intr[2], intr[3] = W / 2, H / 2
    s0 = time.perf_counter()
    img, depth = tr.render_image(ds.poses[0], intr, H, W)
    dt = time.perf_counter() - s0  # render_image returns host arrays
    if img.shape != (H, W, 3) or depth.shape != (H, W):
        raise AssertionError(f"bad render shapes {img.shape} {depth.shape}")
    n_bad = int((~np.isfinite(img)).sum())
    lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
    # the composite's weights sum to 1 - T only up to f32 rounding, so a
    # saturated color (sigmoid == 1.0 in f32) composites to 1 + a few ulp
    if n_bad or lo < 0.0 or hi > 1.0 + 1e-5:
        raise AssertionError(f"render: {n_bad} non-finite values, range "
                             f"[{lo!r}, {hi!r}]")
    phase("render", f"{H}x{W} frame: {1e3 * dt:.1f} ms/frame, "
                    f"{H * W / dt:.0f} rays/s (first frame), values in "
                    f"[{lo:.6f}, {hi:.8f}] ({card})")
    s0 = time.perf_counter()
    tr.render_image(ds.poses[1], intr, H, W)
    dt = time.perf_counter() - s0
    phase("render", f"{H}x{W} frame: {1e3 * dt:.1f} ms/frame, "
                    f"{H * W / dt:.0f} rays/s (second frame) ({card})")
    small, _ = tr.render_image(ds.poses[0], ds.intrinsics, ds.H, ds.W)
    gt = ds.images[0]
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    psnr = -10.0 * math.log10(max(float(np.mean((small - gt) ** 2)), 1e-10))
    if not math.isfinite(psnr):
        raise AssertionError("train-view PSNR is not finite")
    phase("render", f"train-view PSNR at {ds.H}x{ds.W}: {psnr:.2f} dB")


def phase_profile(tr, ds, steps=4):
    from torch.profiler import ProfilerActivity, profile

    batches = [ds.get_batch(i % len(ds)) for i in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        for b in batches:
            tr.train_one_batch(b, has_alpha=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3  # us -> ms
    if not kernels:
        phase("profile", "device time not measured (no CUDA events)")
        return
    phase("profile", f"{steps} train steps: {len(kernels) / steps:.0f} "
                     f"device kernels per step, device busy "
                     f"{busy / steps:.1f} ms of {1e3 * wall / steps:.1f} ms "
                     f"wall per step ({100 * busy / (1e3 * wall):.1f}%, "
                     f"under the profiler)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    from laenerf_tpu_torch.models import NeRFConfig
    from laenerf_tpu_torch.ops import cuda_build
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows

    dev = torch.device("cuda", 0)
    card = card_line()
    phase("device", f"{torch.cuda.get_device_name(0)}, torch "
                    f"{torch.__version__}, CUDA {torch.version.cuda}; "
                    f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(cuda_build.load_library, SOURCES))
    for src in SOURCES:
        info = cuda_build.build_info[src]
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "Used" in ln]
        spills = sum(map(int, re.findall(r"(\d+) bytes spill stores",
                                         info["ptxas"])))
        phase("build", f"{src} built in {info['seconds']:.1f} s (nvcc "
                       f"sm_90a); ptxas: {' | '.join(regs) or 'cached'}; "
                       f"spill stores {spills} B")
    phase("build", f"all sources in {time.perf_counter() - t0:.1f} s")

    model_cfg = NeRFConfig(bound=1.0, num_levels=8, level_dim=4,
                           log2_hashmap_size=19)
    k1 = phase_k1(card, dev, model_cfg)
    gather_results = phase_gather(card, dev)
    gather_launches = phase_probes(card)
    scatter_results = phase_scatter(card, dev)
    construct_results = phase_constructs(card, dev)
    scatter_launches = phase_scatter_probes(card)

    with tempfile.TemporaryDirectory() as tmp:
        scatter_add_rows.launches = 0
        tr, ds = phase_train(card, dev, tmp)
        train_launches = scatter_add_rows.launches
        if train_launches < TRAIN_STEPS:
            raise AssertionError(f"K1 launched {train_launches} times in "
                                 f"{TRAIN_STEPS} train steps")
        phase_render(card, tr, ds)
        launches = scatter_add_rows.launches
        phase("train", f"K1 launches on the main path: {launches}")
        phase_profile(tr, ds)

    gather_src = "laenerf_tpu_torch/csrc/gather_probes.cu"
    scatter_src = "laenerf_tpu_torch/csrc/sorted_scatter.cu"
    print(json.dumps({"kernels": [{
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "laenerf_tpu_torch/csrc/scatter_add.cu",
        "replaces": "laenerf_tpu/ops/scatter_add.py:46",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }] + [kernel_entry(name, gather_src, gather_results, gather_launches)
          for name in ("take_rows", "take_lanes", "grid_probe")]
        + [kernel_entry(name, scatter_src, scatter_results, scatter_launches)
           for name in ("tile_scatter", "worklist_scatter")]
        + [kernel_entry(name, "laenerf_tpu_torch/csrc/construct_probes.cu",
                        construct_results, scatter_launches)
           for name in dict.fromkeys(r["kernel"]
                                     for r in construct_results)]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
