"""The work-list scatter-add probe of the JAX package's perf/probe_worklist.py,
on the port's kernel K6.

    python -m laenerf_tpu_torch.perf.probe_worklist [--n 12] [--device cuda]
        [--small]

The updates of perf/scatter_inputs.py (f32 rows, 1,024-row tiles, 1,024-update
blocks; perf/probe_worklist2.py runs bf16 rows at 2,048):

  correctness   the work-list scatter against the XLA scatter's counterpart
                (index_add_ of flat scalars into [T_PAD * C], f32 rows);
                fails above rel 1e-5 (f32 rows) or 1.5e-2 (bf16 rows)
  XLA scatter   that index_add_
  work-list     sort + build_worklist + worklist_scatter (K6)
  sort+reorder, argsort, take g f32, take g bf16: the sort stage's parts

Call i runs on idx + (i mod 2), as the JAX script's timeit does (rows stay
below T_PAD). ns/scalar divides by Q * C.
"""

import torch

from laenerf_tpu_torch.ops.sorted_scatter import (build_worklist, sort_stage,
                                                  worklist_scatter,
                                                  work_sizes)
from laenerf_tpu_torch.perf import (device_line, make_parser, report,
                                    time_calls)
from laenerf_tpu_torch.perf.microbench_scatter2 import flat_index, flat_scatter
from laenerf_tpu_torch.perf.scatter_inputs import FULL, SMALL, make_inputs

TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1.5e-2}


def worklist_pipeline(idx, g, sizes, tile: int, maxu: int,
                      dtype=torch.float32):
    """scatter_pallas (probe_worklist.py:113-142): g's rows cast to dtype,
    sort, the work list, then K6. The script pads the sorted updates to
    whole blocks for its block specs; K6 stops a block at Q instead."""
    qs, gs, lo = sort_stage(idx, g.to(dtype), tile, sizes.n_tiles)
    wt, wb, _, wreal = build_worklist(lo, maxu, sizes.w_cap, sizes.q_blks)
    return worklist_scatter(qs, gs, wt, wb, wreal, tile, maxu, sizes.n_tiles)


def main(argv=None, full=FULL, dtype=torch.float32,
         script="perf/probe_worklist.py"):
    parser = make_parser(f"Work-list scatter-add probe of {script} on the "
                         f"port's kernel K6.")
    parser.set_defaults(n=12)
    parser.add_argument("--small", action="store_true",
                        help="the JAX script's --small shapes")
    args = parser.parse_args(argv)
    shape = SMALL if args.small else full
    n, dev = args.n, torch.device(args.device)
    C, T, Q = 8, shape.T, shape.Q
    tile, maxu = shape.tile, shape.maxu
    sizes = work_sizes(Q, T, tile, maxu)
    idx_np, g_np = make_inputs(shape, C)
    idx = torch.from_numpy(idx_np).to(dev)
    sets = [idx, idx + 1]
    g = torch.from_numpy(g_np).to(dev)
    vals = g.reshape(-1)
    flats = [flat_index(i, C) for i in sets]
    res = {}
    print(f"{device_line(dev)}  Q={Q} T={T} N_TILES={sizes.n_tiles} "
          f"W_CAP={sizes.w_cap} TILE={tile} MAXU={maxu} rows={dtype}",
          flush=True)

    ref = flat_scatter(flats[0], vals, sizes.t_pad * C).reshape(-1, C)
    got = worklist_pipeline(idx, g, sizes, tile, maxu, dtype)
    err = (got - ref).abs().max().item()
    rel = err / (ref.abs().max().item() + 1e-9)
    print(f"correctness: max abs err {err:.3e} (rel {rel:.3e})", flush=True)
    if not rel < TOLERANCE[dtype]:
        raise AssertionError(f"work-list scatter differs from the XLA "
                             f"scatter's counterpart: rel err {rel}")

    def row(label, fn):
        report(res, label, time_calls(fn, n, dev), Q * C, "scalar")

    row("XLA scatter (index_add_)",
        lambda k: flat_scatter(flats[k % 2], vals, sizes.t_pad * C))
    row("work-list scatter (sort + worklist + K6)",
        lambda k: worklist_pipeline(sets[k % 2], g, sizes, tile, maxu,
                                    dtype))

    def sort_reorder(k):
        qs, order = torch.sort(sets[k % 2], stable=True)
        return qs, g.index_select(0, order)

    row("  sort+reorder only", sort_reorder)
    row("  argsort only", lambda k: torch.argsort(sets[k % 2], stable=True))
    row("  take g f32 only", lambda k: g[sets[k % 2] % Q])
    row("  take g bf16 only", lambda k: g.bfloat16()[sets[k % 2] % Q])
    print("done", flush=True)
    return res


if __name__ == "__main__":
    main()
