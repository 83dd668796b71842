"""The scatter-add prototypes of the JAX package's perf/microbench_scatter2.py,
on the port's kernels.

    python -m laenerf_tpu_torch.perf.microbench_scatter2 [--n 12]
        [--device cuda] [--small]

Q = 2,097,152 update rows of C = 8 (65,536 samples x 32 level-corner rows,
perf/scatter_inputs.py) into T = 2,936,936 rows:

  S0   index_add_ of the Q * C flat scalars into a fresh [T * C] vector (the
       XLA scatter's counterpart)
       the sort stage alone: torch.sort, index_select, searchsorted
  S1   sort stage + tile_scatter (K5), 1,024-row tiles; the JAX script pads
       qs and gs by one DMA slab, which the card does not need
  S2   sort stage + the padded-tile einsum in plain PyTorch, in 256-tile
       chunks: each tile reads at most 2,048 updates of its slab, so tiles
       holding more drop the rest, and the script prints how many
  then S1 against S0 (max abs and relative error; fails above rel 1e-5).

Each call gets one of two index sets, idx and (idx + 1) mod T. ns/scalar
divides by Q * C, as the JAX script does. `--small` runs probe_worklist.py's
--small shapes (256-row tiles, S2 reading at most 512 updates a tile).
"""

import torch

from laenerf_tpu_torch.ops.sorted_scatter import (sort_stage, tile_scatter,
                                                  work_sizes)
from laenerf_tpu_torch.perf import (device_line, make_parser, report,
                                    shifted, time_calls)
from laenerf_tpu_torch.perf.scatter_inputs import FULL, SMALL, make_inputs

REL_TOL = 1e-5  # K5 against index_add_: f32 sums in another order


def flat_scatter(flat, vals, size: int):
    """S0: index_add_ of scalars into a fresh [size] f32 vector."""
    return torch.zeros((size,), device=vals.device).index_add_(0, flat, vals)


def flat_index(idx, C: int):
    """The flat scalar index idx * C + c, int64 (S0's flat_idx)."""
    return (idx.long()[:, None] * C
            + torch.arange(C, device=idx.device)).reshape(-1)


def padded_tile_einsum(qs, gs, lo, tile: int, maxu: int = 2048,
                       chunk: int = 256):
    """S2: per tile, the first maxu updates of its slab as a one-hot
    [maxu, tile] f32 product with their rows, chunk tiles at a time;
    updates past a tile's first maxu are dropped."""
    n_tiles = lo.shape[0] - 1
    Q, C = gs.shape
    dev = gs.device
    qs_p = torch.cat([qs, torch.full((maxu,), -1, dtype=qs.dtype,
                                     device=dev)])
    gs_p = torch.cat([gs.float(), torch.zeros((maxu, C), device=dev)])
    m = torch.arange(maxu, device=dev)
    r = torch.arange(tile, device=dev)
    lo = lo.long()
    out = []
    for c0 in range(0, n_tiles, chunk):
        tks = torch.arange(c0, min(c0 + chunk, n_tiles), device=dev)
        slots = lo[tks][:, None] + m
        ok = slots < lo[tks + 1][:, None]
        slots = slots.clamp(max=Q + maxu - 1)
        local = torch.where(ok, qs_p[slots] - tks[:, None] * tile, -1)
        onehot = (local[..., None] == r).float()  # [chunk, maxu, tile]
        out.append(torch.einsum("kmr,kmc->krc", onehot, gs_p[slots]))
    return torch.cat(out).reshape(n_tiles * tile, C)


def dropped_updates(lo, maxu: int = 2048) -> int:
    """Updates that S2 drops: those past the first maxu of each slab."""
    cnt = (lo[1:] - lo[:-1]).long()
    return int((cnt - maxu).clamp(min=0).sum())


def main(argv=None):
    parser = make_parser("Scatter-add prototypes of "
                         "perf/microbench_scatter2.py on the port's kernels.")
    parser.set_defaults(n=12)
    parser.add_argument("--small", action="store_true",
                        help="probe_worklist.py's --small shapes")
    args = parser.parse_args(argv)
    shape = SMALL if args.small else FULL
    n, dev = args.n, torch.device(args.device)
    C, T, Q, tile = 8, shape.T, shape.Q, shape.tile
    s2_maxu = 2 * shape.maxu
    sizes = work_sizes(Q, T, tile, shape.maxu)
    idx_np, g_np = make_inputs(shape, C)
    sets = shifted(torch.from_numpy(idx_np).to(dev), T, 2)
    g = torch.from_numpy(g_np).to(dev)
    flats = [flat_index(i, C) for i in sets]
    vals = g.reshape(-1)
    res = {}
    print(f"{device_line(dev)}  Q={Q} C={C} T={T}", flush=True)

    report(res, "S0 direct flat scalar scatter-add (index_add_)",
           time_calls(lambda k: flat_scatter(flats[k % 2], vals, T * C), n,
                      dev), Q * C, "scalar")
    report(res, "  (sort+reorder+bounds stage alone)",
           time_calls(lambda k: sort_stage(sets[k % 2], g, tile,
                                           sizes.n_tiles), n, dev),
           Q * C, "scalar")

    def s1(k):
        return tile_scatter(*sort_stage(sets[k % 2], g, tile, sizes.n_tiles),
                            tile)

    report(res, f"S1 tile scatter K5 (TILE={tile})", time_calls(s1, n, dev),
           Q * C, "scalar")

    def s2(k):
        qs, gs, lo = sort_stage(sets[k % 2], g, tile, sizes.n_tiles)
        return padded_tile_einsum(qs, gs, lo, tile, s2_maxu)

    report(res, f"S2 padded-tile einsum, plain PyTorch (MAXU={s2_maxu})",
           time_calls(s2, n, dev), Q * C, "scalar")
    lo = sort_stage(sets[0], g, tile, sizes.n_tiles)[2]
    cnt = lo[1:] - lo[:-1]
    print(f"S2 drops {dropped_updates(lo, s2_maxu)} of {Q} updates "
          f"({int((cnt > s2_maxu).sum())} of {sizes.n_tiles} tiles hold more "
          f"than {s2_maxu}; the largest holds {int(cnt.max())})", flush=True)

    ref = flat_scatter(flats[0], vals, T * C).reshape(T, C)
    got = s1(0)[:T]
    err = (got - ref).abs().max().item()
    rel = err / (ref.abs().max().item() + 1e-9)
    print(f"S1 vs S0 max abs err: {err:.3e} (rel {rel:.3e})", flush=True)
    if not rel < REL_TOL:
        raise AssertionError(f"S1 differs from S0: rel err {rel} >= "
                             f"{REL_TOL}")
    print("done", flush=True)
    return res


if __name__ == "__main__":
    main()
