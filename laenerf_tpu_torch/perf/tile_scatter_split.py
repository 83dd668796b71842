"""Where K5 tile_scatter's time goes: the probe's updates cut three ways.

    python -m laenerf_tpu_torch.perf.tile_scatter_split [--n 12]
        [--device cuda] [--small]

The updates of perf/microbench_scatter2.py's S1 (perf/scatter_inputs.py,
1,024-row tiles) go through K5 as three inputs, each sorted anew by
sort_stage:

  all      every update
  heaviest only the updates of the tile that holds the most; every other
           slab is empty
  light    every update except those of the tiles holding more than four
           tiles' worth of rows (4 * tile updates)

The updates themselves are filtered, not lo alone, so no block walks a
neighbour's updates. Each row prints the updates and tiles it keeps, ms per
call on CUDA events and, on the card, the device time per call under
torch.profiler, split by kernel name. If `heaviest` comes close to `all`,
one tile sets the time; `light` against `all` gives what the rest costs.
Each output is checked against tile_scatter_plain at rel 1e-5.
`--device cpu` runs the plain version on the host clock.
"""

import torch

from laenerf_tpu_torch.ops.sorted_scatter import (sort_stage, tile_scatter,
                                                  tile_scatter_plain,
                                                  work_sizes)
from laenerf_tpu_torch.perf import device_line, make_parser, time_calls
from laenerf_tpu_torch.perf.scatter_inputs import FULL, SMALL, make_inputs

REL_TOL = 1e-5  # f32 sums in another order
HEAVY_TILES = 4  # a tile is heavy above this many tiles' worth of updates


def subsets(idx, tile: int, n_tiles: int):
    """{label: boolean mask over the updates} for the three inputs."""
    tile_of = idx.long() // tile
    cnt = torch.bincount(tile_of, minlength=n_tiles)
    return {"all": torch.ones_like(tile_of, dtype=torch.bool),
            "heaviest": tile_of == int(cnt.argmax()),
            "light": cnt[tile_of] <= HEAVY_TILES * tile}


def device_us(fn, reps: int = 10):
    """{kernel name: device µs per call of fn} under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.device_time / reps
    return out


def main(argv=None):
    parser = make_parser("K5 tile_scatter on all, the heaviest tile's and "
                         "the light tiles' updates of the S1 probe.")
    parser.set_defaults(n=12)
    parser.add_argument("--small", action="store_true",
                        help="probe_worklist.py's --small shapes")
    args = parser.parse_args(argv)
    shape = SMALL if args.small else FULL
    dev = torch.device(args.device)
    tile = shape.tile
    n_tiles = work_sizes(shape.Q, shape.T, tile, shape.maxu).n_tiles
    idx_np, g_np = make_inputs(shape)
    idx = torch.from_numpy(idx_np).to(dev)
    g = torch.from_numpy(g_np).to(dev)
    print(f"{device_line(dev)}  Q={shape.Q} C={g.shape[1]} T={shape.T} "
          f"tile={tile}", flush=True)
    res = {}
    for label, keep in subsets(idx, tile, n_tiles).items():
        qs, gs, lo = sort_stage(idx[keep], g[keep], tile, n_tiles)
        cnt = lo[1:] - lo[:-1]
        ref = tile_scatter_plain(qs, gs, lo, tile)
        got = tile_scatter(qs, gs, lo, tile)
        rel = ((got - ref).abs().max() / (ref.abs().max() + 1e-12)).item()
        if not rel < REL_TOL:
            raise AssertionError(f"{label}: K5 differs from its plain "
                                 f"version, rel err {rel}")
        sec = time_calls(lambda k: tile_scatter(qs, gs, lo, tile), args.n,
                         dev)
        res[label] = sec
        dev_us = (device_us(lambda: tile_scatter(qs, gs, lo, tile))
                  if dev.type == "cuda" else None)
        dev_msg = ("device time not measured (host clock)" if dev_us is None
                   else f"device {sum(dev_us.values()):.2f} us/call "
                        f"{ {k: round(v, 2) for k, v in dev_us.items()} }")
        print(f"{label:9s} {qs.shape[0]:8d} updates in "
              f"{int((cnt > 0).sum()):5d} tiles (largest {int(cnt.max())}); "
              f"{sec * 1e3:9.4f} ms/call; {dev_msg}; rel err {rel:.2e}",
              flush=True)
    print("done", flush=True)
    return res


if __name__ == "__main__":
    main()
