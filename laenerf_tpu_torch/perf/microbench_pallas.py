"""The gather probes of the JAX package's perf/microbench_pallas.py, on the
port's kernels.

    python -m laenerf_tpu_torch.perf.microbench_pallas [--n 16] [--device cuda]

  P1   take_rows (K2), f32 [4096, 128] table, [4096, 128] rows
  P2   same, int8 table (occupancy-grid style)
  P2b  same, int32 table
  P3   take_lanes (K3), per-row lane select, f32 [4096, 128]
  P4   grid_probe (K4): one occupancy probe per ray for 16,384 rays of a
       [16384, 128] int32 grid, written into 128 lanes as the TPU probe does
  P4b  same, int8 grid
  P5   PyTorch baseline for P4: the flat byte gather grid_flat[idx]
  P3x  take_lanes (K3) on wide int8 tables, one index row broadcast over
       the table's rows (16,384 rays)
  P6   grid_probe (K4): the two-step march probe, tbl[row[q], lane[q]] of an
       [8, 262144] int8 table into one int32 lane

On the TPU these were take_along_axis shapes that Mosaic could lower; on the
card each is one launch of the kernel named.
"""

import torch

from laenerf_tpu_torch.ops.gather import grid_probe, take_lanes, take_rows
from laenerf_tpu_torch.perf import (device_line, generator, make_parser,
                                    randint, report, shifted, time_calls)

LANES = 128


def _table(shape, dtype, gen, device, high=2):
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device=device)
    return randint(high, shape, gen, device, dtype)


def probe_take_rows(R=4096, dtype=torch.float32, n=16, device="cuda"):
    """P1 (f32), P2 (int8), P2b (int32): K2, [R, 128] table and rows."""
    gen = generator(device, 0)
    tbl = _table((R, LANES), dtype, gen, device)
    sets = shifted(randint(R, (R, LANES), gen, device), R, n)
    return time_calls(lambda k: take_rows(tbl, sets[k]), n, device)


def probe_take_lanes(R=4096, n=16, device="cuda"):
    """P3: K3 with a full [R, 128] lane index on an f32 [R, 128] table."""
    gen = generator(device, 2)
    tbl = _table((R, LANES), torch.float32, gen, device)
    sets = shifted(randint(LANES, (R, LANES), gen, device), LANES, n)
    return time_calls(lambda k: take_lanes(tbl, sets[k]), n, device)


def probe_march(H=128, dtype=torch.int32, n=16, device="cuda"):
    """P4 (int32), P4b (int8): K4, H*H rays each probing one cell of an
    [H*H, H] grid, the value written into H lanes."""
    NR = H * H
    gen = generator(device, 3)
    grid = _table((NR, H), dtype, gen, device)
    z = randint(H, (NR,), gen, device)
    sets = shifted(randint(NR, (NR,), gen, device), NR, n)
    return time_calls(lambda k: grid_probe(grid, sets[k], z, lanes=H), n,
                      device)


def probe_flat_byte(H=128, n=16, device="cuda"):
    """P5: the PyTorch baseline for P4, one byte per ray from the flat grid
    (advanced indexing, int64 indices)."""
    NR = H * H
    gen = generator(device, 3)
    grid_flat = randint(2, (NR * H,), gen, device, torch.uint8)
    flat = (randint(NR, (NR,), gen, device, torch.int64) * H
            + randint(H, (NR,), gen, device, torch.int64))
    sets = shifted(flat, NR * H, n)
    return time_calls(lambda k: grid_flat[sets[k]], n, device)


def probe_wide_lanes(rows, lanes, nray=16384, n=16, device="cuda"):
    """P3x: K3 on an int8 [rows, lanes] table with one [1, nray] index row
    broadcast over the rows."""
    gen = generator(device, 7)
    tbl = _table((rows, lanes), torch.int8, gen, device, high=8)
    sets = shifted(randint(lanes, (1, nray), gen, device), lanes, n)
    return time_calls(lambda k: take_lanes(tbl, sets[k]), n, device)


def probe_two_step(R8=8, L8=262144, nray=16384, n=16, device="cuda"):
    """P6: K4, out[q] = tbl[row[q], lane[q]] of an int8 [R8, L8] table into
    one int32 lane per ray."""
    gen = generator(device, 8)
    tbl = _table((R8, L8), torch.int8, gen, device, high=8)
    row = randint(R8, (nray,), gen, device)
    sets = shifted(randint(L8, (nray,), gen, device), L8, n)
    return time_calls(lambda k: grid_probe(tbl, row, sets[k],
                                           out_dtype=torch.int32), n, device)


WIDE_SHAPES = ((8, 262144), (16, 131072), (64, 32768), (128, 16384))


def main(argv=None):
    args = make_parser("Gather probes of perf/microbench_pallas.py on the "
                       "port's kernels.").parse_args(argv)
    res = {}
    n, dev = args.n, torch.device(args.device)
    print(device_line(dev), flush=True)
    R, H = 4096, 128
    report(res, f"P1 dyn_gather ax0 f32 [{R}x128] (K2 take_rows)",
           probe_take_rows(R, torch.float32, n, dev), R * LANES)
    report(res, "P2 dyn_gather ax0 int8 (K2 take_rows)",
           probe_take_rows(R, torch.int8, n, dev), R * LANES)
    report(res, "P2b dyn_gather ax0 int32 (K2 take_rows)",
           probe_take_rows(R, torch.int32, n, dev), R * LANES)
    report(res, "P3 dyn_gather ax1 f32 (K3 take_lanes)",
           probe_take_lanes(R, n, dev), R * LANES)
    report(res, "P4 occupancy probe i32 (16k rays) (K4 grid_probe)",
           probe_march(H, torch.int32, n, dev), H * H)
    report(res, "P4b occupancy probe i8 (K4 grid_probe)",
           probe_march(H, torch.int8, n, dev), H * H)
    report(res, "P5 PyTorch flat byte gather grid_flat[idx] (16k rays)",
           probe_flat_byte(H, n, dev), H * H)
    print("done", flush=True)
    for rows, lanes in WIDE_SHAPES:
        report(res, f"P3x wide-lane gather [{rows}x{lanes}] i8 (16k rays) "
                    f"(K3 take_lanes)",
               probe_wide_lanes(rows, lanes, 16384, n, dev), 16384)
    report(res, "P6 two-step march probe [8x262144] (16k rays) "
                "(K4 grid_probe)",
           probe_two_step(8, 262144, 16384, n, dev), 16384)
    print("wide-lane probes done", flush=True)
    return res


if __name__ == "__main__":
    main()
