"""The construct bisection of the JAX package's perf/bisect_mosaic.py, on the
port's kernel K7.

    python -m laenerf_tpu_torch.perf.bisect_mosaic [--n 16] [--device cuda]

The JAX script ran one Pallas construct per kernel (k1 ... k7, k6b) on 8
tiles of 1,024 rows, C = 8, to find the one the TPU compiler refused. Here
each construct is its Hopper counterpart (laenerf_tpu_torch/ops/
construct_probes.py); each prints one line, OK when the kernel's output
equals its plain version exactly (torch.equal), with its ms per call over n
calls, or FAIL with the reason. The inputs are the script's own (k1 writes
lo = 0..8, k2-k4 copy rows of ones, k5 loops 3 times, k6 multiplies an
identity one-hot by 2.0); `cases(device, seed)` also makes random ones
(offsets anywhere in range, random rows, a random one-hot with dropped
columns), which the tests and chip_smoke.py use. Exits non-zero, after
every line, if any construct fails.
"""

import sys

import numpy as np
import torch

from laenerf_tpu_torch.ops.construct_probes import (PLAIN, copy_1d,
                                                    dynamic_copy,
                                                    dynamic_loop, iota_rows,
                                                    onehot_dot,
                                                    prefetch_write,
                                                    static_copy)
from laenerf_tpu_torch.perf import device_line, make_parser, time_calls

TILE = MAXU = 1024
C = 8
N_TILES = 8
Q = 4096


def cases(device="cuda", seed=None):
    """(label, TPU kernel's line, wrapper, args) of the eight constructs:
    the script's inputs when seed is None, else random ones from
    np.random.RandomState(seed)."""
    dev = torch.device(device)
    n, R = N_TILES, Q + MAXU

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16
    if seed is None:
        lo_write = np.arange(n + 1)
        g = np.ones((R, C))
        lo_rows = lo_q = np.zeros(n + 1)
        q = np.ones(R)
        lo_trip = np.full(n + 1, 3)
        local = np.tile(np.arange(MAXU), (n, 1))
        g6 = np.full((n, MAXU, C), 2.0)
        g6b = np.full((n, MAXU, 128), 2.0)
    else:
        rng = np.random.RandomState(seed)
        lo_write = rng.randint(-1000, 1000, n + 1)
        g = rng.randn(R, C)
        lo_rows = rng.randint(0, R - TILE + 1, n + 1)
        q = rng.randint(-2 ** 31, 2 ** 31 - 1, R)
        lo_q = rng.randint(0, R - TILE + 1, n + 1)
        lo_trip = rng.randint(-5, 200, n + 1)
        # a one-hot with at most one column per row, so the product's sums
        # are exact; a tenth of the columns point outside the tile
        local = np.stack([rng.permutation(TILE)[:MAXU] for _ in range(n)])
        drop = rng.rand(n, MAXU) < 0.1
        local[drop] = rng.choice([-1, TILE, 5000], int(drop.sum()))
        g6 = rng.randn(n, MAXU, C)
        g6b = rng.randn(n, MAXU, 128)
    mp = "perf/bisect_mosaic.py"
    return [
        ("k1 prefetch+write", f"{mp}:28", prefetch_write,
         (t(lo_write, i32), n, TILE, C)),
        ("k2 +static DMA 2d", f"{mp}:46", static_copy,
         (t(g, f32), n, TILE)),
        ("k3 +dynamic DMA offset", f"{mp}:70", dynamic_copy,
         (t(g, f32), t(lo_rows, i32), n, TILE)),
        ("k4 +1D int scratch DMA", f"{mp}:97", copy_1d,
         (t(q, i32), t(lo_q, i32), n, TILE, C)),
        ("k5 dynamic fori_loop", f"{mp}:124", dynamic_loop,
         (t(lo_trip, i32), n, TILE, C)),
        ("k6 onehot+dot C=8", f"{mp}:149", onehot_dot,
         (t(local, i32), t(g6, bf16), TILE)),
        ("k6b onehot+dot C=128", f"{mp}:170", onehot_dot,
         (t(local, i32), t(g6b, bf16), TILE)),
        ("k7 1D iota", f"{mp}:190", iota_rows, (n, TILE, C, dev)),
    ]


def main(argv=None):
    args = make_parser("Construct bisection of perf/bisect_mosaic.py on the "
                       "port's kernel K7.").parse_args(argv)
    dev = torch.device(args.device)
    print(device_line(dev), flush=True)
    results = {}
    for label, _, fn, fargs in cases(dev):
        try:
            ok = torch.equal(fn(*fargs), PLAIN[fn](*fargs))
            msg = "OK" if ok else "FAIL (differs from its plain version)"
            if ok:
                sec = time_calls(lambda k: fn(*fargs), args.n, dev)
                msg += f" {sec * 1e3:9.4f} ms/call"
        except Exception as e:  # noqa: BLE001 - a FAIL line, as in the script
            ok, msg = False, f"FAIL {type(e).__name__}: {str(e)[:100]}"
        print(f"{label:44s} {msg}", flush=True)
        results[label] = ok
    print("bisect done", flush=True)
    return results


if __name__ == "__main__":
    sys.exit(0 if all(main().values()) else 1)
