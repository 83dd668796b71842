"""The probes of the JAX package's perf/microbench_gather.py, in PyTorch and
on the port's kernels.

    python -m laenerf_tpu_torch.perf.microbench_gather [--n 16] [--device cuda]
        [--big 1048576]

  A    plain row gather tbl[idx] of B rows of a [2^19, 8] f32 table
  B    the same on sorted indices (PyTorch has no indices_are_sorted flag,
       so B is the same call as B2)
  B2   the same on sorted indices (locality only)
  C    torch.argsort of B indices
  D    index_add_ of B*8 scalars into a fresh [2^19 * 8] f32 vector
  E    the same with sorted unique indices (no flags in PyTorch)
  F    the same with sorted duplicate indices (no flags in PyTorch)
  G    take_rows (K2): [B/128, 128] rows of a [4096, 128] f32 table
  G2   the TPU probe's 2048-row query blocks are a VMEM residency choice
       that the card does not have: the same K2 call as G
  H0   plain gather from a small [4096, 8] table
  H    one-hot product gather from the small table by torch.matmul in bf16,
       in blocks of 32,768 queries

ns/query divides by B throughout, as the JAX script does.
"""

import torch

from laenerf_tpu_torch.ops.gather import take_rows
from laenerf_tpu_torch.perf import (device_line, generator, make_parser,
                                    randint, report, shifted, time_calls)

T_ROWS = 1 << 19  # table rows (the big hash level)
C = 8  # channels per row
B = 1 << 20  # queries


def probe_row_gather(T=T_ROWS, C=C, B=B, sort=False, n=16, device="cuda"):
    """A (unsorted), B and B2 (sorted): tbl[idx] of a [T, C] f32 table."""
    gen = generator(device, 1)
    tbl = torch.randn((T, C), generator=gen, device=device)
    idx = randint(T, (B,), gen, device, torch.int64)
    if sort:
        idx = torch.sort(idx).values
    sets = shifted(idx, T, n)
    return time_calls(lambda k: tbl[sets[k]], n, device)


def probe_argsort(T=T_ROWS, B=B, n=16, device="cuda"):
    """C: torch.argsort of B indices."""
    gen = generator(device, 1)
    sets = shifted(randint(T, (B,), gen, device, torch.int64), T, n)
    return time_calls(lambda k: torch.argsort(sets[k]), n, device)


def probe_scatter(kind, T=T_ROWS, C=C, B=B, n=16, device="cuda"):
    """D ("flat"), E ("unique"), F ("sorted"): index_add_ of f32 scalars
    into a fresh [T * C] vector."""
    gen = generator(device, 1)
    idx = randint(T, (B,), gen, device, torch.int64)
    flat = (idx[:, None] * C + torch.arange(C, device=device)).reshape(-1)
    vals = torch.randn((B * C,), generator=gen, device=device)
    if kind == "unique":
        nu = min(T * C, B)
        flat = torch.arange(nu, device=device) * max(1, (T * C) // nu)
        vals = vals[:nu]
    elif kind == "sorted":
        flat = torch.sort(flat).values
    elif kind != "flat":
        raise ValueError(f"probe_scatter: unknown kind {kind!r}")
    return time_calls(
        lambda k: torch.zeros((T * C,), device=device).index_add_(
            0, flat, vals), n, device)


def probe_take_rows(T=T_ROWS, B=B, n=16, device="cuda"):
    """G, G2: K2 with [B/128, 128] rows of a [T/128, 128] f32 table."""
    R, Q = T // 128, B // 128
    gen = generator(device, 3)
    tbl = torch.randn((R, 128), generator=gen, device=device)
    sets = shifted(randint(R, (Q, 128), gen, device), R, n)
    return time_calls(lambda k: take_rows(tbl, sets[k]), n, device)


def probe_small_gather(Ts=4096, C=C, B=B, n=16, device="cuda"):
    """H0: tbl[idx] of a small [Ts, C] f32 table."""
    gen = generator(device, 0)
    tbl = torch.randn((Ts, C), generator=gen, device=device)
    sets = shifted(randint(Ts, (B,), gen, device, torch.int64), Ts, n)
    return time_calls(lambda k: tbl[sets[k]], n, device)


def probe_onehot(Ts=4096, C=C, B=B, block=1 << 15, n=16, device="cuda"):
    """H: the small-table gather as a bf16 one-hot [block, Ts] @ [Ts, C]
    product per block of queries."""
    gen = generator(device, 0)
    tbl = torch.randn((Ts, C), generator=gen, device=device).bfloat16()
    sets = shifted(randint(Ts, (B,), gen, device, torch.int64), Ts, n)
    block = min(block, B)

    def call(k):
        for s in range(0, B, block):
            sl = sets[k][s:s + block]
            oh = torch.zeros((sl.shape[0], Ts), dtype=torch.bfloat16,
                             device=device).scatter_(1, sl[:, None], 1.0)
            torch.matmul(oh, tbl)

    return time_calls(call, n, device)


def main(argv=None):
    parser = make_parser("Probes of perf/microbench_gather.py in PyTorch "
                         "and on the port's kernels.")
    parser.add_argument("--big", type=int, default=B, help="query count")
    args = parser.parse_args(argv)
    res = {}
    n, dev, Bq = args.n, torch.device(args.device), args.big
    print(f"{device_line(dev)}  T={T_ROWS} C={C} B={Bq}", flush=True)
    report(res, "A plain row gather [B,C] (PyTorch tbl[idx])",
           probe_row_gather(T_ROWS, C, Bq, False, n, dev), Bq)
    report(res, "B sorted gather (PyTorch has no indices_are_sorted; = B2)",
           probe_row_gather(T_ROWS, C, Bq, True, n, dev), Bq)
    report(res, "B2 sorted gather (no flag; locality)",
           probe_row_gather(T_ROWS, C, Bq, True, n, dev), Bq)
    report(res, "C argsort [B] (torch.argsort)",
           probe_argsort(T_ROWS, Bq, n, dev), Bq)
    report(res, "D flat scalar scatter-add (index_add_)",
           probe_scatter("flat", T_ROWS, C, Bq, n, dev), Bq)
    report(res, "E scatter sorted+unique (index_add_, no flags)",
           probe_scatter("unique", T_ROWS, C, Bq, n, dev), Bq)
    report(res, "F scatter sorted dup (index_add_, no flags)",
           probe_scatter("sorted", T_ROWS, C, Bq, n, dev), Bq)
    R, Q = T_ROWS // 128, Bq // 128
    report(res, f"G take_along_axis [{Q}x128 of {R}x128] (K2 take_rows)",
           probe_take_rows(T_ROWS, Bq, n, dev), Bq)
    report(res, "G2 blocked (no VMEM blocks on the card: = G, K2 take_rows)",
           probe_take_rows(T_ROWS, Bq, n, dev), Bq)
    report(res, "H0 small-table (4k) plain gather (PyTorch tbl[idx])",
           probe_small_gather(4096, C, Bq, n, dev), Bq)
    report(res, "H one-hot matmul gather (4k table, torch.matmul bf16)",
           probe_onehot(4096, C, Bq, 1 << 15, n, dev), Bq)
    print("done", flush=True)
    return res


if __name__ == "__main__":
    main()
