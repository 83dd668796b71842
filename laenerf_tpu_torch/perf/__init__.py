"""Microbenchmark entry points of the port, one module per probe script of
the JAX package's perf/ directory:

    python -m laenerf_tpu_torch.perf.microbench_pallas [--n 16] [--device cuda]
    python -m laenerf_tpu_torch.perf.microbench_gather [--n 16] [--device cuda]
    python -m laenerf_tpu_torch.perf.microbench_scatter2 [--n 12] [--small]
    python -m laenerf_tpu_torch.perf.probe_worklist [--n 12] [--small]
    python -m laenerf_tpu_torch.perf.probe_worklist2 [--n 12] [--small]
    python -m laenerf_tpu_torch.perf.bisect_mosaic [--n 16] [--device cuda]
    python -m laenerf_tpu_torch.perf.tile_scatter_split [--n 12] [--small]
    python -m laenerf_tpu_torch.perf.phase_turns --phase gather ROOT ...

Each prints the card's nvidia-smi line, then one row per probe under the JAX
script's label: ms per call and ns per query (per scalar for the scatters);
bisect_mosaic prints one OK or FAIL line per construct, and
tile_scatter_split one row per cut of the S1 probe's updates (it has no JAX
script); phase_turns runs a chip_smoke.py phase of several checkouts in
turns and prints their device times side by side. On the card a probe
is timed with CUDA events around n back-to-back calls after one warm call;
each call gets its own index set, the first one shifted by the call number
modulo the table size (the scatter probes alternate two sets, idx and
idx + 1; the JAX scripts shift by an accumulator to defeat constant
folding).
`--device cpu` runs the same probes on the host clock, through the kernels'
plain versions: a CPU number is never a device number.

Importing a module here runs nothing; each probe is a function of its sizes,
with the JAX script's full widths as defaults.
"""

import argparse
import subprocess
import time

import torch


def make_parser(description):
    """The options every probe script takes: --n and --device."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--n", type=int, default=16,
                   help="timed calls per probe (after one warm call)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    return p


def device_line(device) -> str:
    """The card's `name, power.limit` as nvidia-smi gives them, or a note
    that the numbers are host numbers."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"device={device.type} (host clock, plain versions; not a " \
               f"device measurement)"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return f"device={torch.cuda.get_device_name(index)}; nvidia-smi: " \
           f"{out.stdout.strip()}"


def generator(device, seed):
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def randint(high, shape, gen, device, dtype=torch.int32):
    return torch.randint(0, high, shape, generator=gen, device=device,
                         dtype=dtype)


def shifted(idx, size: int, n: int):
    """n index sets: idx + k modulo size for call k."""
    return [torch.remainder(idx + k, size) for k in range(n)]


def time_calls(fn, n: int, device) -> float:
    """Seconds per call of fn(k), k = 0..n-1, after a warm fn(0)."""
    device = torch.device(device)
    fn(0)
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for k in range(n):
                fn(k)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for k in range(n):
        fn(k)
    return (time.perf_counter() - t0) / n


def report(results: dict, label: str, seconds: float, n_queries: int,
           unit: str = "query"):
    """Print one row and keep its seconds per call in results[label]."""
    print(f"{label:60s} {seconds * 1e3:9.4f} ms/call "
          f"({seconds / n_queries * 1e9:8.4f} ns/{unit})", flush=True)
    results[label] = seconds
