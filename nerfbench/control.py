"""Readings that set a cell's limits, on the card at the cell's own size:
the program against the reference over many seeds (the lower readings),
and, on the first few, the control (the reference in float8 in the
program's place) and the planted faults against the reference (the
upper readings). No measured window: the checked steps only. Where the
cell's mix fixes its start (`start_seed`), each seed here takes its
place, so that the readings cover many starts.

    python -m nerfbench.control --workload <cell> --seeds 11,12,... \\
        [--control-seeds 3] [--out readings.jsonl]

One JSON line per seed. The benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import sys
import time

import torch

from . import compare
from .run import load_spec


def readings(workload, seeds, n_control, device="cuda", spec=None,
             leaves=False):
    """Yield one dict per seed: the program's readings, the reference's
    seconds and, for the first n_control seeds, the control's and the
    faults' readings; with leaves, each leaf's gaps."""
    spec = spec or load_spec(workload)
    drv = importlib.import_module(
        f"nerfbench.drivers.{spec['traffic']['kind']}")
    for k, seed in enumerate(seeds):
        traffic = dict(spec["traffic"])
        if "start_seed" in traffic:
            traffic["start_seed"] = seed
        run = drv.Run(spec["config"], traffic, seed, device)
        run.checked_steps()
        run.free()
        t0 = time.perf_counter()
        prog, err = run.program_readings()
        line = {"workload": workload, "seed": seed, "program": prog,
                "error": err, "reference_s": time.perf_counter() - t0,
                "program_losses": run.prog["losses"]}
        if leaves:
            out, start = run.reference()
            line["leaves"] = compare.leaf_readings(run.prog, out, start)
            line["reference_losses"] = out["losses"]
        if k < n_control:
            line.update(drv.control_readings(run))
        yield line
        del run
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    p.add_argument("--leaves", action="store_true",
                   help="add each leaf's gaps and reference norms")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        for line in readings(args.workload, seeds, args.control_seeds,
                             leaves=args.leaves):
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
