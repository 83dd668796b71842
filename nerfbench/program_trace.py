"""Read the program's own tracer in one cell, on the card: the per-layer
readers of program_readers.py over a window recorded with the tracer on,
what tracing costs (windows with the tracer off and on, in turns), the
cross-checks of the program's counters against the harness's view, and
the audit of the host's waits under `torch.cuda.set_sync_debug_mode`.

    python3 -m nerfbench.program_trace --workload ngp_train --seed 7 \\
        --seconds 51 --out chiprun_out/program_ngp_train.json

Set-up is run.py's: the cell's driver builds the program and runs its
checked steps. Then, in this order: the traced window (--seconds, tracer
on, profiler off); the cost of a span and a count in a loop; TURNS pairs
of windows of TURN_SECONDS, the tracer off and on in the order off, on,
on, off, ...; in a NeRF cell CHECK_STEPS steps with both the harness's
spans (as with --trace 1) and the tracer on, one recording a step; then
AUDIT_STEPS steps under the sync debug mode, one recording a step (a NeRF
cell first moves the occupancy refresh to its partial path, so that the
audit meets both refreshes' waits). The last line of standard output is
the summary (JSON); --out gets everything. The benchmark's runs never
call this.
"""

import os

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402

from . import harness, run  # noqa: E402
from .probe import Spans, patched  # noqa: E402
from .program_readers import EDIT_ROOT, READERS, phase_ms  # noqa: E402

PHASES = ("laenerf.forward", "laenerf.loss", "laenerf.backward",
          "laenerf.optimizer")
TURNS, TURN_SECONDS, CHECK_STEPS, AUDIT_STEPS = 4, 6.0, 8, 20


def traced_window(r, seconds, timers):
    """One window with the tracer on; the record the readers take."""
    harness.sync()
    timers.start()
    calls, elapsed, work, _ = harness.window(r.window_step, seconds)
    prog = timers.stop()
    steps = calls * r.traffic.get("chunk_steps", 1)
    return {"window_s": elapsed, "window_steps": steps, "window_work": work,
            "program": prog}


def tracer_turns(r, n, seconds, timers):
    """Rates of windows with the tracer off and on, in turns."""
    out = {"off": [], "on": []}
    for i in range(2 * n):
        on = (i % 4) in (1, 2)
        harness.sync()
        if on:
            timers.start()
        calls, elapsed, work, _ = harness.window(r.window_step, seconds)
        if on:
            timers.stop()
        out["on" if on else "off"].append(work / elapsed)
    med_off, med_on = (statistics.median(out[k]) for k in ("off", "on"))
    out["cost_pct"] = 100.0 * (med_off - med_on) / med_off
    return out


def k1_rows_check(r, spec, n, timers):
    """Per step: the program's render.samples x levels x 8 beside the rows
    of the K1 call the harness's span saw."""
    spans = r.spans
    per_row = spec["config"]["num_levels"] * 8
    rows = []
    with contextlib.ExitStack() as stack:
        for mod, attr, make in r.trace_patches():
            stack.enter_context(patched(mod, attr, make))
        spans.on = True
        for _ in range(n):
            timers.start()
            r.step()
            prog = timers.stop()
            rows.append([prog["counters"]["render.samples"] * per_row,
                         spans.meta["k1"][-1]["rows"]])
        spans.on = False
    return {"steps": rows, "equal": all(a == b for a, b in rows)}


def edit_time_check(rec):
    """The four phases' means plus the root's self time against the
    window's host seconds a step."""
    prog = rec["program"]
    roots = [s for s in prog["spans"] if s["name"] == EDIT_ROOT
             and s["parent"] is None and s["end"] is not None]
    root_ms = statistics.fmean(s["end"] - s["start"] for s in roots) / 1e6
    phases = {p: phase_ms(rec, p, EDIT_ROOT) for p in PHASES}
    self_ms = root_ms - sum(phases.values())
    step_ms = 1e3 * rec["window_s"] / rec["window_steps"]
    return {"phases_ms": phases, "root_self_ms": self_ms,
            "root_ms": root_ms, "window_step_ms": step_ms,
            "gap_pct": 100.0 * (step_ms - root_ms) / step_ms}


def span_cost(timers, n=200_000):
    """Host µs of one span entered and left (no attributes) with the
    tracer on and off, and of one count with it on, from loops of n."""
    def loop(body):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t0) / n * 1e6

    def one_span():
        with timers.span("cost"):
            pass

    empty = loop(lambda: None)
    off = loop(one_span) - empty
    timers.start()
    on = loop(one_span) - empty
    count = loop(lambda: timers.count("cost")) - empty
    timers.stop()
    return {"span_on_us": on, "span_off_us": off, "count_on_us": count}


def overhead_estimate(rec, cost):
    """The traced window's spans and counts a step at the loops' cost, as
    a share of its host time a step. The counts are bounded from above:
    each wait as one call, each other counter as one call a step."""
    prog = rec["program"]
    steps = rec["window_steps"]
    spans = len(prog["spans"]) / steps
    calls = sum(v if k.startswith("sync.") else steps
                for k, v in prog["counters"].items()) / steps
    us = spans * cost["span_on_us"] + calls * cost["count_on_us"]
    return {"spans_a_step": spans, "count_calls_a_step": calls,
            "pct": 100.0 * us / (1e6 * rec["window_s"] / steps)}


def _site():
    frames = traceback.extract_stack()[:-2]
    prog = [f for f in frames if "laenerf_tpu_torch" in f.filename]
    f = (prog or frames)[-1]
    return f"{os.path.relpath(f.filename)}:{f.lineno}"


SYNC_WARNING = "called a synchronizing CUDA operation"


def _flag(flagged, other):
    """A showwarning that keeps the site of each of the sync debug mode's
    warnings and the text of any other warning."""
    def show(message, *a, **k):
        if SYNC_WARNING in str(message):
            flagged.append(_site())
        else:
            other.add(str(message)[:200])
    return show


def audit(step, n, timers, torch):
    """Per step: the waits the sync debug mode flagged beside the program's
    sync.* counters; the flagged sites over all steps."""
    per_step, sites, other = [], {}, set()
    for _ in range(n):
        flagged = []
        harness.sync()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            shown = warnings.showwarning
            warnings.showwarning = _flag(flagged, other)
            timers.start()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
                prog = timers.stop()
                warnings.showwarning = shown
        counted = {k: v for k, v in prog["counters"].items()
                   if k.startswith("sync.")}
        per_step.append([len(flagged), sum(counted.values()), counted])
        for s in flagged:
            sites[s] = sites.get(s, 0) + 1
    return {"steps": per_step,
            "equal": all(a == b for a, b, _ in per_step),
            "sites": sorted(sites.items(), key=lambda kv: -kv[1]),
            "other_warnings": sorted(other)}


def measure(spec, seed, seconds, device="cuda", turns=TURNS,
            turn_seconds=TURN_SECONDS, check_steps=CHECK_STEPS,
            audit_steps=AUDIT_STEPS):
    """Everything but the device check; returns the full record. No audit
    where audit_steps is 0 (the sync debug mode needs a card)."""
    import torch

    from laenerf_tpu_torch.utils import timers

    r = run.load_driver(spec).Run(spec["config"], spec["traffic"], seed,
                                  device, Spans())
    r.checked_steps()
    harness.sync()
    out = {"workload": spec["cell"]["name"], "seed": seed}
    rec = traced_window(r, seconds, timers)
    out["metrics"] = {}
    for name, read in READERS.items():
        v = read(rec)
        if v is not None:
            out["metrics"][name] = v
    out["window"] = {k: rec[k] for k in ("window_s", "window_steps",
                                         "window_work")}
    out["counters"] = rec["program"]["counters"]
    out["span_cost"] = span_cost(timers)
    out["overhead_estimate"] = overhead_estimate(rec, out["span_cost"])
    nerf = spec["traffic"]["kind"] == "nerf_train"
    if not nerf:
        out["edit_time_check"] = edit_time_check(rec)
    out["turns"] = tracer_turns(r, turns, turn_seconds, timers)
    if nerf:
        out["k1_rows_check"] = k1_rows_check(r, spec, check_steps, timers)
        occ = r.tr.occ_state
        occ.iter_density = max(occ.iter_density, 16)
        step = r.step
    else:
        def step():
            r.run_steps(1)
    if audit_steps:
        out["audit"] = audit(step, audit_steps, timers, torch)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(harness.CACHE / sub)
    spec = run.load_spec(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("nerfbench: needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(spec, args.seed, args.seconds)
    out["device"] = {"kind": torch.cuda.get_device_name(0),
                     "power_limit_w": run.power_limit(),
                     "torch": torch.__version__}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    summary = {k: out[k] for k in ("workload", "seed", "device", "metrics",
                                   "window")}
    summary["tracing_cost_pct"] = out["turns"]["cost_pct"]
    summary["overhead_estimate_pct"] = out["overhead_estimate"]["pct"]
    summary["audit_equal"] = out["audit"]["equal"]
    if "k1_rows_check" in out:
        summary["k1_rows_equal"] = out["k1_rows_check"]["equal"]
    else:
        summary["edit_gap_pct"] = out["edit_time_check"]["gap_pct"]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
