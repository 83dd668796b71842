"""Run one cell of the benchmark once.

    python -m nerfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration,
traffic mix, limits and per-layer metrics are found by name:
configs/<config>.json, traffic/<mix>.json (its `kind` names the driver in
drivers/), limits/<cell>.json and metrics/<metric>.py. Set-up runs from
process start to the window's start; the window measures for --seconds;
with --trace 1 the window runs with spans on and a profiled stretch
follows, and the per-layer metrics are reported instead of the end-to-end
ones. A mix that names a `device_rate_metric` profiles that stretch in
every run: its work over the seconds in which an operation ran on the
card is that end-to-end metric. After the window the program is freed and the reference decides
`correct`. The last line of standard output is the result (JSON); the
numbers compared, each beside its limit, are the last lines of standard
error. Needs a CUDA card: without one it exits 2 and prints no result.
"""

import os

# one process, one CPU thread: the program's host work runs on the main and
# autograd threads, not in CPU thread pools. OpenMP and MKL read these when
# torch loads, so they are set before anything imports torch.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import harness  # noqa: E402

ROOT = Path(__file__).resolve().parent
BANNED = frozenset({"jax", "jaxlib", "flax", "laenerf_tpu"})


def banned_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def load_spec(workload, bench_path=None):
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench_path = bench_path or ROOT.parent / "BENCHMARK.json"
    with open(bench_path) as f:
        bench = json.load(f)
    base = Path(bench_path).parent
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(base / conf["file"]) as f:
        cfg = json.load(f)
    with open(ROOT / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(ROOT / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


def load_driver(spec):
    """The traffic kind's driver, drivers/<kind>.py. Its CHIPS names the
    chip counts it can run a cell on; a driver that runs on more than one
    chip makes its own launch."""
    return importlib.import_module(
        f"nerfbench.drivers.{spec['traffic']['kind']}")


def metric_reader(name):
    spec = importlib.util.spec_from_file_location(
        "nerfbench_metric_" + name.replace(".", "_"),
        ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def run_cell(spec, seed, seconds, trace, device="cuda"):
    """Set up, measure and check one run; returns (Outcome, breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .probe import Spans, patched, reduce_profile

    traffic = spec["traffic"]
    driver = load_driver(spec)
    spans = Spans()
    ages = [harness.process_age_s()]
    run = driver.Run(spec["config"], traffic, seed, device, spans)
    ages.append(harness.process_age_s())
    run.checked_steps()
    harness.sync()
    setup_s = harness.process_age_s()
    print(f"nerfbench: {torch.get_num_threads()} CPU thread(s); set-up "
          f"{setup_s:.2f} s: start and imports "
          f"{ages[0]:.2f} s, building the trainer and loading its inputs "
          f"{ages[1] - ages[0]:.2f} s, the checked steps and warm-up "
          f"{setup_s - ages[1]:.2f} s", file=sys.stderr)
    trace_in, breakdown = None, None
    with contextlib.ExitStack() as stack:
        if trace:
            for mod, attr, make in run.trace_patches():
                stack.enter_context(patched(mod, attr, make))
            spans.on = True
        calls, elapsed, work, gaps = harness.window(run.window_step,
                                                    seconds)
        if len(gaps) >= 2:
            q = statistics.quantiles(gaps, n=10)
            print(f"nerfbench: window {elapsed:.3f} s, {calls} calls, "
                  f"{work / elapsed:.1f} work/s, "
                  f"host seconds a call p10 {q[0]:.4f} p50 "
                  f"{statistics.median(gaps):.4f} p90 {q[-1]:.4f}",
                  file=sys.stderr)
        steps = calls * traffic.get("chunk_steps", 1)
        e2e = {"setup_s": setup_s}
        if "rate_metric" in traffic:
            e2e[traffic["rate_metric"]] = work / elapsed
        # a device-time rate: the work of a fixed stretch after the window
        # over the seconds in which an operation ran on the card
        dev_rate = traffic.get("device_rate_metric")
        if trace or dev_rate:
            n = run.after_window_trace()
            spans.profiled = True
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=acts) as prof:
                with record_function("nerfbench.window"):
                    stretch_work = run.profiled(n)
                    harness.sync()
            red = reduce_profile(prof, n, spans.fenced)
            if dev_rate and red is not None:
                e2e[dev_rate] = stretch_work / red["busy_s"]
                print(f"nerfbench: profiled stretch of {n} steps, "
                      f"{stretch_work} work, device busy {red['busy_s']!r} "
                      f"s of {red['window_s']!r} s", file=sys.stderr)
        if trace:
            trace_in = {"window_steps": steps, "window_s": elapsed,
                        "window_work": work,
                        "spans": dict(spans.times),
                        "meta": dict(spans.meta), "profile": red,
                        "profile_steps": n,
                        "inputs": run.trace_inputs()}
            if red is not None:
                breakdown = {"device_ops": red["device_ops"],
                             "idle_gaps": red["idle_gaps"]}
        spans.on = spans.profiled = False
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else 0)
    run.free()
    readings, error = run.program_readings()
    return harness.Outcome(attempted=steps, failed=0, end_to_end=e2e,
                           readings=readings, memory_peak_bytes=peak,
                           trace=trace_in, error=error), breakdown


def decide(readings, limits, error):
    """correct, and each number beside its limit."""
    vals = {n: readings.get(n, math.inf) for n in limits["limits"]}
    ok = error is None and all(
        math.isfinite(v) and v <= limits["limits"][n]
        for n, v in vals.items())
    # JSON has no infinity: a number that could not be made reads "inf"
    checks = {n: {"value": v if math.isfinite(v) else repr(v),
                  "limit": limits["limits"][n]} for n, v in vals.items()}
    return ok, checks


def result(spec, out, breakdown, trace, device_info):
    ok, checks = decide(out.readings, spec["limits"], out.error)
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # a device_trace metric has no value where the profiler saw no
        # device operation (a CPU run); main() refuses such a result
        for m in spec["end_to_end"]:
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                      "unit": m["unit"]}
    res = {"correct": ok, "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": dict(device_info)}
    res["device"]["memory_peak_bytes"] = out.memory_peak_bytes
    if trace and out.trace and out.trace["profile"]:
        res["device"]["busy_s"] = out.trace["profile"]["busy_s"]
        res["device"]["window_s"] = out.trace["profile"]["window_s"]
    if breakdown:
        res["breakdown"] = breakdown
    res["checks"] = checks
    return res, checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache of the run stays inside the checkout, at a fixed path
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(harness.CACHE / sub)
    spec = load_spec(args.workload)

    import torch

    chips = spec["cell"]["chips"]
    if chips not in load_driver(spec).CHIPS:
        print(f"nerfbench: the {spec['traffic']['kind']} driver cannot run "
              f"on {chips} chip(s)", file=sys.stderr)
        return 2
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"nerfbench: needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    out, breakdown = run_cell(spec, args.seed, args.seconds, args.trace)
    bad = banned_modules()
    if bad:
        print(f"nerfbench: loaded {bad}: the benchmark may not load JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips, "power_limit_w": power_limit()}
    res, checks = result(spec, out, breakdown, args.trace, device_info)
    missing = [m["name"] for m in spec["end_to_end"]
               if not args.trace and m["name"] not in res["metrics"]]
    if missing:
        print(f"nerfbench: no reading of {missing}: the profiler saw no "
              f"device operation", file=sys.stderr)
        return 3
    if out.error:
        print(f"nerfbench: the comparison failed: {out.error}",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
