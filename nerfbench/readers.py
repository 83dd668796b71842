"""The per-layer readers that metrics/<metric>.py files call: each takes
the traced run's record (spans, the profiled stretch's reduction and the
driver's trace inputs) and returns the metric, or None where the record
holds nothing to read. BENCHMARK.json's `workloads` on a metric decides
which cells read it; a driver puts what its kind needs into the record's
`inputs` (`k1_bytes`, `step_least_s`).
"""

import statistics

from . import counts


def span_ms(rec, name):
    """Mean host milliseconds of the span `name` over the traced window."""
    t = rec["spans"].get(name) if rec else None
    return 1e3 * statistics.fmean(t) if t else None


def device_idle(rec):
    """Percent of the profiled stretch in which no operation ran on the
    card: 100 minus the union of the device operations' intervals."""
    if not rec or not rec["profile"]:
        return None
    p = rec["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def launches_per_step(rec):
    """Device operations (kernels, copies, fills) a step launches in the
    profiled stretch."""
    if not rec or not rec["profile"]:
        return None
    return rec["profile"]["kernels_per_step"]


def k1_roofline(rec):
    """K1's share of its roofline: the least time of the profiled
    stretch's K1 calls (the bytes the driver counts for each,
    counts.k1_bytes at the memory rate) over the device time of every
    operation launched inside the calls' fenced spans."""
    if not rec or not rec["profile"]:
        return None
    dev_us = rec["profile"]["span_device_us"].get("k1", [])
    n_bytes = rec["inputs"].get("k1_bytes", [])
    if not dev_us or sum(dev_us) <= 0 or len(n_bytes) != len(dev_us):
        return None
    bound_ms = sum(counts.bound_of(b)[0] for b in n_bytes)
    return 100.0 * bound_ms * 1e3 / sum(dev_us)


def step_mfu(rec):
    """A step's share of the card's roofline: its least time (the
    driver's `step_least_s`, from counts.py) over the mean step time of
    the traced run's window, in which the profiler is off."""
    if not rec or not rec["window_steps"]:
        return None
    least = rec["inputs"].get("step_least_s")
    if not least:
        return None
    return 100.0 * least / (rec["window_s"] / rec["window_steps"])


def window_rate(rec):
    """The traced window's work (the driver's window_step results) over
    its seconds on the host clock, closed loop."""
    if not rec or not rec["window_s"]:
        return None
    return rec["window_work"] / rec["window_s"]
