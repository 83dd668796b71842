"""Spans around the program's layers, recorded from the harness by
wrapping module attributes, and the reduction of a `torch.profiler` trace
to device busy time, kernel counts, device time inside spans and the
breakdown.

A span is timed on the host clock (`time.perf_counter`), with a
`torch.cuda.synchronize` at both ends where it asks for one (outside a
profiled stretch). Inside a profiled stretch it is also a
`record_function` range named "nerfbench.<name>"; a span that asks to be
fenced synchronizes at both ends there and launches a marker kernel
(`torch.cuda._sleep`, the profiler's "spin_kernel") first and last, so
that its device time is that of the operations between its two markers
in the stream's order. The stream's order, unlike the profiler's host
and device clocks, cannot move a kernel out of its span.
"""

import contextlib
import time
from collections import defaultdict

import torch

PREFIX = "nerfbench."
MARKER = "spin_kernel"


class Spans:
    """Host-clock spans and their metadata, kept in memory."""

    def __init__(self):
        self.on = False
        self.profiled = False
        self.times = defaultdict(list)
        self.meta = defaultdict(list)
        self.fenced = set()  # names of the spans marked on the device

    @contextlib.contextmanager
    def span(self, name, sync=False, fence=False, **meta):
        if not self.on:
            yield
            return
        sync = ((fence if self.profiled else sync)
                and torch.cuda.is_initialized())
        mark = sync and self.profiled
        if mark:
            self.fenced.add(name)
        if sync:
            torch.cuda.synchronize()
        rf = (torch.profiler.record_function(PREFIX + name)
              if self.profiled else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            if mark:
                torch.cuda._sleep(1)
            yield
            if mark:
                torch.cuda._sleep(1)
            if sync:  # inside the range: what it launched ends in it
                torch.cuda.synchronize()
        self.times[name].append(time.perf_counter() - t0)
        if meta:
            self.meta[name].append(meta)


@contextlib.contextmanager
def patched(module, attr, make):
    """Replace module.attr by make(original) inside the block."""
    real = getattr(module, attr)
    setattr(module, attr, make(real))
    try:
        yield real
    finally:
        setattr(module, attr, real)


def spanned(spans, name, sync=False, fence=False, meta=None):
    """A wrapper factory for `patched`: calls inside span `name`; meta(args,
    kwargs) gives the span's metadata."""
    def make(real):
        def wrapper(*args, **kwargs):
            m = meta(args, kwargs) if meta else {}
            with spans.span(name, sync=sync, fence=fence, **m):
                return real(*args, **kwargs)
        return wrapper
    return make


def _union(intervals):
    total, end = 0.0, None
    gaps = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def fenced_device_us(ranges, marks, ops):
    """Device µs of each fenced span's operations.

    ranges: [(host start, name)] of the fenced spans' ranges; marks: the
    device start times of the marker kernels; ops: [(device start,
    µs)] of the other device operations. The i-th range in host order
    owns the operations that start between the 2i-th and the 2i+1-th
    marker. Returns {name: [µs a call]}, or {} where the markers do not
    pair up with the ranges.
    """
    ranges, marks = sorted(ranges), sorted(marks)
    if len(marks) != 2 * len(ranges):
        return {}
    out = defaultdict(list)
    for i, (_, name) in enumerate(ranges):
        m0, m1 = marks[2 * i], marks[2 * i + 1]
        out[name].append(sum(d for t, d in ops if m0 < t < m1))
    return dict(out)


def reduce_profile(prof, steps, fenced=()):
    """Reduce a profiled stretch of `steps` steps.

    Returns dict: window_s (the "nerfbench.window" range), busy_s (union of
    device operations inside it, markers left out), kernels (count of
    device operations), per_step kernels, span_device_us {fenced span:
    [device µs of each call's operations]}, device_ops [[name, s]] (top 10
    by total time) and idle_gaps [[what the host was in, s]] (the 10
    longest gaps); None if the profiler recorded no device operation.
    """
    events = list(prof.events())
    # device operations: kernels, copies and fills, not the ranges that
    # annotations (record_function, Optimizer.step) draw on the device
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(PREFIX)
           and not e.name.startswith("ProfilerStep")]
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    win = [e for e in cpu if e.name == PREFIX + "window"]
    if not dev or not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    inside = [e for e in dev if e.time_range.end > w0
              and e.time_range.start < w1]
    marks = [e.time_range.start for e in inside if MARKER in e.name]
    inside = [e for e in inside if MARKER not in e.name]
    if not inside:
        return None
    busy_us, gaps = _union([(max(e.time_range.start, w0),
                             min(e.time_range.end, w1)) for e in inside])
    by_name = defaultdict(float)
    for e in inside:
        by_name[e.name] += e.time_range.end - e.time_range.start
    ranges = [(e.time_range.start, e.name[len(PREFIX):]) for e in cpu
              if e.name[len(PREFIX):] in fenced
              and e.name.startswith(PREFIX)
              and w0 <= e.time_range.start <= w1]
    spans = fenced_device_us(
        ranges, marks, [(e.time_range.start,
                         e.time_range.end - e.time_range.start)
                        for e in inside])
    host = sorted((e for e in cpu if e.time_range.start >= w0
                   and e.time_range.end <= w1),
                  key=lambda e: e.time_range.end - e.time_range.start)

    def what(t):
        names = [e.name for e in host
                 if e.time_range.start <= t < e.time_range.end]
        own = [n for n in names if n.startswith(PREFIX)]
        op = next((n for n in names if not n.startswith(PREFIX)), "python")
        return (own[0][len(PREFIX):] + "/" if own else "") + op

    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": len(inside),
        "kernels_per_step": len(inside) / steps,
        "span_device_us": spans,
        "device_ops": [[n, t / 1e6] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[what(s), (e - s) / 1e6] for s, e in gaps],
    }
