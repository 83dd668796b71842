"""The program's tracer, and the pipeline's phase timers on top of it
(the JAX package's utils/timers.py has the phase timers only).

The tracer records spans and counters at the program's layer boundaries
and keeps them in memory:

    from laenerf_tpu_torch.utils import timers

    timers.start()
    ...                      # train steps
    rec = timers.stop()      # {"spans": [...], "counters": {...}}

`span(name, step=None, **attrs)` is a context manager around one layer's
work; `count(name, n=1)` adds n to a counter. Recording is off unless
`start()` turned it on; then `count` returns at once and `span` returns
one shared null context, so the tracer launches nothing on the card and
never synchronizes. While a `torch.profiler` is active, every span also
opens a `record_function` range named PREFIX + name, recording or not,
so that a profile shows the program's layers beside the device
operations (ranges are annotations, not device operations).

A recorded span is a dict: name, id, parent (the id of the span it was
opened under, or None), step, attrs, and start and end in
`time.perf_counter_ns()`. A span given `step=` sets the step id of itself
and of every span under it; any other span takes its parent's. The stack
of open spans is one per process, not one per thread: autograd runs
backward on a thread of its own, and a span opened there (K1's, in
ops/scatter_add.py) nests under the span that called backward. So spans
are opened from one thread at a time.

Counters are ints. The program counts, among others, `sync.<site>`: each
place in a train step where the host waits for the card when the step's
tensors are on one (reading a value back, `nonzero`, a blocking copy
from pageable host memory); on the CPU the same places count alike.
"""

import contextlib
import json
import time

import torch.autograd.profiler as _profiler

PREFIX = "laenerf_tpu_torch."
_NULL = contextlib.nullcontext()


class Tracer:
    """Spans and counters of one recording, kept in memory."""

    def __init__(self):
        self.recording = False
        self.spans = []
        self.counters = {}
        self.open = []  # the records of the spans open now, innermost last
        self._next_id = 0

    def start(self):
        """Begin a recording; what an earlier one held is dropped."""
        self.spans, self.counters, self.open = [], {}, []
        self._next_id = 0
        self.recording = True

    def stop(self):
        """End the recording; returns {"spans": [...], "counters": {...}}.
        A span still open keeps end None."""
        self.recording = False
        rec = {"spans": self.spans, "counters": self.counters}
        self.spans, self.counters, self.open = [], {}, []
        return rec

    def opened(self, name, step, attrs):
        parent = self.open[-1] if self.open else None
        rec = {"name": name, "id": self._next_id,
               "parent": None if parent is None else parent["id"],
               "step": step if step is not None or parent is None
               else parent["step"],
               "attrs": attrs, "start": time.perf_counter_ns(), "end": None}
        self._next_id += 1
        self.spans.append(rec)
        self.open.append(rec)
        return rec

    def closed(self, rec):
        rec["end"] = time.perf_counter_ns()
        if self.open and self.open[-1] is rec:
            self.open.pop()


TRACER = Tracer()


class _Span:
    __slots__ = ("name", "step", "attrs", "rec", "range")

    def __init__(self, name, step, attrs):
        self.name, self.step, self.attrs = name, step, attrs
        self.rec = self.range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        if TRACER.recording:
            self.rec = TRACER.opened(self.name, self.step, self.attrs)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            TRACER.closed(self.rec)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def active():
    """True while a span is recorded or drawn as a profiler range."""
    return TRACER.recording or _profiler._is_profiler_enabled


def span(name, step=None, **attrs):
    """A context manager around one layer's work (see the module's
    docstring); the shared null context while neither recording nor a
    profiler is on."""
    if not active():
        return _NULL
    return _Span(name, step, attrs)


def count(name, n=1):
    """Add n to the counter `name` while recording."""
    if TRACER.recording:
        c = TRACER.counters
        c[name] = c.get(name, 0) + n


def start():
    TRACER.start()


def stop():
    return TRACER.stop()


class PhaseTimer:
    """Accumulates named phase durations (seconds, `time.perf_counter`);
    serializes like timings.json. Each phase is also a `pipeline.<name>`
    span."""

    def __init__(self):
        self.totals = {}
        self._start = {}

    def start(self, name):
        s = span("pipeline." + name)
        s.__enter__()
        self._start[name] = (time.perf_counter(), s)

    def stop(self, name):
        t0, s = self._start.pop(name)
        dt = time.perf_counter() - t0
        s.__exit__(None, None, None)
        self.totals[name] = self.totals.get(name, 0.0) + dt
        return dt

    def __getitem__(self, name):
        return self.totals.get(name, 0.0)

    def summary(self):
        out = dict(self.totals)
        out["sum"] = sum(self.totals.values())
        return out

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
