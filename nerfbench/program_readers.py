"""Per-layer readers of the program's own tracer
(laenerf_tpu_torch/utils/timers.py): each takes a run record whose
`program` key holds the tracer's record of a traced window (`spans`,
`counters`), recorded with the profiler off, and returns the metric, or
None where the record holds no program trace or nothing to read.

    march_ms.train        mean host ms of `render.march` a train step
    march_events.train    `march.events` over the marches
    march_yield.train     100 x `render.samples` over `march.slots`
    host_syncs.train      the `sync.*` counters' sum over the train steps
    forward_ms.edit       mean host ms a LAENeRF step of `laenerf.forward`
    loss_ms.edit          ... of `laenerf.loss` (the crop losses included)
    backward_ms.edit      ... of `laenerf.backward`
    optimizer_ms.edit     ... of `laenerf.optimizer`

A step is a root span (`train.step`, `laenerf.step`) that ended inside
the record; a phase's time in a step is the sum of its spans there.
`READERS` maps each metric's name to its reader.
"""

import statistics

TRAIN_ROOT = "train.step"
EDIT_ROOT = "laenerf.step"


def _program(rec):
    prog = rec.get("program") if rec else None
    return prog if prog and prog.get("spans") is not None else None


def _steps(prog, root):
    """Step ids of the record's finished root spans named `root`."""
    return {s["step"] for s in prog["spans"]
            if s["name"] == root and s["parent"] is None
            and s["end"] is not None}


def phase_ms(rec, name, root):
    """Mean host ms a step of the spans `name` under the roots `root`
    (a step without such a span counts 0); None without steps."""
    prog = _program(rec)
    if prog is None:
        return None
    steps = _steps(prog, root)
    if not steps:
        return None
    total = {k: 0 for k in steps}
    for s in prog["spans"]:
        if s["name"] == name and s["step"] in total and s["end"] is not None:
            total[s["step"]] += s["end"] - s["start"]
    return statistics.fmean(total.values()) / 1e6


def march_events(rec):
    """March events a march ran, on average over the record's marches."""
    prog = _program(rec)
    if prog is None:
        return None
    marches = sum(s["name"] == "render.march" for s in prog["spans"])
    events = prog["counters"].get("march.events")
    return events / marches if marches and events is not None else None


def march_yield(rec):
    """Percent of the march's [rays x events] slots that held a sample the
    network evaluated."""
    prog = _program(rec)
    if prog is None:
        return None
    slots = prog["counters"].get("march.slots")
    samples = prog["counters"].get("render.samples")
    if not slots or samples is None:
        return None
    return 100.0 * samples / slots


def host_syncs(rec):
    """Places the host waited for the card, a train step: every `sync.*`
    counter summed, over the record's train steps."""
    prog = _program(rec)
    if prog is None:
        return None
    steps = _steps(prog, TRAIN_ROOT)
    if not steps:
        return None
    return sum(n for k, n in prog["counters"].items()
               if k.startswith("sync.")) / len(steps)


READERS = {
    "march_ms.train": lambda rec: phase_ms(rec, "render.march", TRAIN_ROOT),
    "march_events.train": march_events,
    "march_yield.train": march_yield,
    "host_syncs.train": host_syncs,
    "forward_ms.edit": lambda rec: phase_ms(rec, "laenerf.forward",
                                            EDIT_ROOT),
    "loss_ms.edit": lambda rec: phase_ms(rec, "laenerf.loss", EDIT_ROOT),
    "backward_ms.edit": lambda rec: phase_ms(rec, "laenerf.backward",
                                             EDIT_ROOT),
    "optimizer_ms.edit": lambda rec: phase_ms(rec, "laenerf.optimizer",
                                              EDIT_ROOT),
}
