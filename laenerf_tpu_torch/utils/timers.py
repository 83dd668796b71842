"""Wall-clock phase timers (counterpart of laenerf_tpu/utils/timers.py):
named phase durations, saved as the pipeline's timings.json."""

import json
import time


class PhaseTimer:
    """Accumulates named phase durations; serializes like timings.json."""

    def __init__(self):
        self.totals = {}
        self._start = {}

    def start(self, name):
        self._start[name] = time.time()

    def stop(self, name):
        dt = time.time() - self._start.pop(name)
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
