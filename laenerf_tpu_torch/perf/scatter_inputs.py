"""The index and update generator of the JAX package's scatter-add probes.

`make_inputs` draws from `np.random.RandomState(0)` in the order of
perf/microbench_scatter2.py:53-69 and perf/probe_worklist.py:48-63, so the
port's probes and the JAX scripts see identical indices and updates: a
Gaussian blob (sigma 0.15 about the centre) of B points, whose cells index
the dense levels (fewer than 500,000 rows, LK // levels corner offsets k
each), and uniform rows on the hashed levels. The full shapes are the bench
configuration at steady state (65,536 samples x 32 level-corner rows of
C = 8 into 2,936,936 rows); `SMALL` are probe_worklist.py's `--small` ones.
"""

from typing import NamedTuple

import numpy as np

C = 8


class ScatterShape(NamedTuple):
    level_sizes: tuple
    B: int  # samples
    LK: int  # update rows per sample (levels x corners)
    tile: int  # K5/K6 table tile rows
    maxu: int  # K6 updates per block

    @property
    def Q(self):
        return self.B * self.LK

    @property
    def T(self):
        return sum(self.level_sizes)


LEVELS = (4920, 35944, 274632) + (524288,) * 5
FULL = ScatterShape(LEVELS, 65536, 32, 1024, 1024)
# perf/probe_worklist2.py: the same updates, 2,048-row tiles and blocks
FULL_2048 = FULL._replace(tile=2048, maxu=2048)
SMALL = ScatterShape((1024, 4096, 8192), 2048, 6, 256, 256)


def make_inputs(shape: ScatterShape = FULL, C: int = C):
    """(idx [Q] int32, g [Q, C] float32) numpy arrays, q = b * LK + kk."""
    sizes = shape.level_sizes
    per_level = shape.LK // len(sizes)
    rng = np.random.RandomState(0)
    level_offs = np.cumsum((0,) + tuple(sizes))[:-1]
    idx = np.zeros((shape.B, shape.LK), np.int32)
    blob = np.clip(rng.randn(shape.B, 3) * 0.15 + 0.5, 0, 1)
    for lvl, (sz, off) in enumerate(zip(sizes, level_offs)):
        for k in range(per_level):
            kk = lvl * per_level + k
            if sz < 500000:  # dense level: the blob's cells
                res = max(2, round(sz ** (1 / 3)))
                cell = np.minimum((blob * res).astype(np.int64), res - 1)
                flat = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2] + k
                idx[:, kk] = off + np.minimum(flat, sz - 1)
            else:
                idx[:, kk] = off + rng.randint(0, sz, shape.B)
    g = rng.randn(shape.Q, C).astype(np.float32)
    return idx.reshape(-1), g
