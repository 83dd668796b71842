"""The work-list scatter-add probe of the JAX package's
perf/probe_worklist2.py, on the port's kernel K6: perf/probe_worklist.py with
bf16 update rows (f32 accumulation) and 2,048-row tiles and blocks.

    python -m laenerf_tpu_torch.perf.probe_worklist2 [--n 12] [--device cuda]
        [--small]

`--small` keeps the JAX script's --small shapes (256-row tiles), bf16 rows.
"""

import torch

from laenerf_tpu_torch.perf import probe_worklist
from laenerf_tpu_torch.perf.scatter_inputs import FULL_2048


def main(argv=None):
    return probe_worklist.main(argv, FULL_2048, torch.bfloat16,
                               "perf/probe_worklist2.py")


if __name__ == "__main__":
    main()
