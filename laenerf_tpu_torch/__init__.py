"""laenerf_tpu_torch — the PyTorch / CUDA port of laenerf_tpu for one
NVIDIA H100.

Same layout as the JAX package:
  ops/     — hash grid, SH, march, compaction, composite, K1 scatter-add,
             K2-K4 gather probes
  models/  — NeRF network, occupancy grid, volume renderer
  data/    — rays, blender-format dataset, procedural synthetic scenes
  train/   — optimizer, train step, Trainer
  csrc/    — CUDA C++ sources of the hand-written kernels
  perf/    — H100 microbenchmark entry points (python -m ...perf.<name>)

It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
