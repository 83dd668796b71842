"""laenerf_tpu_torch — the PyTorch / CUDA port of laenerf_tpu for one
NVIDIA H100.

Same layout as the JAX package:
  ops/     — hash grid, SH, march, compaction, composite, K1 scatter-add,
             K2-K4 gather probes, K5-K6 sorted scatter-adds, K7 construct
             probes
  models/  — NeRF network, occupancy grid, volume renderer (train,
             inference and distill paths), stratified renderer
  data/    — rays, the dataset (colmap and blender layouts, error-map
             and patch sampling), procedural synthetic scenes
  train/   — optimizer, train steps (NeRF with the patch-LPIPS term,
             distill fine-tune, NPR fine-tune), Trainer and its epoch
             loop, metrics (PSNR, SSIM, LPIPS), checkpoints, aux losses
  editing/ — edit grid, LAENeRF and its trainer, edit dataset,
             distillation (recolor); VGG-19/16 stacks, the Gram style
             network (style); the semantic encoder, the registration
             dataset and the NPR trainer (NPR)
  pipeline/ — the command-line entry point (python -m
             laenerf_tpu_torch.pipeline.cli) and the headless pipelines
             (EditPipeline.run_all for recolor and style,
             run_npr_pipeline)
  utils/   — the tracer and phase timers, palette images, PNG writing,
             bilinear resize, colour spaces, video, density mesh export
  csrc/    — CUDA C++ sources of the hand-written kernels
  perf/    — H100 microbenchmark entry points (python -m ...perf.<name>)

It imports torch, numpy, scipy and Pillow, never jax.
"""

__version__ = "0.1.0"
