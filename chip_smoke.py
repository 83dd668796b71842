"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each, tagged with the seconds since the start
(any failure exits non-zero, before the last line):
  1. device: requires CUDA; prints the card's name and power limit.
  2. build: compiles the CUDA sources (csrc/scatter_add.cu: K1;
     csrc/gather_probes.cu: K2-K4; csrc/sorted_scatter.cu: K5, K6;
     csrc/construct_probes.cu: K7; csrc/raymarch.cu: K8; csrc/composite.cu:
     K9) with nvcc, one process per source, all started together; prints
     the registers, shared memory and spill stores of K1's, K2's, K3's,
     K4's, K7 k1's, k4's, k5's and k7's, K8's and K9's kernels, and what
     cuobjdump -sass shows of the gather kernels and of K7's fill kernels
     (k1, k5, k7): instances with a 16-byte store and a 16-byte load,
     calls such as a 64-bit division routine, and FADDs (k5's loop; the
     phase fails if k5 has none, a loop folded away).
  3. K1 against its plain PyTorch version on the card: the cases of the
     JAX package's scatter-add tests; the main-path shape (65,536 samples x
     8 levels x 8 corners of the L8C4 lg19 grid, passed as the backward
     passes it, [samples, 64]) on two inputs, uniform points and 4,096
     rays of 16 consecutive march steps, each timed against index_add_
     beside its bound with its RED count; and the hash-grid backward on
     the card against the same backward on the CPU.
  4. gather: K2 take_rows, K3 take_lanes and K4 grid_probe at the full
     width of every TPU call site they replace (P1, P2, P2b, G, G2; P3, P3x
     x4; P4, P4b, P6), each equal to its plain version and to the PyTorch
     call for the same function (torch.equal), timed against both (plain,
     library, kernel, kernel, library, plain) beside its bound, and its
     device time under the profiler. Then K2, K3 and K4 at ragged shapes,
     untimed (widths, N and lanes off the 16-byte chunks, one-row tables,
     index arrays and tables as views 4 bytes into their storage, each
     dtype), each equal to its plain version and to the PyTorch call.
  5. probes: the two gather-probe entry points (laenerf_tpu_torch.perf.
     microbench_pallas and microbench_gather, --n 16), with the launch
     counts of K2-K4 set to 0 before and read after; each must launch.
  6. scatter: K5 tile_scatter and K6 worklist_scatter at the full shapes of
     rows 10-12 of PERF.md's kernel table (2,097,152 sorted updates of
     C = 8 into 2,936,936 rows: K5 f32 at 1,024-row tiles, K6 f32 at 1,024
     and bf16 at 2,048), each within rel 1e-5 of its plain version and of
     index_add_ on the unsorted updates, timed against both and against K1
     on the same unsorted updates, beside its byte bound and its device
     time under the profiler; the largest per-tile update count and the
     longest run of one row. Then K5 on a skewed input (every update of
     the heaviest tile moved onto 3 of its rows), and K6 on a hand-made
     work list (the heaviest tile's items, one of them listed twice),
     untimed, each within rel 1e-5 of its plain version.
  7. constructs: the eight K7 constructs (perf/bisect_mosaic.py's k1-k7,
     k6b), each equal to its plain version and, for the six that have one,
     to the PyTorch call for the same function (torch.equal) on the
     script's inputs and on random ones, timed against both on the random
     ones (and k5 also on the script's 3 trips); then k6b's kernel on a
     skewed input (all 1,024 columns of each tile on one row, small
     integers) equal to its plain version, k4 at the edges of its 64-row
     slices (offsets 0, len(q) - tile and 1-3 mod 4; C = 1, 4, 8, 12; one
     tile) equal to its plain version and to torch.take, and the fill
     kernels k1, k5 and k7 at ragged shapes (tiles of 1, 100 and 1,024
     rows by C = 1, 3, 8, 128, and 300 tiles) equal to their plain
     versions.
  8. probes: the four scatter entry points (microbench_scatter2,
     probe_worklist, probe_worklist2 at --n 12; bisect_mosaic), with the
     launch counts of K5-K7 set to 0 before and read after; each must
     launch, and bisect_mosaic must print eight OK lines.
  9. march: K8 march_rays_train at the NeRF cell's march (8,192 rays of
     one 800x800 view, 128^3, 1,024 events) on the lego-class scene's
     occupancy (a cell set where its points have density, as a trained
     grid's are), 4 views: equal to its plain loop (valid, n_samples and
     t0; ts and dts bit-equal where valid, finite elsewhere); its time by
     CUDA events and on the device against its byte bound (N x S x 9 B),
     march_rays_train with the skip field, the plain loop's time, the
     phase's launch count and ptxas's registers and spills of its
     variants. Then K9 composite_rays_train_packed on the first view's
     samples packed as the train path packs them (capacity 262,144), the
     scene's density and colour at them: forward and backward (from all
     three outputs) against its plain version, at the card tests'
     tolerances; each one's time by CUDA events and on the device against
     its byte bound, the plain version's, and ptxas's report.
  10. train: the bench configuration (L8C4 lg19, 4096-ray batches of a
     16-view 100x100 synthetic scene), mark_untrained, then 272
     Trainer.train_one_batch steps (17 occupancy refreshes, the last one
     partial). The loss must fall, the density grid's mean must halve, and
     every step must launch K1, K8 and K9's forward and backward.
  11. render: one 400x400 frame with Trainer.render_image, and the
     train-view PSNR at 100x100.
  12. profile: kernel launches and device-busy share of a few train steps,
     and K1's device time per launch inside them, and inside one train
     step at each span in turns (k1_span_turns).
  13. recolor: the editing path on the trained NeRF (EditPipeline's
     phases in run_all's order). First what the centre pixel of train view
     0 selects (project_points, grown 4000 pops): its termination point
     and its edit dataset over the first 4 views, for the record. Then a
     region seeded inside the scene's centre sphere as the recolor gate
     seeds it, grown the same way, the edit dataset, 300 LAENeRF steps (8 bases, a 16-level
     C = 2 lg19 encoder, the palette pruned at step 200), distillation
     with a recolored palette, 64 fine-tune steps and the eval renders;
     checks that the edit dataset is not empty, the LAENeRF MSE falls, a
     basis stays active, K1 launches in every LAENeRF and fine-tune step,
     distillation leaves every pixel at or under blend_thresh as it was
     and changes some above it, the renders are finite in [0, 1] and a
     fresh Trainer renders the fine-tune's checkpoint equally; then K1 on
     a LAENeRF backward's own input against its plain version and
     index_add_, and K1's device time inside 4 more LAENeRF steps. Prints
     the phase seconds, ms per LAENeRF and fine-tune step and the bg-MSE
     outside the exported masks.
  14. style: the style mode on the recolor phase's NeRF and region
     (EditPipeline(mode="style") in run_all's order) at the recolor gate's
     style width: VGG-19 to index 14, style layers 10/12/14, crop_size 256,
     style_weight 130, 8 bases, style_lg 19; 300 LAENeRF steps, warm-up
     100, pruning at 200, 32 fine-tune steps; then preserve_color's
     LAENeRF phase on the same edit dataset. Checks that the Gram term ran
     in every step past warm-up, the MSE falls, K1 launches in every
     LAENeRF and fine-tune step, distillation changes pixels and the
     renders are finite in [0, 1]; prints ms per LAENeRF step before and
     after warm-up, ms per fine-tune step, the phase seconds and the Gram
     loss on the card against the CPU; then K1 on a style step's input
     against its plain version and index_add_.
  15. npr: run_npr_pipeline at its defaults (VGG-16 to index 29,
     feature_size 256, 4 bases, no direction encoding) from train view 0
     with its green channel doubled; 200 LAENeRF and 32 fine-tune steps.
     Checks style_enc.npz and timings.json, the falling NPR MSE, finite
     fine-tune losses and K1 in every step; then K1 on the fine-tune
     backward's input (held to REL_TOL of the largest sum of magnitudes
     into one row: its gradients cancel).
  16. lpips: Trainer.evaluate over 2 test views with LPIPS through a
     synthetic VGG-16 npz, against the same LPIPS on the CPU.
  17. clip: CLIP guidance on the training phase's trainer (after every
     other phase that uses it): the ViT-B/16 tower at its published width
     (12 x 768, 12 heads, MLP 3,072, projection 512, 224^2, patch 16;
     random weights, no npz in the repo) on the card against the CPU (the
     loss within 1e-5 of its terms' magnitudes sum |z_i t_i|, the image
     gradient within 1e-4 of its largest element); 32
     Trainer.train_one_batch_clip steps, one rand_poses camera at 64x64 (4,096
     rays) each, a seeded [512] text embedding. Checks finite losses, a
     moved encoder and K1 in every step; prints ms per CLIP step (median
     after 4), the tower's forward and backward alone (CUDA events) and
     their share of a step, and the tower's MB; then K1 on a CLIP step's
     backward input (held to REL_TOL of the largest sum of magnitudes).
  18. cli: the command-line entry point (laenerf_tpu_torch.pipeline.cli.
     main, in process) on a colmap-layout copy of a 17-view 100x100
     procedural scene with fern's flags (bound 2, no bg, -O, dt_gamma 0,
     density_thresh 10) and --error_map, at the CLI's own width (16-level
     C = 2 lg19 grid, 2 cascades, 1024 march events, m_cap 32): 32 -m nerf
     steps (finite losses, K1 in every step, a moved error map, a
     checkpoint, and a falling loss, read as each batch's per-ray errors
     reweighted by 1 / p of their error-map cells: the batch loss itself
     rises as the map draws the pixels with high error; ms/step, the host's
     error-map share, occupancy, val PSNR),
     --test --save_mesh at 128^3 (11 slerp frames finite in [0, 1], the
     video or its PNG frames, mesh.ply's vertex and face counts), 4 more
     steps with --patch_size 8 and the patch-LPIPS term on (one batch's
     value on the card against the CPU within rel 1e-5), then K1 on a CLI
     step's backward input (held to REL_TOL of the largest sum of
     magnitudes) against its plain version and index_add_.
  19. background: a fresh Trainer at the training cell's width with
     bg_radius 4 (the background network on the 2-D 4-level C = 2 lg19
     grid, 697,776 rows; targets on white), 64 steps on the procedural
     scene: K1 at least twice a step (both tables), the loss falls (medians
     of the first and last 8 steps), a 100x100 test view finite in [0, 1]
     that equals the same rays composited on black plus (1 - weights) times
     the network's color; then K1 on the background backward's input (a
     1-D idx of 65,536 f32 rows of C = 2).
  20. parallel: a one-process NCCL group (file:// rendezvous; one card
     allows world size 1 only): from copies of the background trainer, 8
     dp_train_steps, each from the state a train_step on the same batch
     and noises starts from: the loss within REL_TOL of it, the gradients
     within REL_TOL of their largest magnitude, and the parameters and EMA
     equal, within REL_TOL of the largest magnitude, to Adam, the LR step
     and the EMA applied to the dp step's own gradients; dp_render_image
     within 2e-3 of render_image; K1 on a rank's shard; the group is
     destroyed at the end.
  21. gates: the port's gate and eval scripts (laenerf_tpu_torch.scripts,
     in process through their main) at the quality gate model's width
     (16-level C = 2 lg19 grid, max_steps 1024, march_iters 512, m_cap 40)
     on the lego-class scene (4 train views at 100x100, aa 2): the quality
     gate with --eval_only (the untrained network's test PSNR), then 128
     steps (the loss falls, K1 in every step, the test PSNR above
     the untrained one, SSIM <= 1, 8 test frames finite in [0, 1]); the
     recolor gate on its workspace (100 LAENeRF, 50 palette and 16
     fine-tune steps; bg-MSE finite, and between the pre- and post-edit
     test renders the MSE inside the exported masks above the MSE outside
     them); render_orbit (3 frames at 64x64,
     steps 1 and 2); EditSession on the gate's trainer (render_frame equal
     to render_image, a click inside the bound, grow, the grow grid, the
     selection view restoring the occupancy); morton codes on 2^20
     coordinates and the encoder's input gradient card vs CPU; then K1 on
     a gate step's backward input.
Every K1 site (k1_site) holds K1, and prints its plain version too,
against the same rows summed in float64 (k1_f64).
Then one JSON line with every kernel of the path, the nvidia-smi line, and
the final {"ok": true, "device": ...} line. K1's, K8's and K9's launches in
that line are those of the main-path phases (train and render, recolor, style,
NPR, CLIP, CLI, background, parallel and gates), counted phase by phase;
the probe and march phases' own launches are in their lines.

Imports torch and the port only, never JAX.
"""

import contextlib
import copy
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

TRAIN_STEPS = 272
RENDER_HW = 400  # 800 until the gates phase joined the run
REL_TOL = 1e-5  # K1 against the float64 sum of its input (k1_f64)
SOURCES = ("scatter_add.cu", "gather_probes.cu", "sorted_scatter.cu",
           "construct_probes.cu", "raymarch.cu", "composite.cu")
# the least time of a kernel: the larger of its bytes over the memory rate
# and its operations over the peak rate (NVIDIA's H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12  # dense bf16 on the tensor cores
SECTOR = 32  # bytes: the unit in which L2 and HBM serve a random read
# kernels whose registers, shared memory and spills the build phase prints
REPORTED_KERNELS = ("take_rows_kernel", "take_lanes_kernel",
                    "grid_probe_kernel", "copy_1d_kernel",
                    "scatter_add_rows_kernel", "prefetch_write_kernel",
                    "dynamic_loop_kernel", "iota_rows_kernel",
                    "march_rays_train_kernel", "march_unended_kernel",
                    "composite_forward_kernel", "composite_backward_kernel")
GATHER_KERNELS = ("take_rows_kernel", "take_lanes_kernel",
                  "grid_probe_kernel")
FILL_KERNELS = ("prefetch_write_kernel", "dynamic_loop_kernel",
                "iota_rows_kernel")
# K7's fill kernels at ragged shapes: (tile, C, n_tiles)
FILL_SHAPES = [(tile, C, 7) for tile in (1, 100, 1024)
               for C in (1, 3, 8, 128)] + [(1024, 8, 300)]
# K8 at the NeRF cell's march: 8,192 rays a view of 800^2 pixels
# (camera_angle_x 0.8, radius 3.5, poses scaled by 0.8), 128^3, 1,024 events
MARCH_RAYS, MARCH_HW, MARCH_VIEWS, MARCH_SCALE = 8192, 800, 4, 0.8
K9_CAP = MARCH_RAYS * 32  # the NeRF cell's capacity, m_cap_per_ray 32
K9_TOL = 1e-5  # K9 against its plain version (tests/test_torch_cuda.py)


START = time.perf_counter()


def phase(name, msg):
    """One line of a phase, tagged with the seconds since the script
    started (the time limit covers the whole run)."""
    print(f"[{name} {time.perf_counter() - START:.1f}s] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def ptxas_kernels(report, names):
    """(mangled name, registers, spill-store bytes, shared-memory bytes) of
    each kernel in nvcc's -Xptxas=-v report whose name holds one of names."""
    found, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and any(n in name for n in names):
            smem = re.search(r"(\d+) bytes smem", line)
            found.append((name, int(m.group(1)), spill,
                          int(smem.group(1)) if smem else 0))
    return found


def sass_counts(library, names):
    """For each kernel name, from `cuobjdump -sass` of the built library:
    its instances and how many of them hold a 16-byte global store
    (STG.E.128) and a 16-byte global load (LDG.E.128...), its CALL
    instructions (a 64-bit division or modulo is a call to a routine) and
    its FADD instructions. None where the toolkit has no cuobjdump."""
    from laenerf_tpu_torch.ops.cuda_build import _nvcc

    tool = shutil.which("cuobjdump", path=str(Path(_nvcc()).parent))
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    counts = {n: {"instances": 0, "stg128": 0, "ldg128": 0, "calls": 0,
                  "fadds": 0} for n in names}
    for func in sass.split("Function : ")[1:]:
        name = next((n for n in names if n in func.split("\n", 1)[0]), None)
        if name is None:
            continue
        c = counts[name]
        c["instances"] += 1
        c["stg128"] += "STG.E.128" in func
        c["ldg128"] += "LDG.E.128" in func
        c["calls"] += len(re.findall(r"\bCALL\.", func))
        c["fadds"] += len(re.findall(r"\bFADD\b", func))
    return counts


def cuda_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_of(n_bytes, n_ops=0, ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by) for n_bytes moved and n_ops done at
    ops_per_s (f32 outside the tensor cores by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(fn, reps=10, name=None, tries=3):
    """Device time per call of fn: the sum of its CUDA kernels' times under
    torch.profiler, without the host's launch gaps; None if the profiler
    saw no kernel in `tries` windows (a window sometimes records none).
    With name, the pair (that time, the part of it in kernels whose name
    holds name)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    total = sum(e.device_time for e in events) / 1e3 / reps if events \
        else None
    if name is None:
        return total
    part = sum(e.device_time for e in events if name in e.name) / 1e3 / reps
    return total, part if events else None


def rel_err(got, ref):
    scale = ref.abs().max().item() + 1e-12
    return (got - ref).abs().max().item() / scale


def k1_cases(dev):
    """(name, idx int32, g f32, table_rows) on the card."""
    g = torch.Generator().manual_seed(0)

    def uniform(Q, T, C):
        return (torch.randint(0, T, (Q,), generator=g, dtype=torch.int32),
                torch.randn(Q, C, generator=g), T)

    cases = [("uniform",) + uniform(10000, 5000, 8),
             ("all_one_row", torch.full((8192,), 17, dtype=torch.int32),
              torch.ones(8192, 4), 4096)]
    clustered = 5000 + torch.randint(0, 300, (20000,), generator=g,
                                     dtype=torch.int32)
    cases.append(("clustered_empty_tiles", clustered,
                  torch.randn(20000, 8, generator=g), 40000))
    straddle = torch.cat([torch.full((2047,), 2047), torch.full((2049,), 2048),
                          torch.full((2048,), 4095)]).to(torch.int32)
    cases.append(("block_straddle", straddle, torch.ones(6144, 2), 6144))
    cases.append(("tiny_table",) + uniform(3000, 100, 8))
    oob = uniform(5000, 700, 4)
    oob[0][::97] = 700
    oob[0][7::83] = -1
    cases.append(("out_of_range_rows",) + oob)
    return [(n, i.to(dev), x.to(dev), T) for n, i, x, T in cases]


def main_path_rows(spec, dev, order, n_rays=4096, per_ray=16):
    """The encoder backward's K1 input at the main-path shape, as the
    backward passes it: corner rows [n, L * 8] and bf16 rows w_c * grad_out
    [n, L * 8, C] of n = n_rays * per_ray points in [0, 1]^3. order
    "uniform": independent uniform points; "rays": n_rays random rays, each
    per_ray consecutive samples at the march step 2 sqrt(3) / 256 of the
    [-1, 1] cube (half that in these coordinates), in (ray, slot) order as
    the compaction packs them."""
    from laenerf_tpu_torch.ops.hashgrid import _octo_corners

    n = n_rays * per_ray
    g = torch.Generator(device=dev).manual_seed(1)
    if order == "uniform":
        u = torch.rand((n, 3), generator=g, device=dev)
    else:
        step = math.sqrt(3.0) / 256
        reach = step * (per_ray - 1)
        start = reach + (1 - 2 * reach) * torch.rand((n_rays, 1, 3),
                                                     generator=g, device=dev)
        d = torch.randn((n_rays, 1, 3), generator=g, device=dev)
        d = d / d.norm(dim=-1, keepdim=True)
        slots = torch.arange(per_ray, device=dev)[None, :, None]
        u = (start + step * slots * d).reshape(n, 3)
    idx, w = _octo_corners(spec, u)
    grad_out = torch.randn((n, spec.num_levels, spec.level_dim),
                           generator=g, device=dev)
    rows = (w[..., None] * grad_out[:, :, None, :]).to(torch.bfloat16)
    return idx.reshape(n, -1), rows.reshape(n, -1, spec.level_dim)


def k1_reds(idx, table_rows, C):
    """A model of the atomic adds K1 issues on idx, computed on the host
    from the input (not read from the card): one per run of one in-range
    row that a lane sums down a column of a 2-D idx within a span of
    RUN_SPAN rows, one per in-range row of a 1-D idx, for each group of 4
    channels."""
    from laenerf_tpu_torch.ops.scatter_add import RUN_SPAN

    keep = (idx >= 0) & (idx < table_rows)
    starts = torch.ones_like(keep)
    if idx.dim() == 2:
        starts[1:] = idx[1:] != idx[:-1]
        starts[::RUN_SPAN] = True
    return int((keep & starts).sum()) * -(-C // 4)


@contextlib.contextmanager
def k1_span(span):
    """K1 with `span` rows a lane walks down a 2-D idx's column, for the
    comparisons that choose RUN_SPAN; restored on exit."""
    from laenerf_tpu_torch.ops import scatter_add

    kept = scatter_add.RUN_SPAN
    scatter_add.RUN_SPAN = span
    try:
        yield
    finally:
        scatter_add.RUN_SPAN = kept


def phase_k1(card, dev, model_cfg):
    from laenerf_tpu_torch.ops.hashgrid import hashgrid_encode
    from laenerf_tpu_torch.ops.scatter_add import (scatter_add_rows,
                                                   scatter_add_rows_plain)

    worst = 0.0
    for name, idx, g, T in k1_cases(dev):
        for precision in ("f32", "bf16"):
            got = scatter_add_rows(idx, g, T, precision=precision)
            ref = scatter_add_rows_plain(idx, g, T, precision=precision)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            worst = max(worst, (got - ref).abs().max().item())
            if not err < REL_TOL:
                raise AssertionError(f"K1 {name} {precision}: rel err {err}")
    empty = scatter_add_rows(torch.zeros(0, dtype=torch.int32, device=dev),
                             torch.zeros(0, 4, device=dev), 100)
    if empty.shape != (100, 4) or empty.abs().max().item() != 0.0:
        raise AssertionError("K1 Q == 0 must return zeros")
    # bf16 out: the f32 sum rounded once, so within half a bf16 ulp (2^-8
    # relative) of the plain f32 sum, up to the atomics' sum order
    idx, g, T = k1_cases(dev)[0][1:]
    bf = scatter_add_rows(idx, g, T, precision="bf16",
                          out_dtype=torch.bfloat16)
    ref = scatter_add_rows_plain(idx, g, T, precision="bf16")
    bound = ref.abs() * 2.0 ** -8 + REL_TOL * ref.abs().max()
    if bf.dtype != torch.bfloat16 or not bool(
            ((bf.float() - ref).abs() <= bound).all()):
        raise AssertionError("K1 bf16 out must be the f32 sum rounded once")
    phase("k1", f"test cases: f32 and bf16 rows within rel {REL_TOL} of "
                f"index_add_, Q == 0 and bf16-out ok")

    spec = model_cfg.grid_spec
    T = spec.table_rows
    inputs = k1_main_path(card, dev, spec)
    uniform = inputs[0]

    # the hash-grid backward through K1 on the card against the same
    # backward on the CPU (the plain scatter-add)
    gen = torch.Generator().manual_seed(2)
    table = torch.rand((T, spec.level_dim), generator=gen) - 0.5
    x = torch.rand((4096, 3), generator=gen) * 2.2 - 1.1
    cot = torch.randn((4096, spec.output_dim), generator=gen)
    grads = []
    for d in (dev, torch.device("cpu")):
        tt = table.to(d).requires_grad_(True)
        (hashgrid_encode(tt, x.to(d), spec) * cot.to(d)).sum().backward()
        grads.append(tt.grad.cpu())
    err_bwd = rel_err(grads[0], grads[1])
    if not err_bwd < REL_TOL:
        raise AssertionError(f"hash-grid backward card vs CPU: {err_bwd}")
    phase("k1", f"hash-grid backward on the card vs CPU: rel err "
                f"{err_bwd:.2e}")
    return {"max_abs_err": max([worst] + [r["max_abs_err"] for r in inputs]),
            **{k: uniform[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "device_ms",
                                       "library_device_ms")},
            "sites": inputs}


def k1_f64(idx, rows, T, precision="bf16", magnitudes=False):
    """The sum K1 computes, in float64: each in-range row rounded as
    `precision` says (bf16, or f32 as it is), or its |value| with
    magnitudes, added with index_add_ on float64."""
    C = rows.shape[-1]
    i = idx.reshape(-1).long()
    r = (rows.to(torch.bfloat16) if precision == "bf16" else
         rows.float()).reshape(-1, C).double()
    keep = (i >= 0) & (i < T)
    r = r[keep].abs() if magnitudes else r[keep]
    return torch.zeros((T, C), dtype=torch.float64,
                       device=rows.device).index_add_(0, i[keep], r)


def k1_site(card, dev, site, idx, rows, T, what, cancels=False,
            precision="bf16"):
    """K1 on one input (idx, rows into T rows, rounded as `precision`
    says), and its plain version, each held against the same sum in
    float64 (k1_f64): K1 within rel REL_TOL, both errors printed. Timed
    against the plain version and index_add_ (in turns, CUDA events) beside
    its bound, and under the profiler; with the RED count that k1_reds
    models. Prints one line and returns the site's entry.

    The error is relative to the largest |sum|, or with `cancels` to the
    largest sum of |rows| into one table row: where a row's terms cancel
    (a trained NeRF's gradients of both signs), the summation order's
    error scales with the magnitudes summed, not with what is left."""
    from laenerf_tpu_torch.ops.scatter_add import (scatter_add_rows,
                                                   scatter_add_rows_plain)

    got = scatter_add_rows(idx, rows, T, precision=precision)
    plain = scatter_add_rows_plain(idx, rows, T, precision=precision)
    torch.cuda.synchronize()
    ref = k1_f64(idx, rows, T, precision)
    scale = (k1_f64(idx, rows, T, precision, magnitudes=True) if cancels
             else ref.abs()).max().item() + 1e-30
    err = (got.double() - ref).abs().max().item() / scale
    err_plain = (plain.double() - ref).abs().max().item() / scale
    max_abs_err = (got.double() - ref).abs().max().item()
    del ref, plain
    if not err < REL_TOL:
        raise AssertionError(
            f"K1 {site}: rel err {err} against the float64 sum (the plain "
            f"version's {err_plain}), of the largest "
            f"{'sum of magnitudes' if cancels else 'sum'}")
    C = rows.shape[-1]
    idx64, rows32 = idx.reshape(-1).long(), rows.reshape(-1, C).float()

    def k1():
        scatter_add_rows(idx, rows, T, precision=precision)

    def plain():
        scatter_add_rows_plain(idx, rows, T, precision=precision)

    def library():
        torch.zeros((T, C), device=dev).index_add_(0, idx64, rows32)

    # in turns on one card: plain, library, kernel, kernel, library, plain
    t = [cuda_ms(f) for f in (plain, library, k1, k1, library, plain)]
    ms, library_ms, plain_ms = ((t[2] + t[3]) / 2, (t[1] + t[4]) / 2,
                                (t[0] + t[5]) / 2)
    (dev_ms, kernel_ms), dev_library_ms = (
        device_ms(k1, name="scatter_add_rows_kernel"), device_ms(library))
    # each input read once, the [T, C] f32 output written once; one f32
    # add per update element
    bound_ms, bound_by = bound_of(
        idx.numel() * 4 + rows.numel() * rows.element_size() + T * C * 4,
        n_ops=rows.numel())
    reds = k1_reds(idx, T, C)
    width = "float4" if C % 4 == 0 else ("float2" if C % 2 == 0 else
                                         "scalar")
    phase(what, f"K1 {site}: {idx.numel()} rows x C={C} "
                f"{'bf16' if precision == 'bf16' else 'f32'} as "
                f"{list(idx.shape)} into {T} rows, rel err against the "
                f"float64 sum: K1 {err:.2e}, plain version {err_plain:.2e} "
                f"(of the largest "
                f"{'sum of magnitudes' if cancels else 'sum'}; K1 held to "
                f"{REL_TOL}), {reds} {width} REDs as k1_reds models them "
                f"(computed from the input, not measured; "
                f"{idx.numel() * C} scalar elements); K1 {ms:.4f} ms vs "
                f"plain {plain_ms:.4f} ms, index_add_ alone "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                f"device time under the profiler: K1 {dev_ms} ms "
                f"(scatter_add_rows_kernel {kernel_ms} ms, the rest the "
                f"zero-fill), index_add_ {dev_library_ms} ms ({card})")
    return {"site": site, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "device_ms": dev_ms,
            "kernel_device_ms": kernel_ms,
            "library_device_ms": dev_library_ms,
            "max_abs_err": max_abs_err, "rel_err": err,
            "plain_rel_err": err_plain}


def k1_main_path(card, dev, spec):
    """K1 at the main-path shape on the uniform and the ray-ordered input
    (main_path_rows), through k1_site."""
    T = spec.table_rows
    return [k1_site(card, dev, order, *main_path_rows(spec, dev, order), T,
                    "k1")
            for order in ("uniform", "rays")]


def gather_sites(dev):
    """(site, kernel, TPU kernel it replaces, args, kwargs, queries) at the
    full width of every call site of rows 1-8 of PERF.md's kernel table."""
    from laenerf_tpu_torch.ops.gather import grid_probe, take_lanes, take_rows

    g = torch.Generator(device=dev).manual_seed(5)
    f32, i32, i8 = torch.float32, torch.int32, torch.int8

    def ri(high, shape, dtype=i32):
        return torch.randint(0, high, shape, generator=g, device=dev,
                             dtype=dtype)

    def table(shape, dtype, high=2):
        if dtype == f32:
            return torch.randn(shape, generator=g, device=dev)
        return ri(high, shape, dtype)

    mp, mg = "perf/microbench_pallas.py", "perf/microbench_gather.py"
    sites = []
    for site, dtype, Q, tpu in (("P1", f32, 4096, f"{mp}:77"),
                                ("P2", i8, 4096, f"{mp}:99"),
                                ("P2b", i32, 4096, f"{mp}:77"),
                                ("G", f32, 8192, f"{mg}:174"),
                                ("G2", f32, 8192, f"{mg}:200")):
        sites.append((site, take_rows, tpu,
                      (table((4096, 128), dtype), ri(4096, (Q, 128))), {},
                      Q * 128))
    sites.append(("P3", take_lanes, f"{mp}:138",
                  (table((4096, 128), f32), ri(128, (4096, 128))), {},
                  4096 * 128))
    for rows, lanes in ((8, 262144), (16, 131072), (64, 32768),
                        (128, 16384)):
        sites.append((f"P3x[{rows}x{lanes}]", take_lanes, f"{mp}:230",
                      (table((rows, lanes), i8, 8), ri(lanes, (1, 16384))),
                      {}, 16384))
    for site, dtype in (("P4", i32), ("P4b", i8)):
        sites.append((site, grid_probe, f"{mp}:167",
                      (table((16384, 128), dtype), ri(16384, (16384,)),
                       ri(128, (16384,))), {"lanes": 128}, 16384))
    sites.append(("P6", grid_probe, f"{mp}:261",
                  (table((8, 262144), i8, 8), ri(8, (16384,)),
                   ri(262144, (16384,))), {"out_dtype": i32}, 16384))
    return sites


def gather_library_and_cells(kernel, args, kw):
    """The one PyTorch call that computes the kernel's function on the same
    inputs (int64 indices, made once), and the flat table element each
    output reads."""
    tbl = args[0]
    if kernel.__name__ == "take_rows":
        rows = args[1].long()
        W = tbl.shape[1]
        return (lambda: torch.gather(tbl, 0, rows),
                rows * W + torch.arange(W, device=tbl.device))
    if kernel.__name__ == "take_lanes":
        R, L = tbl.shape
        idx = args[1].long().expand(R, -1)
        return (lambda: torch.gather(tbl, 1, idx),
                torch.arange(R, device=tbl.device)[:, None] * L + idx)
    lanes = kw.get("lanes", 1)
    row = args[1].long()[:, None].expand(-1, lanes)
    col = args[2].long()[:, None].expand(-1, lanes)
    # advanced indexing gives the grid's dtype: P6's cast to int32 is left
    # out of the library call
    return lambda: tbl[row, col], row * tbl.shape[1] + col


def phase_gather(card, dev):
    from laenerf_tpu_torch.ops import gather

    plains = {gather.take_rows: gather.take_rows_plain,
              gather.take_lanes: gather.take_lanes_plain,
              gather.grid_probe: gather.grid_probe_plain}
    results = []
    for site, kernel, tpu, args, kw, queries in gather_sites(dev):
        got = kernel(*args, **kw)
        ref = plains[kernel](*args, **kw)
        library, cells = gather_library_and_cells(kernel, args, kw)
        lib = library()
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(
                got, lib.to(got.dtype).reshape(got.shape))):
            raise AssertionError(f"{kernel.__name__} {site}: differs from "
                                 f"its plain version or the library call")
        max_abs = (got.double() - ref.double()).abs().max().item()
        # bytes that must move: every index and output byte once, and the
        # table's distinct 32-byte sectors that this run's indices touch
        tbl = args[0]
        sectors = torch.unique(cells.reshape(-1) * tbl.element_size()
                               // SECTOR).numel()
        n_bytes = (sum(a.numel() * a.element_size() for a in args[1:])
                   + got.numel() * got.element_size()
                   + min(sectors * SECTOR, tbl.numel() * tbl.element_size()))
        bound_ms, bound_by = bound_of(n_bytes)

        def run():
            kernel(*args, **kw)

        def plain():
            plains[kernel](*args, **kw)

        # in turns on one card: plain, library, kernel, kernel, library, plain
        t = [cuda_ms(f) for f in (plain, library, run, run, library, plain)]
        ms, library_ms, plain_ms = ((t[2] + t[3]) / 2, (t[1] + t[4]) / 2,
                                    (t[0] + t[5]) / 2)
        dev_ms, dev_library_ms = device_ms(run), device_ms(library)
        results.append({"site": site, "kernel": kernel.__name__,
                        "replaces": tpu, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": n_bytes,
                        "device_ms": dev_ms,
                        "library_device_ms": dev_library_ms,
                        "max_abs_err": max_abs})
        phase("gather", f"{kernel.__name__} {site} ({tpu}): equal to plain "
                        f"and library; {ms:.4f} ms ({1e6 * ms / queries:.4f} "
                        f"ns/query) vs library {library_ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                        f"({n_bytes} B, {bound_by}); device time under the "
                        f"profiler: kernel {dev_ms} ms, library "
                        f"{dev_library_ms} ms ({card})")
    calls = gather_ragged(dev, plains)
    phase("gather", f"ragged shapes (take_rows W 1, 3, 8, 17, 128, 200; "
                    f"take_lanes N 1, 15, 17, 777, 16384, one-row tables, "
                    f"broadcast and per-row idx; grid_probe lanes 1, 3, 4, "
                    f"16, 17, 128; tables and indices as views 4 bytes into "
                    f"their storage; f32, int32, int8, int8->int32): calls "
                    f"{calls}, each equal to plain and the library call")
    return results


def gather_ragged(dev, plains):
    """K2, K3 and K4 at ragged shapes, untimed: widths, N and lanes off the
    16-byte chunks (the kernels' scalar path), one-row tables, and tables
    and index arrays as contiguous views 4 bytes into their storage (index
    views take the scalar path too), for each dtype; each call equal to
    its plain version and to the PyTorch call for the same function.
    Returns the number of calls per kernel."""
    from laenerf_tpu_torch.ops.gather import grid_probe, take_lanes, take_rows

    gen = torch.Generator(device=dev).manual_seed(9)
    i8, i32 = torch.int8, torch.int32

    def view(shape, dtype, offset, high=None):
        """Random values of shape, as a view `offset` bytes into its
        storage."""
        k = offset // torch.tensor([], dtype=dtype).element_size()
        n = math.prod(shape) + k
        if high is not None:
            flat = torch.randint(0, high, (n,), generator=gen, device=dev,
                                 dtype=dtype)
        elif dtype == torch.float32:
            flat = torch.randn(n, generator=gen, device=dev)
        else:
            flat = torch.randint(-128, 128, (n,), generator=gen, device=dev,
                                 dtype=dtype)
        return flat[k:].view(shape)

    cases = []
    for dtype in (torch.float32, i32, i8):
        for off in (0, 4):
            for R, Q, W in ((300, 5, 1), (300, 7, 3), (1, 9, 8),
                            (4096, 100, 17), (70, 33, 200), (50, 64, 128)):
                cases.append((take_rows, (view((R, W), dtype, off),
                                          view((Q, W), i32, off, R)), {}))
            for R, N, L in ((1, 17, 300), (3, 777, 5000), (64, 15, 40),
                            (2, 1, 1), (5, 16384, 70000)):
                for idx_rows in (1, R):
                    cases.append((take_lanes, (
                        view((R, L), dtype, off),
                        view((idx_rows, N), i32, off, L)), {}))
    for din, dout in ((torch.float32, torch.float32), (i32, i32), (i8, i8),
                      (i8, i32)):
        for off in (0, 4):
            for R, C, Q, lanes in ((40, 30, 1000, 1), (40, 30, 1000, 3),
                                   (8, 2000, 500, 4), (64, 64, 100, 16),
                                   (1, 5, 17, 17), (4096, 96, 333, 128)):
                cases.append((grid_probe, (
                    view((R, C), din, off), view((Q,), i32, off, R),
                    view((Q,), i32, off, C)),
                    {"lanes": lanes, "out_dtype": dout}))
    calls = dict.fromkeys((k.__name__ for k, _, _ in cases), 0)
    for kernel, args, kw in cases:
        got = kernel(*args, **kw)
        lib = gather_library_and_cells(kernel, args, kw)[0]()
        if not (torch.equal(got, plains[kernel](*args, **kw)) and torch.equal(
                got, lib.to(got.dtype).reshape(got.shape))):
            raise AssertionError(
                f"{kernel.__name__} ragged {[tuple(a.shape) for a in args]} "
                f"{[a.dtype for a in args]} offsets "
                f"{[a.storage_offset() for a in args]} {kw}: differs from "
                f"its plain version or the library call")
        calls[kernel.__name__] += 1
    return calls


def phase_probes(card):
    """The gather-probe entry points, as a user runs them, on the card."""
    from laenerf_tpu_torch.ops.gather import grid_probe, take_lanes, take_rows
    from laenerf_tpu_torch.perf import microbench_gather, microbench_pallas

    kernels = (take_rows, take_lanes, grid_probe)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    rows = {**microbench_pallas.main(["--n", "16"]),
            **microbench_gather.main(["--n", "16"])}
    launches = {k.__name__: k.launches for k in kernels}
    bad = [label for label, sec in rows.items()
           if not (math.isfinite(sec) and sec > 0)]
    if bad:
        raise AssertionError(f"probe rows without a time: {bad}")
    if not all(launches.values()):
        raise AssertionError(f"a gather kernel did not launch on the probe "
                             f"path: {launches}")
    phase("probes", f"{len(rows)} probe rows in "
                    f"{time.perf_counter() - t0:.1f} s; launches {launches} "
                    f"({card})")
    return launches


def tensor_bytes(args):
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


def longest_run(qs):
    """The most updates of one row in a row of sorted rows."""
    if not qs.numel():
        return 0
    return int(torch.unique_consecutive(qs, return_counts=True)[1].max())


def k5_skewed(idx, g, tile, n_tiles):
    """K5 on idx with every update of the heaviest tile moved onto 3 of
    its rows (first, middle, last, by update number), against its plain
    version; returns the longest run and the heavy tile's count."""
    from laenerf_tpu_torch.ops.sorted_scatter import (sort_stage,
                                                      tile_scatter,
                                                      tile_scatter_plain)

    tile_of = idx // tile
    heavy = int(torch.bincount(tile_of.long(), minlength=n_tiles).argmax())
    mine = tile_of == heavy
    q = torch.arange(idx.shape[0], device=idx.device, dtype=idx.dtype)
    three = torch.tensor([0, tile // 2, tile - 1], device=idx.device,
                         dtype=idx.dtype)
    skewed = torch.where(mine, heavy * tile + three[q % 3], idx)
    qs, gs, lo = sort_stage(skewed, g, tile, n_tiles)
    got, ref = tile_scatter(qs, gs, lo, tile), tile_scatter_plain(qs, gs, lo,
                                                                  tile)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    if not err < REL_TOL:
        raise AssertionError(f"K5 skewed (heaviest tile on 3 rows): rel err "
                             f"{err}")
    return longest_run(qs), int(mine.sum()), err


def k6_hand_made(qs, gs, wt, wb, wreal, tile, maxu, n_tiles):
    """K6 on the heaviest tile's items alone, its middle item listed
    twice (so its updates add twice), against its plain version; returns
    the item count and the rel err."""
    from laenerf_tpu_torch.ops.sorted_scatter import (worklist_scatter,
                                                      worklist_scatter_plain)

    real = wreal != 0
    heavy = int(torch.bincount(wt[real].long(), minlength=n_tiles).argmax())
    mine = torch.nonzero(real & (wt == heavy)).flatten()
    pick = torch.cat([mine, mine[len(mine) // 2:][:1]])
    args = (qs, gs, wt[pick], wb[pick], wreal[pick], tile, maxu, n_tiles)
    got, ref = worklist_scatter(*args), worklist_scatter_plain(*args)
    torch.cuda.synchronize()
    err = rel_err(got, ref)
    if not err < REL_TOL:
        raise AssertionError(f"K6 hand-made list (the heaviest tile's items, "
                             f"one twice): rel err {err}")
    return len(mine), err


def phase_scatter(card, dev):
    """K5 and K6 at the full shapes of rows 10-12 of the kernel table."""
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.ops.sorted_scatter import (
        build_worklist, sort_stage, tile_scatter,
        tile_scatter_plain, work_sizes, worklist_scatter,
        worklist_scatter_plain)
    from laenerf_tpu_torch.perf.scatter_inputs import (FULL, FULL_2048,
                                                       make_inputs)

    t0 = time.perf_counter()
    idx_np, g_np = make_inputs(FULL)
    idx = torch.from_numpy(idx_np).to(dev)
    g = torch.from_numpy(g_np).to(dev)
    idx64 = idx.long()
    Q, C = g.shape
    phase("scatter", f"inputs: {Q} updates of C={C} into {FULL.T} rows "
                     f"(perf/scatter_inputs.py) in "
                     f"{time.perf_counter() - t0:.1f} s")
    results = []
    for site, kernel, shape, dtype, tpu in (
            ("row 10 K5 f32 tile 1024", tile_scatter, FULL, torch.float32,
             "perf/microbench_scatter2.py:137"),
            ("row 11 K6 f32 tile 1024", worklist_scatter, FULL,
             torch.float32, "perf/probe_worklist.py:71"),
            ("row 12 K6 bf16 tile 2048", worklist_scatter, FULL_2048,
             torch.bfloat16, "perf/probe_worklist2.py:71")):
        tile, maxu = shape.tile, shape.maxu
        sizes = work_sizes(Q, shape.T, tile, maxu)
        rows = g.to(dtype)
        qs, gs, lo = sort_stage(idx, rows, tile, sizes.n_tiles)
        if kernel is tile_scatter:
            args, plain = (qs, gs, lo, tile), tile_scatter_plain
        else:
            wt, wb, _, wreal = build_worklist(lo, maxu, sizes.w_cap,
                                              sizes.q_blks)
            args = (qs, gs, wt, wb, wreal, tile, maxu, sizes.n_tiles)
            plain = worklist_scatter_plain
        rows32 = rows.float()
        precision = "f32" if dtype == torch.float32 else "bf16"

        def run():
            return kernel(*args)

        def plain_run():
            return plain(*args)

        def library():
            return torch.zeros((sizes.t_pad, C), device=dev).index_add_(
                0, idx64, rows32)

        def k1():
            return scatter_add_rows(idx, rows, sizes.t_pad,
                                    precision=precision)

        got, ref, lib, k1_out = run(), plain_run(), library(), k1()
        torch.cuda.synchronize()
        errs = {"plain": rel_err(got, ref), "index_add_": rel_err(got, lib),
                "K1 vs index_add_": rel_err(k1_out, lib)}
        if not all(e < REL_TOL for e in errs.values()):
            raise AssertionError(f"{site}: rel errs {errs}")
        max_abs = (got - ref).abs().max().item()
        cnt = lo[1:] - lo[:-1]
        n_bytes = tensor_bytes(args) + got.numel() * got.element_size()
        # one f32 add per update element
        bound_ms, bound_by = bound_of(n_bytes, n_ops=Q * C)
        # in turns on one card
        t = [cuda_ms(f) for f in (plain_run, library, k1, run, run, k1,
                                  library, plain_run)]
        ms, k1_ms = (t[3] + t[4]) / 2, (t[2] + t[5]) / 2
        library_ms, plain_ms = (t[1] + t[6]) / 2, (t[0] + t[7]) / 2
        dev_t = {name: device_ms(f) for name, f in
                 (("kernel", run), ("library", library), ("k1", k1))}
        results.append({"site": site, "kernel": kernel.__name__,
                        "replaces": tpu, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "k1_ms": k1_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": n_bytes, "device_ms": dev_t["kernel"],
                        "library_device_ms": dev_t["library"],
                        "k1_device_ms": dev_t["k1"], "max_abs_err": max_abs})
        phase("scatter", f"{site} ({tpu}): {kernel.__name__} rel err "
                         f"{errs['plain']:.2e} vs plain, "
                         f"{errs['index_add_']:.2e} vs index_add_ of the "
                         f"unsorted updates; {sizes.n_tiles} tiles, largest "
                         f"{int(cnt.max())} updates, {int((cnt == 0).sum())} "
                         f"empty, longest run {longest_run(qs)}; "
                         f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                         f"index_add_ {library_ms:.4f} ms, K1 on the unsorted "
                         f"updates {k1_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({n_bytes} B, {bound_by}); device time under the "
                         f"profiler: kernel {dev_t['kernel']} ms, index_add_ "
                         f"{dev_t['library']} ms, K1 {dev_t['k1']} ms "
                         f"({card})")
        if kernel is tile_scatter:
            run_len, n_heavy, err = k5_skewed(idx, rows, tile, sizes.n_tiles)
            phase("scatter", f"{site} skewed: the heaviest tile's {n_heavy} "
                             f"updates on 3 of its rows (longest run "
                             f"{run_len}): rel err {err:.2e} vs plain")
        else:
            n_items, err = k6_hand_made(*args)
            phase("scatter", f"{site} hand-made list: the heaviest tile's "
                             f"{n_items} items, one listed twice: rel err "
                             f"{err:.2e} vs plain")
    return results


def construct_library(fn, args):
    """The one PyTorch call that computes a K7 construct's function on the
    same inputs (index tensors and the kept one-hot rows made once, views
    free), or None where no single call does: k5's loop (a clamp, then a
    repeat) and k7's iota (an arange, then a repeat; it has no input). Where
    the construct casts int32 to f32 (k1, k4), the cast is left out."""
    from laenerf_tpu_torch.ops import construct_probes as cp

    name = fn.__name__
    if name == "prefetch_write":
        lo, n, tile, C = args
        lo_rows = lo[:n, None].expand(n, C)
        return lambda: torch.repeat_interleave(lo_rows, tile, dim=0)
    if name == "static_copy":
        g, n, tile = args
        head = g[:tile]
        return lambda: head.repeat(n, 1)
    if name in ("dynamic_copy", "copy_1d"):
        src, lo, n, tile = args[:4]
        rows = (lo[:n].long()[:, None]
                + torch.arange(tile, device=src.device)).reshape(-1)
        if name == "dynamic_copy":
            return lambda: torch.index_select(src, 0, rows)
        cells = rows[:, None].expand(-1, args[4])
        return lambda: torch.take(src, cells)
    if name == "onehot_dot":
        local, g, tile = args
        n, _, C = g.shape
        loc = local.long()
        keep = (loc >= 0) & (loc < tile)
        rows = (loc + torch.arange(n, device=g.device)[:, None] * tile)[keep]
        vals = g[keep].float()
        return lambda: torch.zeros((n * tile, C), device=g.device).index_add_(
            0, rows, vals)
    if fn in (cp.dynamic_loop, cp.iota_rows):
        return None
    raise ValueError(f"no library rule for {name}")


def phase_constructs(card, dev):
    """K7: every construct equal to its plain version and to its library
    call, where it has one, on the script's inputs and on random ones;
    timed on the random ones, and k5 also on the script's trips."""
    from laenerf_tpu_torch.ops.construct_probes import (PLAIN, dynamic_loop,
                                                        onehot_dot)
    from laenerf_tpu_torch.perf import bisect_mosaic

    results = []
    for seed in (None, 7):
        for label, tpu, fn, args in bisect_mosaic.cases(dev, seed):
            got, ref = fn(*args), PLAIN[fn](*args)
            library = construct_library(fn, args)
            lib = library() if library else None
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K7 {label} (seed {seed}) differs "
                                     f"from its plain version")
            if lib is not None and not torch.equal(
                    got, lib.to(got.dtype).reshape(got.shape)):
                raise AssertionError(f"K7 {label} (seed {seed}) differs "
                                     f"from its library call")
            site = label
            if seed is None:
                if fn is not dynamic_loop:
                    continue
                site = f"{label}, {int(args[0][0])} trips"
            n_bytes = tensor_bytes(args) + got.numel() * got.element_size()
            n_ops, dense = 0, 0
            if fn is onehot_dot:
                # the product's terms that this run's one-hot holds, and
                # the dense [tile, maxu] @ [maxu, C] product beside them
                local, g, tile = args
                n_ops = 2 * int(((local >= 0) & (local < tile)).sum()) \
                    * g.shape[2]
                dense = 2 * local.shape[0] * tile * local.shape[1] \
                    * g.shape[2]
            bound_ms, bound_by = bound_of(n_bytes, n_ops, BF16_TC_OPS_PER_S)

            def run():
                fn(*args)

            def plain():
                PLAIN[fn](*args)

            # in turns on one card: plain, library, kernel, kernel,
            # library, plain (no library turns where there is none)
            t = [cuda_ms(f) if f else None
                 for f in (plain, library, run, run, library, plain)]
            ms, plain_ms = (t[2] + t[3]) / 2, (t[0] + t[5]) / 2
            library_ms = (t[1] + t[4]) / 2 if library else None
            dev_ms = device_ms(run)
            dev_library_ms = device_ms(library) if library else None
            results.append({"site": site, "kernel": fn.__name__,
                            "replaces": tpu, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "bytes": n_bytes,
                            "device_ms": dev_ms,
                            "library_device_ms": dev_library_ms,
                            "max_abs_err": 0.0})
            extra = (f", dense product {dense / 1e9:.2f} GFLOP = "
                     f"{1e3 * dense / BF16_TC_OPS_PER_S:.4f} ms at the bf16 "
                     f"tensor-core peak" if dense else "")
            lib_msg = (f"library {library_ms:.4f} ms" if library else
                       "no single library call")
            equal = "plain and library" if library else "plain"
            phase("constructs", f"{site} ({tpu}): equal to {equal} on the "
                                f"script's and random inputs; {ms:.4f} ms "
                                f"vs plain "
                                f"{plain_ms:.4f} ms, {lib_msg}, bound "
                                f"{bound_ms:.5f} ms ({n_bytes} B, {n_ops} "
                                f"ops, {bound_by}){extra}; device time "
                                f"under the profiler: kernel {dev_ms} ms, "
                                f"library {dev_library_ms} ms ({card})")

    # k6b skewed, a check only: all 1,024 columns of each tile on one row
    # (one window of each tile holds every column), small integer rows
    n_tiles, tile, maxu, C = (bisect_mosaic.N_TILES, bisect_mosaic.TILE,
                              bisect_mosaic.MAXU, 128)
    gen = torch.Generator(device=dev).manual_seed(8)
    local = (torch.arange(n_tiles, device=dev, dtype=torch.int32)[:, None]
             * 146 % tile).expand(-1, maxu).contiguous()
    g = torch.randint(-8, 9, (n_tiles, maxu, C), generator=gen,
                      device=dev).bfloat16()
    if not torch.equal(onehot_dot(local, g, tile),
                       PLAIN[onehot_dot](local, g, tile)):
        raise AssertionError("K7 k6b skewed (every column of a tile on one "
                             "row) differs from its plain version")
    phase("constructs", f"k6b skewed: {n_tiles} tiles x {maxu} columns, "
                        f"each tile on one row, C={C}: equal to plain")
    calls = copy_1d_ragged(dev)
    phase("constructs", f"k4 edges (tiles 1, 65, 100, 300, 1000 and 1024; "
                        f"C 1, 4, 8, 12; offsets 0, len(q) - tile and 1, 2, "
                        f"3 mod 4): {calls} calls, each equal to plain and "
                        f"torch.take")
    calls = fill_ragged(dev)
    phase("constructs", f"k1, k5, k7 at ragged shapes (tile, C, n_tiles) "
                        f"{FILL_SHAPES}: {calls} calls, each equal to plain")
    return results


def fill_ragged(dev):
    """K7's fill kernels (k1, k5, k7) at FILL_SHAPES, untimed: tiles that
    start off 16 bytes, C off a float4, one-row tiles and more blocks than
    a wave; k1 on random values, k5 on trips -5, 0, 1, 3, 199 and 4,096
    among random ones. Each equal to its plain version. Returns the number
    of calls."""
    from laenerf_tpu_torch.ops.construct_probes import (PLAIN, dynamic_loop,
                                                        iota_rows,
                                                        prefetch_write)

    rng = np.random.RandomState(11)
    calls = 0
    for tile, C, n_tiles in FILL_SHAPES:
        trips = rng.randint(-5, 200, n_tiles)
        trips[:6] = (-5, 0, 1, 3, 199, 4096)
        values = rng.randint(-2 ** 24, 2 ** 24, n_tiles)
        for fn, args in (
                (prefetch_write, (torch.from_numpy(values.astype(np.int32))
                                  .to(dev), n_tiles, tile, C)),
                (dynamic_loop, (torch.from_numpy(rng.permutation(trips)
                                                 .astype(np.int32)).to(dev),
                                n_tiles, tile, C)),
                (iota_rows, (n_tiles, tile, C, dev))):
            if not torch.equal(fn(*args), PLAIN[fn](*args)):
                raise AssertionError(f"{fn.__name__} tile {tile} C {C} "
                                     f"n_tiles {n_tiles}: differs from its "
                                     f"plain version")
            calls += 1
    return calls


def copy_1d_ragged(dev):
    """k4 at the edges of its 64-row slices and 16-byte windows, untimed:
    tiles that are not a multiple of 64 rows, C = 1, 4, 8 and 12, one tile,
    the offsets of bisect_mosaic.edge_offsets; each equal to its plain
    version and to torch.take. Returns the number of calls."""
    from laenerf_tpu_torch.ops.construct_probes import copy_1d, copy_1d_plain
    from laenerf_tpu_torch.perf.bisect_mosaic import edge_offsets

    rng = np.random.RandomState(10)
    calls = 0
    for tile, C, n_tiles in ((1024, 8, 8), (100, 4, 5), (300, 12, 3),
                             (1000, 8, 1), (1, 1, 7), (65, 1, 4)):
        n_q = 4 * ((3 * tile + 8) // 4)
        q = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, n_q).astype(
            np.int32)).to(dev)
        for lo_np in edge_offsets(tile, n_tiles, n_q):
            lo = torch.from_numpy(lo_np).to(dev)
            got = copy_1d(q, lo, n_tiles, tile, C)
            rows = (lo[:n_tiles].long()[:, None]
                    + torch.arange(tile, device=dev)).reshape(-1)
            lib = torch.take(q, rows[:, None].expand(-1, C)).float()
            if not (torch.equal(got, copy_1d_plain(q, lo, n_tiles, tile, C))
                    and torch.equal(got, lib)):
                raise AssertionError(f"copy_1d tile {tile} C {C} n_tiles "
                                     f"{n_tiles} lo {lo_np.tolist()}: "
                                     f"differs from its plain version or "
                                     f"torch.take")
            calls += 1
    return calls


def phase_scatter_probes(card):
    """The four scatter entry points, as a user runs them, on the card."""
    from laenerf_tpu_torch.ops.construct_probes import PLAIN
    from laenerf_tpu_torch.ops.sorted_scatter import (tile_scatter,
                                                      worklist_scatter)
    from laenerf_tpu_torch.perf import (bisect_mosaic, microbench_scatter2,
                                        probe_worklist, probe_worklist2)

    constructs = tuple(PLAIN)
    for k in (tile_scatter, worklist_scatter) + constructs:
        k.launches = 0
    t0 = time.perf_counter()
    rows = [script.main(["--n", "12"]) for script in
            (microbench_scatter2, probe_worklist, probe_worklist2)]
    bisect = bisect_mosaic.main(["--n", "16"])
    launches = {k.__name__: k.launches for k in
                (tile_scatter, worklist_scatter) + constructs}
    bad = [label for r in rows for label, sec in r.items()
           if not (math.isfinite(sec) and sec > 0)]
    if bad:
        raise AssertionError(f"probe rows without a time: {bad}")
    if not all(bisect.values()):
        raise AssertionError(f"bisect_mosaic: a construct failed {bisect}")
    if not all(launches.values()):
        raise AssertionError(f"a scatter or construct kernel did not launch "
                             f"on the probe path: {launches}")
    phase("probes", f"{sum(map(len, rows))} scatter probe rows and "
                    f"{len(bisect)} OK constructs in "
                    f"{time.perf_counter() - t0:.1f} s; launches {launches} "
                    f"({card})")
    return launches


def lego_occupancy(dev, H, sub=2):
    """The lego-class scene's occupancy [1, H, H, H] uint8 in the bound-1
    box, in the frame the provider's poses give (the blender scene's axes
    cycled and scaled by MARCH_SCALE): a cell is set where one of sub^3
    points inside it has density, as a trained grid's cells rise over the
    threshold where the scene has matter."""
    from laenerf_tpu_torch.data.synthetic import (lego_class_scene,
                                                  scene_density_color)

    g = ((torch.arange(H * sub, dtype=torch.float32, device=dev) + 0.5)
         / (H * sub) * 2 - 1)
    pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
    # ngp (x, y, z) = blender (y, z, x) * scale
    pts = pts[..., [2, 0, 1]].reshape(-1, 3) / MARCH_SCALE
    prims = lego_class_scene()
    sigma = torch.cat([scene_density_color(c, prims, device=dev)[0]
                       for c in pts.split(1 << 21)])
    dense = sigma.reshape(H, sub, H, sub, H, sub).amax(dim=(1, 3, 5))
    return (dense > 0).to(torch.uint8)[None]


def march_batches(dev, occ, cfg):
    """MARCH_VIEWS views' march inputs at the NeRF cell's batch."""
    from laenerf_tpu_torch.data.provider import nerf_matrix_to_ngp
    from laenerf_tpu_torch.data.rays import get_rays
    from laenerf_tpu_torch.data.synthetic import _look_at_pose
    from laenerf_tpu_torch.ops import raymarch

    rng = np.random.RandomState(20)
    focal = MARCH_HW / (2 * math.tan(0.4))
    intr = torch.tensor([focal, focal, MARCH_HW / 2, MARCH_HW / 2],
                        dtype=torch.float32, device=dev)
    aabb = torch.tensor([-cfg.bound] * 3 + [cfg.bound] * 3,
                        dtype=torch.float32, device=dev)
    out = []
    for v in range(MARCH_VIEWS):
        phi, theta = 2 * math.pi * v / MARCH_VIEWS, 0.7 + 0.5 * rng.rand()
        eye = 3.5 * np.array([math.sin(theta) * math.cos(phi),
                              math.sin(theta) * math.sin(phi),
                              math.cos(theta)])
        pose = torch.from_numpy(nerf_matrix_to_ngp(
            _look_at_pose(eye), scale=MARCH_SCALE)).to(dev)
        inds = torch.from_numpy(rng.choice(MARCH_HW * MARCH_HW, MARCH_RAYS,
                                           replace=False)).to(dev)
        ro, rd = get_rays(pose, intr, inds, MARCH_HW, MARCH_HW)
        nears, fars = raymarch.near_far_from_aabb(ro, rd, aabb)
        noises = torch.from_numpy(
            rng.rand(MARCH_RAYS).astype(np.float32)).to(dev)
        out.append((ro, rd, occ, nears, fars, noises, cfg))
    return out


def march_equal(got, ref):
    """K8's result against the plain loop's: valid, n_samples and t0 equal,
    ts and dts bit-equal on the valid slots and finite elsewhere."""
    v = ref["valid"]
    bad = [k for k in ("valid", "n_samples", "t0")
           if not torch.equal(got[k], ref[k])]
    bad += [k for k in ("ts", "dts") if not torch.equal(
        got[k].view(torch.int32)[v], ref[k].view(torch.int32)[v])]
    bad += [f"{k} not finite" for k in ("ts", "dts")
            if not bool(torch.isfinite(got[k]).all())]
    return bad


def phase_march(card, dev):
    """K8 at the NeRF cell's march against its plain loop (see the
    module's docstring); returns the kernel's entry of the last line."""
    from laenerf_tpu_torch.ops import cuda_build, raymarch
    from laenerf_tpu_torch.utils import timers

    t_phase = time.perf_counter()
    cfg = raymarch.MarchConfig(bound=1.0, cascades=1, grid_size=128,
                               max_steps=1024, march_iters=1024)
    occ = lego_occupancy(dev, cfg.grid_size)
    batches = march_batches(dev, occ, cfg)
    before = raymarch.march_rays_train.launches
    events, samples = [], []
    for i, args in enumerate(batches):
        got = raymarch.march_rays_train(*args)
        timers.start()
        ref = raymarch.march_rays_train_plain(*args)
        events.append(timers.stop()["counters"]["march.events"])
        samples.append(int(ref["n_samples"].sum()))
        bad = march_equal(got, ref)
        if bad:
            raise AssertionError(f"K8 differs from its plain loop in view "
                                 f"{i}: {bad}")
    phase("march", f"lego-class occupancy at 128^3: occ_frac "
                   f"{float(occ.float().mean()):.4f}; {MARCH_VIEWS} views of "
                   f"{MARCH_RAYS} rays: K8 equal to the plain loop (valid, "
                   f"n_samples, t0; ts and dts bit-equal where valid); "
                   f"plain events {events}, samples {samples}")

    ro, rd, occ, nears, fars, noises, cfg = batches[0]
    skip, t0 = raymarch._march_inputs(occ, nears, noises, cfg)

    def kernel():
        return raymarch._march_rays_cuda(ro, rd, skip, t0, fars, cfg)

    ms = cuda_ms(kernel)
    dev_total, dev_k8 = device_ms(kernel, name="march_rays_train_kernel")
    _, dev_unended = device_ms(kernel, name="march_unended_kernel")
    full_ms = cuda_ms(lambda: raymarch.march_rays_train(*batches[0]))
    plain_ms = cuda_ms(lambda: raymarch.march_rays_train_plain(*batches[0]),
                       reps=3)
    n_bytes = MARCH_RAYS * cfg.march_iters * 9  # ts, dts f32 + valid
    bound_ms, bound_by = bound_of(n_bytes)
    launches = raymarch.march_rays_train.launches - before
    ptxas = ptxas_kernels(cuda_build.build_info["raymarch.cu"]["ptxas"],
                          ("march_rays_train_kernel",
                           "march_unended_kernel"))
    phase("march", f"K8 at {MARCH_RAYS} rays x {cfg.march_iters} events: "
                   f"{ms:.4f} ms a call (CUDA events, with its allocations), "
                   f"device {dev_total} ms ({dev_k8} ms in the kernel, "
                   f"{dev_unended} ms in its unended pass); "
                   f"bound {1e3 * bound_ms:.2f} us ({n_bytes} B by "
                   f"{bound_by}); march_rays_train with its skip field "
                   f"{full_ms:.4f} ms; plain loop {plain_ms:.2f} ms; "
                   f"{launches} launches; ptxas "
                   + "; ".join(f"{n} {r} registers, {sp} B spill stores, "
                               f"{sm} B smem" for n, r, sp, sm in ptxas)
                   + f"; phase {time.perf_counter() - t_phase:.1f} s "
                   f"({card})")
    k8 = {"name": "march_rays_train", "route": "cuda",
          "source": "laenerf_tpu_torch/csrc/raymarch.cu",
          "replaces": "none (the plain loop of ops/raymarch.py; JAX's "
                      "lax.scan at laenerf_tpu/ops/raymarch.py:368)",
          "ms": ms, "device_ms": dev_k8, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "march_ms": full_ms}
    return k8, composite_at_march(card, dev, batches[0])


def composite_at_march(card, dev, batch):
    """K9 on a march batch's samples packed as the train path packs them
    (capacity K9_CAP), the lego-class scene's density and colour at them,
    through composite_check."""
    from laenerf_tpu_torch.data.synthetic import (lego_class_scene,
                                                  scene_density_color)
    from laenerf_tpu_torch.ops import raymarch
    from laenerf_tpu_torch.ops.compaction import packed_sample_indices

    t_phase = time.perf_counter()
    ro, rd, _, _, _, _, cfg = batch
    march = raymarch.march_rays_train(*batch)
    idx = packed_sample_indices(march["valid"], K9_CAP)
    ray = idx // cfg.march_iters
    ts = march["ts"].reshape(-1)[idx]
    dts = march["dts"].reshape(-1)[idx]
    xyz = raymarch.sample_positions(ro[ray], rd[ray], ts, cfg.bound)
    # ngp (x, y, z) = blender (y, z, x) * scale, as lego_occupancy
    sig, rgb = scene_density_color(xyz[:, [2, 0, 1]] / MARCH_SCALE,
                                   lego_class_scene(), device=dev)
    phase("march", f"K9's inputs in {time.perf_counter() - t_phase:.1f} s")
    return composite_check(card, dev, sig, rgb, dts, ts, march["n_samples"],
                           march["t0"], ray)


def composite_check(card, dev, sig, rgb, dts, ts, counts, t0, ray):
    """K9 over packed samples (ray [M]: each one's ray, counts [N] int32
    each ray's samples before the cut at K9_CAP) against its plain
    version, forward and backward from all three outputs; their times and
    byte bounds, the plain version's time and ptxas's report; returns the
    kernel's entry of the last line."""
    from laenerf_tpu_torch.ops import composite, cuda_build

    t_phase = time.perf_counter()
    args = (dts, ts, torch.cumsum(counts, 0), counts, t0, 1e-4)
    N, M = counts.shape[0], sig.shape[0]
    g = torch.Generator().manual_seed(9)
    cots = [torch.randn(shape, generator=g).to(dev)
            for shape in ((N,), (N,), (N, 3))]

    before = (composite.composite_rays_train_packed.launches,
              composite.composite_rays_train_packed_backward.launches)
    res = []
    for fn in (composite.composite_rays_train_packed,
               composite.composite_rays_train_packed_plain):
        s = sig.clone().requires_grad_(True)
        c = rgb.clone().requires_grad_(True)
        outs = fn(s, c, *args)
        torch.autograd.backward(outs, cots)
        res.append(([o.detach() for o in outs], s.grad, c.grad))
    (got, gs, gc), (ref, rs, rc) = res
    # a sigma gradient is a difference of terms up to dt * |dL/dw|
    cw, cd, ci = (c.abs().reshape(N, -1).sum(dim=1)[ray] for c in cots)
    delta = ((ts + dts) - t0[ray]).abs()
    scale = float((dts * (cw + cd * delta + ci * rgb.amax(dim=-1))).max())
    errs = [rel_err(a, b) for a, b in zip(got, ref)] + [rel_err(gc, rc)]
    sig_err = float((gs - rs).abs().max()) / scale
    if max(errs + [sig_err]) >= K9_TOL or float(ref[0].max()) <= 0.99:
        raise AssertionError(f"K9 differs from its plain version: relative "
                             f"errors of weights_sum, depth, image, the rgb "
                             f"gradient {errs}, the sigma gradient "
                             f"{sig_err}; largest weights_sum "
                             f"{float(ref[0].max())}")
    launched = (composite.composite_rays_train_packed.launches - before[0],
                composite.composite_rays_train_packed_backward.launches
                - before[1])
    if launched != (1, 1):
        raise AssertionError(f"K9 launched {launched} times (forward, "
                             f"backward) for one call")

    class Saved:  # stands in for autograd's context of one forward
        def set_materialize_grads(self, value):
            pass

        def save_for_backward(self, *tensors):
            self.saved_tensors = tensors

    ctx = Saved()
    composite._CompositePacked.forward(ctx, sig, rgb, *args)

    def forward():
        return composite.composite_rays_train_packed(sig, rgb, *args)

    def backward():
        return composite.composite_rays_train_packed_backward(
            *cots, *ctx.saved_tensors, 1e-4)

    def plain():
        s = sig.clone().requires_grad_(True)
        c = rgb.clone().requires_grad_(True)
        torch.autograd.backward(
            composite.composite_rays_train_packed_plain(s, c, *args), cots)

    fwd_ms, bwd_ms = cuda_ms(forward), cuda_ms(backward)
    fwd_dev = device_ms(forward, name="composite_forward_kernel")[1]
    bwd_dev = device_ms(backward, name="composite_backward_kernel")[1]
    plain_ms = cuda_ms(plain, reps=3)
    # forward: sigma, rgb, dt, t in, ends, counts, t0 in and weights_sum,
    # depth, image, n_open out; backward: the same samples, rgb and sigma
    # gradients out, the per-ray inputs, outputs and output gradients in
    fwd_bytes, bwd_bytes = M * 24 + N * 40, M * 40 + N * 64
    fwd_bound, fwd_by = bound_of(fwd_bytes)
    bwd_bound, bwd_by = bound_of(bwd_bytes)
    ptxas = ptxas_kernels(cuda_build.build_info["composite.cu"]["ptxas"],
                          ("composite_forward_kernel",
                           "composite_backward_kernel"))
    phase("march", f"K9 at {N} rays, {M} packed samples of "
                   f"{int(counts.sum())} (capacity {K9_CAP}, most "
                   f"{int(counts.max())} a ray): equal to its plain version "
                   f"(relative errors {max(errs):.3g}, sigma gradient "
                   f"{sig_err:.3g} of {scale:.4g}); forward {fwd_ms:.4f} ms "
                   f"a call (CUDA events), device {fwd_dev} ms, bound "
                   f"{1e3 * fwd_bound:.2f} us ({fwd_bytes} B by {fwd_by}); "
                   f"backward {bwd_ms:.4f} ms, device {bwd_dev} ms, bound "
                   f"{1e3 * bwd_bound:.2f} us ({bwd_bytes} B by {bwd_by}); "
                   f"plain forward and backward {plain_ms:.2f} ms; ptxas "
                   + "; ".join(f"{n} {r} registers, {sp} B spill stores, "
                               f"{sm} B smem" for n, r, sp, sm in ptxas)
                   + f"; {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"name": "composite_rays_train_packed", "route": "cuda",
            "source": "laenerf_tpu_torch/csrc/composite.cu",
            "replaces": "none (scatter_back and composite_rays_train over "
                        "the padded grid; JAX's at "
                        "laenerf_tpu/ops/composite.py)",
            "max_rel_err": max(errs + [sig_err]),
            "ms": fwd_ms + bwd_ms, "forward_ms": fwd_ms,
            "backward_ms": bwd_ms,
            "device_ms": (None if None in (fwd_dev, bwd_dev)
                          else fwd_dev + bwd_dev),
            "plain_ms": plain_ms, "bound_ms": fwd_bound + bwd_bound,
            "bound_by": "bytes" if "bytes" in (fwd_by, bwd_by)
            else "operations"}


def kernel_entry(name, source, results, launches):
    """One kernel's line entry: times and bounds summed over its call
    sites (one call at each), every site listed."""
    mine = [r for r in results if r["kernel"] == name]
    by_kind = {}
    for r in mine:
        by_kind[r["bound_by"]] = by_kind.get(r["bound_by"], 0.0) \
            + r["bound_ms"]
    libs = [r["library_ms"] for r in mine]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": ", ".join(dict.fromkeys(r["replaces"] for r in mine)),
        "launches": launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": sum(r["ms"] for r in mine),
        "plain_ms": sum(r["plain_ms"] for r in mine),
        "bound_ms": sum(by_kind.values()),
        "bound_by": max(by_kind, key=by_kind.get),
        "library_ms": None if None in libs else sum(libs),
        "sites": [{k: r.get(k) for k in (
            "site", "replaces", "ms", "plain_ms", "library_ms", "k1_ms",
            "bound_ms", "device_ms", "library_device_ms", "k1_device_ms")
            if k in r} for r in mine],
    }


def phase_train(card, dev, tmp):
    from laenerf_tpu_torch.data import NeRFDataset, generate_synthetic_scene
    from laenerf_tpu_torch.models import NeRFConfig, RenderConfig
    from laenerf_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    # two test views: the recolor, style and LPIPS phases render each
    # several times (the train split is drawn first, so it is unchanged)
    generate_synthetic_scene(tmp, n_train=16, n_val=1, n_test=2, H=100,
                             W=100, device=dev)
    ds = NeRFDataset(tmp, "train", num_rays=4096)
    phase("train", f"synthetic scene: {len(ds)} views {ds.H}x{ds.W} in "
                   f"{time.perf_counter() - t0:.1f} s")
    model_cfg = NeRFConfig(bound=1.0, num_levels=8, level_dim=4,
                           log2_hashmap_size=19)
    render_cfg = RenderConfig(bound=1.0, cascades=1, grid_size=128,
                              max_steps=256, march_iters=256,
                              m_cap_per_ray=16, density_thresh=10.0,
                              infer_chunk_events=16, infer_compact_factor=4)
    tr = Trainer(model_cfg, render_cfg, device=dev, lr=1e-2, iters=2000,
                 eval_chunk=16384, workspace=f"{tmp}/ws")
    tr.mark_untrained(ds)
    losses, step_s, density = [], [], []
    for step in range(TRAIN_STEPS):
        s0 = time.perf_counter()
        aux = tr.train_one_batch(ds.get_batch(step % len(ds)),
                                 has_alpha=True)
        losses.append(float(aux["loss"]))  # syncs the step
        step_s.append(time.perf_counter() - s0)
        if step % tr.update_interval == 0:
            density.append(float(tr.occ_state.mean_density))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite training loss")
    # What the JAX reference does over these steps (16-view 100^2 scene,
    # L8C4, 1024 rays on the CPU, three seeds): the loss falls by 15-20%
    # but does not halve (it plateaus until the grid starts pruning, at
    # step 700 to past 1000, by seed), and the density grid's mean falls
    # from 0.75 after the first refresh to 0.35 by step 256 in every seed.
    first, last = float(np.mean(losses[:16])), float(np.mean(losses[-16:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    if not density[-1] <= 0.5 * density[0]:
        raise AssertionError(f"density grid mean did not halve: "
                             f"{density[0]} -> {density[-1]}")
    occ_frac = float(tr.occ_state.occupancy.float().mean())
    phase("train", f"{TRAIN_STEPS} steps, {tr.occ_state.iter_density} "
                   f"occupancy refreshes: loss {first:.5f} -> {last:.5f} "
                   f"(first/last 16 steps), grid mean density "
                   f"{density[0]:.4f} -> {density[-1]:.4f}, occ_frac "
                   f"{occ_frac:.4f}; {1e3 * np.mean(step_s):.1f} ms/step "
                   f"mean, {1e3 * np.median(step_s[16:]):.1f} ms/step median "
                   f"after 16 ({card})")
    return tr, ds


def phase_render(card, tr, ds):
    H = W = RENDER_HW
    intr = ds.intrinsics * (H / ds.H)
    intr[2], intr[3] = W / 2, H / 2
    s0 = time.perf_counter()
    img, depth = tr.render_image(ds.poses[0], intr, H, W)
    dt = time.perf_counter() - s0  # render_image returns host arrays
    if img.shape != (H, W, 3) or depth.shape != (H, W):
        raise AssertionError(f"bad render shapes {img.shape} {depth.shape}")
    n_bad = int((~np.isfinite(img)).sum())
    lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
    # the composite's weights sum to 1 - T only up to f32 rounding, so a
    # saturated color (sigmoid == 1.0 in f32) composites to 1 + a few ulp
    if n_bad or lo < 0.0 or hi > 1.0 + 1e-5:
        raise AssertionError(f"render: {n_bad} non-finite values, range "
                             f"[{lo!r}, {hi!r}]")
    phase("render", f"{H}x{W} frame: {1e3 * dt:.1f} ms/frame, "
                    f"{H * W / dt:.0f} rays/s (first frame), values in "
                    f"[{lo:.6f}, {hi:.8f}] ({card})")
    small, _ = tr.render_image(ds.poses[0], ds.intrinsics, ds.H, ds.W)
    gt = ds.images[0]
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    psnr = -10.0 * math.log10(max(float(np.mean((small - gt) ** 2)), 1e-10))
    if not math.isfinite(psnr):
        raise AssertionError("train-view PSNR is not finite")
    phase("render", f"train-view PSNR at {ds.H}x{ds.W}: {psnr:.2f} dB")


def phase_profile(tr, ds, steps=4):
    from torch.profiler import ProfilerActivity, profile

    batches = [ds.get_batch(i % len(ds)) for i in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        for b in batches:
            tr.train_one_batch(b, has_alpha=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3  # us -> ms
    if not kernels:
        phase("profile", "device time not measured (no CUDA events)")
        return None
    k1 = [e.device_time for e in kernels
          if "scatter_add_rows_kernel" in e.name]
    k1_us = sum(k1) / len(k1) if k1 else None
    phase("profile", f"{steps} train steps: {len(kernels) / steps:.0f} "
                     f"device kernels per step, device busy "
                     f"{busy / steps:.1f} ms of {1e3 * wall / steps:.1f} ms "
                     f"wall per step ({100 * busy / (1e3 * wall):.1f}%, "
                     f"under the profiler); K1 (scatter_add_rows_kernel) "
                     f"{len(k1)} launches, {k1_us} us of device time per "
                     f"launch")
    return k1_us


def k1_launch_us(fn):
    """K1's (scatter_add_rows_kernel's) mean device µs per launch while fn
    runs, under the profiler; None if it saw no K1 launch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    k1 = [e.device_time for e in p.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "scatter_add_rows_kernel" in e.name]
    return sum(k1) / len(k1) if k1 else None


def k1_span_turns(tr, ds, spans=(1, 16, 32, 64), steps=1):
    """K1's device time per launch inside train steps at each of `spans`
    (rows a lane walks down the backward's [samples, 64] idx), in turns:
    the spans in order, then reversed, `steps` profiled steps each."""
    times = {span: [] for span in spans}
    for span in spans + spans[::-1]:
        batches = [ds.get_batch(i % len(ds)) for i in range(steps)]
        with k1_span(span):
            times[span].append(k1_launch_us(
                lambda: [tr.train_one_batch(b, has_alpha=True)
                         for b in batches]))
    phase("profile", "K1 (scatter_add_rows_kernel) us of device time per "
                     "launch inside train steps, by span, in turns: "
                     + ", ".join(f"span {s} {t}" for s, t in times.items()))
    return times


# the recolor phase's step counts, cut to fit the run (the JAX package's
# recolor gate runs 10,000 / 1,500 / 7,000)
RECOLOR_STEPS = {"train_steps_style": 300, "distill_palette_steps": 100,
                 "train_steps_distill": 64}
LAENERF_LOG_EVERY = 50  # LAENeRF steps between MSE read-backs


@contextlib.contextmanager
def k1_capture(table_rows, nth=0):
    """Keep a copy of the nth (from 0) K1 input the hash-grid backward
    passes for a table of table_rows rows (the launch itself is the real
    one)."""
    from laenerf_tpu_torch.ops import hashgrid

    real = hashgrid.scatter_add_rows
    seen = {}
    calls = [0]

    def capture(idx, g, rows, **kw):
        if rows == table_rows:
            if calls[0] == nth:
                seen.update(idx=idx.clone(), rows=g.clone())
            calls[0] += 1
        return real(idx, g, rows, **kw)

    hashgrid.scatter_add_rows = capture
    try:
        yield seen
    finally:
        hashgrid.scatter_add_rows = real


def bg_mse(post, pre, mask_png):
    """Mean squared difference of two renders outside a mask PNG (the
    region in its G channel)."""
    from PIL import Image

    outside = np.asarray(Image.open(mask_png))[..., 1] == 0
    return float(np.mean((post - pre)[outside] ** 2))


def grown_region(tr, seeds):
    """An EditGrid seeded at seeds [n, 3] and grown 4000 pops on the
    density grid at min(mean density, 0.01), as the recolor gate grows
    it."""
    from laenerf_tpu_torch.editing import EditGrid

    rc = tr.render_cfg
    density = tr.occ_state.density_grid.cpu().numpy()
    thresh = min(float(tr.occ_state.mean_density), 0.01)
    grid = EditGrid(rc.cascades, rc.grid_size)
    grid.new_from_points(seeds, bound=rc.bound)
    grid.grow_region_queue(density, thresh, grow_iterations=4000)
    return grid, density, thresh


def centre_sphere(ds):
    """The procedural scene's centre sphere in model space (blender (x, y,
    z) -> (y, z, x) * scale + offset): (centre [3], radius)."""
    from laenerf_tpu_torch.data.synthetic import DEFAULT_SPHERES

    centre, radius = DEFAULT_SPHERES[0][:2]
    return (np.asarray(centre, np.float64)[[1, 2, 0]] * ds.scale
            + np.asarray(ds.offset), radius * ds.scale)


def clicked_region(card, tr, ds):
    """The region the centre pixel of train view 0 selects (project_points,
    then grown): where its ray terminates, and what its edit dataset
    holds. Returns the termination point."""
    from laenerf_tpu_torch.editing import EditDataset
    from laenerf_tpu_torch.pipeline import project_points

    pts = project_points(tr, ds.poses[0], ds.intrinsics,
                         [[ds.W // 2, ds.H // 2]], ds.H, ds.W)
    grid, _, _ = grown_region(tr, pts)
    # the first 4 views only: a record, cut to fit the run
    views = copy.copy(ds)
    views.poses, views.images = ds.poses[:4], ds.images[:4]
    try:
        ed = EditDataset(tr, views, grid.grid, None, depth_diff=0.5,
                         smooth_transition=False)
        w8s = np.concatenate([v["w8s"][:int(v["n_valid"])]
                              for v in ed.views])
        held = (f"{len(ed)} views, {w8s.size} rays, edit weight max "
                f"{w8s.max():.3f}, {int((w8s > 0.5).sum())} above 0.5")
    except RuntimeError as e:
        held = str(e)
    centre, radius = centre_sphere(ds)
    phase("recolor", f"centre pixel of view 0 ends at {pts[0].round(4)} "
                     f"({np.linalg.norm(pts[0] - centre):.3f} from the "
                     f"centre sphere's centre, radius {radius:.3f}); its "
                     f"region of "
                     f"{int(grid.grid.sum())} cells gives an edit dataset "
                     f"of {held} ({card})")
    return pts


def seeded_region(tr, ds, what):
    """The recolor gate's region (scripts/recolor_gate.py:88-97): 200
    seeds just inside a sphere of the scene, here the centre one, grown on
    the density grid, and its grow grid. Returns (edit, grow)."""
    from laenerf_tpu_torch.editing import EditGrid

    rc = tr.render_cfg
    centre, radius = centre_sphere(ds)
    u = np.random.RandomState(0).randn(200, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    edit, density, thresh = grown_region(
        tr, (centre + 0.9 * radius * u).astype(np.float32))
    grow = EditGrid(rc.cascades, rc.grid_size)
    grow.grid_from_growing_queue(edit, density, thresh)
    phase(what, f"region: 200 seeds inside the centre sphere, "
                f"{int(edit.grid.sum())} cells grown (4000 pops, thresh "
                f"{thresh:.4g}), grow grid {int(grow.grid.sum())} cells")
    return edit, grow


def phase_recolor(card, dev, tr, ds, tmp):
    """The recolor editing path on the trainer and scene phase_train left:
    a region seeded inside the scene's centre sphere and grown on the
    density grid, then the pipeline's phases (EditPipeline.run_all's order)
    with 8 palette bases, style_lg 19 and the recolor gate's loss weights.
    Returns K1's launches in the phase and K1's entry at the LAENeRF
    backward's shape."""
    from laenerf_tpu_torch.data import NeRFDataset
    from laenerf_tpu_torch.editing import StyleLossWeights
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.pipeline import EditPipeline, PipelineConfig
    from laenerf_tpu_torch.train import Trainer

    rc = tr.render_cfg
    test = NeRFDataset(tmp, "test")
    pre = [tr.render_image(p, test.intrinsics, test.H, test.W)[0]
           for p in test.poses]
    clicked_region(card, tr, ds)
    edit, grow = seeded_region(tr, ds, "recolor")

    cfg = PipelineConfig(
        mode="recolor", num_palette_bases=8, style_lg=19, depth_diff=0.5,
        weights=StyleLossWeights(
            offset_loss=1e-4, weight_loss_uniform=1e-5,
            weight_loss_non_uniform=1e-5, palette_loss_valid=1e-4,
            palette_loss_distinct=1e-4, warmup_iterations=100),
        **RECOLOR_STEPS)
    ws = f"{tmp}/recolor_ws"
    pipe = EditPipeline(tr, ds, cfg, ws, edit, grow)
    launches = {}

    pipe.init_phase()
    ed = pipe.edit_dataset
    if len(ed) == 0:
        raise AssertionError("the edit dataset is empty")
    n_rays = sum(int(v["n_valid"]) for v in ed.views)
    w8s = np.concatenate([v["w8s"][:int(v["n_valid"])] for v in ed.views])
    phase("recolor", f"edit dataset: {len(ed)} views ({len(ed.occluded)} "
                     f"occluded), {n_rays} rays (edit weight min/median/max "
                     f"{w8s.min():.3f}/{np.median(w8s):.3f}/{w8s.max():.3f}),"
                     f" padded to {ed.n_pad} a view, crops "
                     f"{ed.crop_h}x{ed.crop_w}")

    st = pipe.style_trainer
    spec = st.cfg.grid_spec
    stamps = [time.perf_counter()]
    before = scatter_add_rows.launches
    with k1_capture(spec.table_rows) as captured:
        pipe.train_laenerf_phase(
            log_every=LAENERF_LOG_EVERY,
            log_fn=lambda m: m.startswith("[laenerf] step")
            and stamps.append(time.perf_counter()))
    launches["laenerf"] = scatter_add_rows.launches - before
    steps = cfg.train_steps_style
    if launches["laenerf"] < steps:
        raise AssertionError(f"K1 launched {launches['laenerf']} times in "
                             f"{steps} LAENeRF steps")
    mse = st.mse_history
    first, last = float(np.mean(mse[:50])), float(np.mean(mse[-50:]))
    if not last < first:
        raise AssertionError(f"LAENeRF MSE did not fall: {first} -> {last}")
    n_active = int(st.active.sum())
    if n_active < 1:
        raise AssertionError("palette pruning left no active basis")
    chunk_ms = np.diff(stamps) * 1e3 / LAENERF_LOG_EVERY
    step_ms = float(np.median(chunk_ms))
    phase("recolor", f"LAENeRF: {steps} steps, MSE {first:.5f} -> "
                     f"{last:.5f} (first/last 50), {n_active}/8 bases "
                     f"active after pruning, {step_ms:.2f} ms/step median "
                     f"(of {len(chunk_ms)} chunks of {LAENERF_LOG_EVERY}; "
                     f"MSE read once a chunk), K1 {launches['laenerf']} "
                     f"launches ({card})")

    palette = st.model.palette.detach().cpu().numpy()
    cfg.palette_mod = np.clip(palette * np.array([1.8, 0.4, 0.35]), 0, 1)
    images = ds.images.copy()
    stats = pipe.distill_phase(log_fn=lambda m: None)
    # every pixel at or under blend_thresh keeps its value; in a view with
    # pixels above it, some change (the edit lands); and some view has them
    above, changed = [], 0
    for v in ed.views:
        i, n = int(v["view_index"]), int(v["n_valid"])
        w8s = np.zeros(ds.H * ds.W, np.float32)
        w8s[v["inds"][:n]] = v["w8s"][:n]
        old = images[i][..., :3].reshape(-1, 3)
        new = ds.images[i][..., :3].reshape(-1, 3)
        under = w8s <= cfg.blend_thresh
        if not np.array_equal(new[under], old[under]):
            raise AssertionError(f"view {i}: a pixel at or under "
                                 f"blend_thresh changed")
        above.append(int((~under).sum()))
        if above[-1] and not np.any(new[~under] != old[~under]):
            raise AssertionError(f"view {i}: no pixel above blend_thresh "
                                 f"changed")
        changed += int(np.any(new != old, axis=1).sum())
    if not changed:
        raise AssertionError("distillation changed no pixel of any view")
    phase("recolor", f"distilled {len(ed)} views: {changed} pixels "
                     f"changed; pixels above blend_thresh "
                     f"{cfg.blend_thresh} by view {above}, none at or "
                     f"under it changed; sparsity "
                     f"{stats['sparsity_loss']:.4f}, tv "
                     f"{stats['tv_loss']:.4g}")

    before = scatter_add_rows.launches
    losses = pipe.finetune_phase(log_fn=lambda m: None)
    launches["finetune"] = scatter_add_rows.launches - before
    steps = cfg.train_steps_distill
    losses = torch.stack(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("non-finite fine-tune loss")
    if launches["finetune"] < steps:
        raise AssertionError(f"K1 launched {launches['finetune']} times in "
                             f"{steps} fine-tune steps")
    ft_ms = 1e3 * pipe.timer["distill_nerf"] / steps
    phase("recolor", f"fine-tune: {steps} steps, loss "
                     f"{float(losses[0]):.5f} -> {float(losses[-1]):.5f}, "
                     f"{ft_ms:.1f} ms/step mean (occupancy refreshes "
                     f"included), K1 {launches['finetune']} launches "
                     f"({card})")

    results = pipe.eval_phase(test_dataset=test, log_fn=lambda m: None)
    recolor_launches = scatter_add_rows.launches
    post = []
    for p in test.poses:
        img = tr.render_image(p, test.intrinsics, test.H, test.W)[0]
        lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
        if not np.isfinite(img).all() or lo < 0.0 or hi > 1.0 + 1e-5:
            raise AssertionError(f"eval render out of [0, 1]: [{lo}, {hi}]")
        post.append(img)
    mses = [bg_mse(a, b, f"{ws}/masks/test/{i:03d}.png")
            for i, (a, b) in enumerate(zip(post, pre))]
    timings = pipe.timer.summary()
    phase("recolor", f"eval: train PSNR {results['psnr_train']:.2f} dB; "
                     f"{len(post)} test renders finite in [0, 1]; bg-MSE "
                     f"against the pre-edit renders outside the exported "
                     f"masks (for the record): "
                     + ", ".join(f"{m:.3g}" for m in mses))
    phase("recolor", "phase seconds (PhaseTimer): " + ", ".join(
        f"{k} {v:.2f}" for k, v in timings.items())
        + f"; step cuts: train_steps_style 300 (gate 10,000), "
          f"distill_palette_steps 100 (1,500), train_steps_distill 64 "
          f"(7,000), warmup_iterations 100 (1,000) ({card})")

    # the checkpoint the fine-tune saved renders as the trainer does
    fresh = Trainer(tr.model_cfg, rc, device=dev, workspace=tr.workspace)
    if not fresh.load_checkpoint():
        raise AssertionError("no checkpoint after the fine-tune")
    a = fresh.render_image(test.poses[0], test.intrinsics, test.H, test.W)[0]
    diff = float(np.abs(a - post[0]).max())
    if not diff <= 1e-6:
        raise AssertionError(f"reloaded checkpoint renders {diff} off")
    phase("recolor", f"checkpoint {fresh.global_step} reloaded by a fresh "
                     f"Trainer: test render within {diff:.2e}")

    # K1 on the captured LAENeRF backward, against its plain version
    if "idx" not in captured:
        raise AssertionError("no LAENeRF backward reached K1")
    idx, rows = captured["idx"], captured["rows"]
    T, C = spec.table_rows, rows.shape[-1]
    site = k1_site(card, dev, "laenerf", idx, rows, T, "recolor")
    # back to back, the 49 MB output stays in the 50 MB L2; inside LAENeRF
    # steps (the table's gather and its Adam update between launches) it
    # does not. Four more steps, after the path's counts were read (the
    # LAENeRF is not used again)
    us = k1_launch_us(lambda: st.train_steps(4))
    site["step_kernel_device_ms"] = None if us is None else us / 1e3
    phase("recolor", f"K1 (scatter_add_rows_kernel) inside 4 LAENeRF "
                     f"steps: {us} us of device time per launch (None: not "
                     f"measured); back to back "
                     f"{site['kernel_device_ms']} ms ({card})")
    # the zero-fill, idx, rows, and an 8-byte read plus an 8-byte write for
    # each float2 RED that k1_reds models
    red_bytes = (idx.numel() * 4 + rows.numel() * 2 + T * C * 4
                 + k1_reds(idx, T, C) * 16)
    phase("recolor", f"K1 laenerf bound with the zero-fill, idx, rows and "
                     f"one 8-byte read-modify-write per RED (modelled "
                     f"count): {1e3 * red_bytes / HBM_BYTES_PER_S:.4f} ms "
                     f"(bytes, {red_bytes} B at 3.35 TB/s)")
    return recolor_launches, site


# the style phase's step counts and the gate's style configuration
# (scripts/recolor_gate.py:100-124, run_common.sh's -m style flags), steps
# cut to fit the run (the gate runs 10,000 / 1,500 / 7,000 and warm-up
# 1,000; the style and NPR fine-tunes ran 64 steps until the CLI phase
# joined the run)
STYLE_STEPS = {"train_steps_style": 300, "distill_palette_steps": 100,
               "train_steps_distill": 32}
STYLE_WARMUP = 100
NPR_STEPS = {"train_steps_style": 200, "train_steps_distill": 32}
MSE_WINDOW = 50  # steps averaged at each end of an MSE history


def wave_png(path, size=256):
    """The recolor gate's procedural wave style image, as a PNG."""
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    wave = 0.5 + 0.5 * np.sin(12 * xx + 5 * np.sin(6 * yy))
    img = np.stack([wave, 0.4 + 0.5 * wave ** 2, 0.9 - 0.6 * wave], -1)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)
    return img


def phase_style(card, dev, tr, ds, tmp):
    """The style mode on the trainer and scene the recolor phase left:
    the recolor phase's seeded region, the gate's wave image, and
    EditPipeline(mode="style") at the gate's style configuration (VGG-19 to
    index 14, style layers 10/12/14, crop_size 256, style_weight 130, TV
    1e-4 depth-guided, depth discontinuity 5e-4, smooth transition 1e-3,
    8 bases, style_lg 19, depth_diff 0.5) with STYLE_STEPS; then
    preserve_color's LAENeRF phase on the same edit dataset. Returns K1's
    launches in the phase and K1's entry at a style step past warm-up."""
    from laenerf_tpu_torch.data import NeRFDataset
    from laenerf_tpu_torch.editing import StyleLossWeights, StyleNetwork
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.pipeline import EditPipeline, PipelineConfig

    test = NeRFDataset(tmp, "test")
    edit, grow = seeded_region(tr, ds, "style")
    style_path = f"{tmp}/wave_style.png"
    wave_png(style_path)
    weights = StyleLossWeights(
        offset_loss=5e-5, weight_loss_non_uniform=1e-7,
        palette_loss_valid=1.0, smooth_trans_weight=1e-3, tv_weight=1e-4,
        tv_depth_guide=True, depth_disc_weight=5e-4, style_weight=130.0,
        warmup_iterations=STYLE_WARMUP)
    cfg = PipelineConfig(
        mode="style", num_palette_bases=8, style_lg=19, depth_diff=0.5,
        style_image=style_path, style_layers=(10, 12, 14), crop_size=256,
        weights=weights, **STYLE_STEPS)
    ws = f"{tmp}/style_ws"
    pipe = EditPipeline(tr, ds, cfg, ws, edit, grow)
    images = ds.images.copy()
    launches = {}

    pipe.init_phase()
    ed, st = pipe.edit_dataset, pipe.style_trainer
    sn = st.style_network
    phase("style", f"edit dataset: {len(ed)} views, padded to {ed.n_pad} "
                   f"a view, crops {ed.crop_h}x{ed.crop_w} resized to "
                   f"{cfg.crop_size}; VGG-19 pretrained: {sn.pretrained} "
                   f"(random filters without a weights npz)")
    spec = st.cfg.grid_spec
    stamps = [time.perf_counter()]
    before = scatter_add_rows.launches
    # a step past warm-up: its Gram gradient reaches K1
    steps = cfg.train_steps_style
    with k1_capture(spec.table_rows,
                    nth=(STYLE_WARMUP + steps) // 2) as captured:
        pipe.train_laenerf_phase(
            log_every=LAENERF_LOG_EVERY,
            log_fn=lambda m: m.startswith("[laenerf] step")
            and stamps.append(time.perf_counter()))
    launches["laenerf"] = scatter_add_rows.launches - before
    past = steps - STYLE_WARMUP - 1  # steps with step > warmup_iterations
    if st.gram_steps != past:
        raise AssertionError(f"the Gram term ran in {st.gram_steps} steps, "
                             f"not the {past} past warm-up")
    if launches["laenerf"] < steps:
        raise AssertionError(f"K1 launched {launches['laenerf']} times in "
                             f"{steps} LAENeRF steps")
    mse = np.asarray(st.mse_history)
    first, last = float(np.mean(mse[:MSE_WINDOW])), float(np.mean(mse[-MSE_WINDOW:]))
    if not np.isfinite(mse).all() or not last < first:
        raise AssertionError(f"style LAENeRF MSE: {first} -> {last}")
    chunk_ms = np.diff(stamps) * 1e3 / LAENERF_LOG_EVERY
    n_pre = STYLE_WARMUP // LAENERF_LOG_EVERY  # chunks before warm-up ends
    pre_ms, post_ms = (float(np.median(chunk_ms[:n_pre])),
                       float(np.median(chunk_ms[n_pre + 1:])))
    phase("style", f"LAENeRF: {steps} steps, MSE {first:.5f} -> "
                   f"{last:.5f} (first/last {MSE_WINDOW}), the Gram term in "
                   f"{st.gram_steps} steps; {pre_ms:.2f} ms/step median "
                   f"before warm-up, {post_ms:.2f} after (chunks of "
                   f"{LAENERF_LOG_EVERY}: {np.round(chunk_ms, 2).tolist()}),"
                   f" {int(st.active.sum())}/8 bases active, K1 "
                   f"{launches['laenerf']} launches ({card})")

    pipe.distill_phase(log_fn=lambda m: None)
    changed = int(np.any(ds.images != images, axis=-1).sum())
    if not changed:
        raise AssertionError("style distillation changed no pixel")
    before = scatter_add_rows.launches
    losses = torch.stack(pipe.finetune_phase(log_fn=lambda m: None))
    launches["finetune"] = scatter_add_rows.launches - before
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("non-finite style fine-tune loss")
    if launches["finetune"] < cfg.train_steps_distill:
        raise AssertionError(f"K1 launched {launches['finetune']} times in "
                             f"{cfg.train_steps_distill} fine-tune steps")
    ft_ms = 1e3 * pipe.timer["distill_nerf"] / cfg.train_steps_distill
    results = pipe.eval_phase(log_fn=lambda m: None)
    post = [tr.render_image(p, test.intrinsics, test.H, test.W)[0]
            for p in test.poses[:2]]
    for img in post:
        lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
        if not np.isfinite(img).all() or lo < 0.0 or hi > 1.0 + 1e-5:
            raise AssertionError(f"style render out of [0, 1]: [{lo}, {hi}]")
    phase("style", f"distilled: {changed} pixels changed; fine-tune "
                   f"{cfg.train_steps_distill} steps (depth-supervised), "
                   f"loss {float(losses[0]):.5f} -> {float(losses[-1]):.5f}"
                   f", {ft_ms:.1f} ms/step mean; train PSNR "
                   f"{results['psnr_train']:.2f} dB, 2 test renders finite "
                   f"in [0, 1] ({card})")
    phase("style", "phase seconds (PhaseTimer): " + ", ".join(
        f"{k} {v:.2f}" for k, v in pipe.timer.summary().items())
        + f" ({card})")

    # preserve_color: the colour-matched Gram targets, the same edit dataset
    pc = dataclasses.replace(cfg, preserve_color=True,
                             load_edit_dataset=f"{ws}/edataset.npz")
    pipe2 = EditPipeline(tr, ds, pc, f"{tmp}/style_pc_ws", edit, grow)
    pipe2.init_phase()
    st2 = pipe2.style_trainer
    if st2.style_network.targets is not st2.style_network.gram_color:
        raise AssertionError("preserve_color did not set colour targets")
    pipe2.train_laenerf_phase(log_every=LAENERF_LOG_EVERY,
                              log_fn=lambda m: None)
    mse2 = np.asarray(st2.mse_history)
    if st2.gram_steps != past or not np.isfinite(mse2).all() or \
            not np.mean(mse2[-MSE_WINDOW:]) < np.mean(mse2[:MSE_WINDOW]):
        raise AssertionError(f"preserve_color LAENeRF: {st2.gram_steps} "
                             f"Gram steps, MSE {mse2[:MSE_WINDOW].mean()} -> "
                             f"{mse2[-MSE_WINDOW:].mean()}")
    phase("style", f"preserve_color: {steps} LAENeRF steps, MSE "
                   f"{mse2[:MSE_WINDOW].mean():.5f} -> {mse2[-MSE_WINDOW:].mean():.5f}, the "
                   f"Gram term in {st2.gram_steps} steps; train_style_enc "
                   f"{pipe2.timer['train_style_enc']:.2f} s")
    style_launches = scatter_add_rows.launches

    # the Gram loss on the card and on the CPU (f32 both) on one crop
    crop = torch.as_tensor(np.moveaxis(post[0], -1, 0))
    sn_cpu = StyleNetwork(sn.image, style_layers=cfg.style_layers,
                          size=cfg.crop_size, device="cpu")
    a = float(sn(crop.to(dev)))
    b = float(sn_cpu(crop))
    rel = abs(a - b) / abs(b)
    if not rel < 1e-3:
        raise AssertionError(f"StyleNetwork loss card {a} vs CPU {b}")
    phase("style", f"StyleNetwork loss on a {crop.shape[1]}x{crop.shape[2]}"
                   f" render resized to {cfg.crop_size}: card {a:.6e}, CPU "
                   f"{b:.6e}, rel err {rel:.2e} (f32, TF32 off)")

    if "idx" not in captured:
        raise AssertionError("no style LAENeRF backward reached K1")
    site = k1_site(card, dev, "style_laenerf", captured["idx"],
                   captured["rows"], spec.table_rows, "style")
    return style_launches, site


def reference_view(tmp, ds):
    """The NPR reference: train view 0 with its green channel doubled, and
    data_config.json naming it (tests/test_npr.py's recipe)."""
    from PIL import Image

    cfg_dir = f"{tmp}/npr_ref"
    Path(cfg_dir).mkdir(exist_ok=True)
    ref = ds.images[0].copy()
    ref[..., 1] = np.clip(ref[..., 1] * 2.0, 0, 1)
    mode = "RGBA" if ref.shape[-1] == 4 else "RGB"
    Image.fromarray((ref * 255).astype(np.uint8), mode).save(
        f"{cfg_dir}/ref.png")
    Path(f"{cfg_dir}/data_config.json").write_text(
        json.dumps({"tmpl_idx_train": 0}))
    return cfg_dir


def phase_npr(card, dev, tr, ds, tmp):
    """run_npr_pipeline at its defaults (VGG-16 to index 29, feature_size
    256, cos 2.5, mse 6, colour patch 30, 4 bases, no direction encoding)
    with NPR_STEPS, on the trainer the style phase left. Returns K1's
    launches in the phase and K1's entry at the NPR fine-tune's backward."""
    from laenerf_tpu_torch.editing import StyleLossWeights
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.pipeline import run_npr_pipeline

    cfg_dir = reference_view(tmp, ds)
    weights = StyleLossWeights(offset_loss=1e-4, weight_loss_uniform=1e-6,
                               weight_loss_non_uniform=1e-6,
                               palette_loss_valid=1e-4, tv_weight=1e-5,
                               tv_depth_guide=True, warmup_iterations=0)
    ws = f"{tmp}/npr_ws"
    table = tr.model_cfg.grid_spec.table_rows
    with k1_capture(table) as captured:
        npr_tr = run_npr_pipeline(tr, ds, cfg_dir, ws, weights,
                                  log_fn=lambda m: None, **NPR_STEPS)
    launches = scatter_add_rows.launches
    steps, ft = NPR_STEPS["train_steps_style"], NPR_STEPS[
        "train_steps_distill"]
    for f in ("style_enc.npz", "timings.json"):
        if not Path(ws, f).exists():
            raise AssertionError(f"run_npr_pipeline wrote no {f}")
    timings = json.loads(Path(ws, "timings.json").read_text())
    nd = npr_tr.ds
    mse = np.asarray(npr_tr.mse_history)
    first, last = float(np.mean(mse[:MSE_WINDOW])), float(np.mean(mse[-MSE_WINDOW:]))
    if not np.isfinite(mse).all() or not last < first:
        raise AssertionError(f"NPR MSE: {first} -> {last}")
    losses = torch.stack(npr_tr.finetune_losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("non-finite NPR fine-tune loss")
    if launches < steps + ft:
        raise AssertionError(f"K1 launched {launches} times in {steps} NPR "
                             f"LAENeRF and {ft} fine-tune steps")
    reg = [float((v["target_weights"][:v["n_valid"]] > 0).mean())
           for v in nd.views]
    phase("npr", f"registration: {len(nd)} views padded to {nd.n_pad}, "
                 f"crops {nd.crop_h}x{nd.crop_w} resized to "
                 f"{nd.feature_size}, registered share of rays by view "
                 f"{np.round(reg, 3).tolist()}; VGG-16 pretrained: "
                 f"{npr_tr.sem.pretrained}")
    phase("npr", f"LAENeRF: {steps} steps, MSE {first:.5f} -> {last:.5f} "
                 f"(first/last {MSE_WINDOW}), "
                 f"{1e3 * timings['train_style_enc'] / steps:.2f} ms/step "
                 f"mean; fine-tune {ft} steps, loss "
                 f"{float(losses[0]):.5f} -> {float(losses[-1]):.5f}, "
                 f"{1e3 * timings['distill_nerf'] / ft:.1f} ms/step mean; "
                 f"K1 {launches} launches ({card})")
    phase("npr", "phase seconds (PhaseTimer): " + ", ".join(
        f"{k} {v:.2f}" for k, v in timings.items()) + f" ({card})")
    if "idx" not in captured:
        raise AssertionError("no NPR fine-tune backward reached K1")
    site = k1_site(card, dev, "npr_finetune", captured["idx"],
                   captured["rows"], table, "npr", cancels=True)
    return launches, site


@contextlib.contextmanager
def synthetic_vgg16(tmp):
    """LAENERF_VGG16_NPZ naming a synthetic VGG-16 npz (random weights in
    torchvision's layout, tests/test_vgg_weights.py's recipe: LPIPS through
    it is no perceptual measure) while the block runs."""
    import os

    from laenerf_tpu_torch.editing import VGG16_LAYOUT
    from laenerf_tpu_torch.editing.vgg import _layer_indices

    path = f"{tmp}/vgg16_features.npz"
    if not Path(path).exists():
        rng = np.random.RandomState(0)
        arrays, cin = {}, 3
        for i, (kind, cout) in enumerate(_layer_indices(VGG16_LAYOUT)):
            if kind == "conv":
                arrays[f"{i}.weight"] = (rng.randn(cout, cin, 3, 3)
                                         * 0.05).astype(np.float32)
                arrays[f"{i}.bias"] = (rng.randn(cout) * 0.01).astype(
                    np.float32)
                cin = cout
        np.savez(path, **arrays)
    os.environ["LAENERF_VGG16_NPZ"] = path
    try:
        yield path
    finally:
        del os.environ["LAENERF_VGG16_NPZ"]


def phase_lpips(card, tr, tmp, views=2):
    """Trainer.evaluate once with LPIPS on, through a synthetic VGG-16 npz
    (random weights in torchvision's layout, tests/test_vgg_weights.py's
    recipe: the number is no perceptual measure), against the same LPIPS on
    the CPU."""
    from laenerf_tpu_torch.data import NeRFDataset
    from laenerf_tpu_torch.editing.vgg import lpips_fn

    with synthetic_vgg16(tmp):
        test = NeRFDataset(tmp, "test")
        tr.evaluate(test, max_views=views)  # its first: builds the meter
        if not tr.stats["lpips"]:
            raise AssertionError("evaluate recorded no LPIPS")
        card_lpips = tr.stats["lpips"][-1]
        cpu_fn = lpips_fn(device="cpu")
        vals = []
        for i in range(views):
            img, _ = tr.render_image(test.poses[i], test.intrinsics, test.H,
                                     test.W)
            gt = test.images[i]
            gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
            vals.append(float(cpu_fn(torch.as_tensor(img),
                                     torch.as_tensor(gt, dtype=torch.float32))))
    cpu_lpips = float(np.mean(vals))
    if not math.isfinite(card_lpips) or \
            not abs(card_lpips - cpu_lpips) <= 1e-3 * abs(cpu_lpips):
        raise AssertionError(f"LPIPS card {card_lpips} vs CPU {cpu_lpips}")
    phase("lpips", f"Trainer.evaluate over {views} test views with LPIPS "
                   f"(synthetic weights): {card_lpips:.6f} on the card, "
                   f"{cpu_lpips:.6f} on the CPU, difference "
                   f"{abs(card_lpips - cpu_lpips):.2e} ({card})")


# the CLI phase: scripts/run_common.sh's COMMON flags with
# scripts/configs_llff/fern.sh's values, at the CLI's own model width
# (make_configs: the 16-level C = 2 lg19 grid, 2 cascades at bound 2,
# max_steps = march_iters = 1024, m_cap_per_ray 32). Cuts, listed in
# PERF.md: --iters 10,000 -> 32 (+4 with patches; the LR decay shortens
# with it; 128 and 16 until the gates phase joined the run), --scale
# 0.02 and --offset 0 0 1.5 (LLFF's pose units) -> 0.33 and 0 0 0, 100^2
# frames, --mesh_resolution 256 -> 128
CLI_STEPS = 32
CLI_PATCH_STEPS = 4
CLI_MESH_RES = 128
CLI_FLAGS = ["--bound", "2", "--scale", "0.33", "--offset", "0", "0", "0",
             "--bg_radius", "0", "--density_thresh", "10", "--min_near",
             "0.2", "--no_bg", "-O", "--dt_gamma", "0", "--error_map"]


def colmap_scene(tmp, dev):
    """A colmap-layout copy of the procedural 17-view 100^2 scene (one
    transforms.json of RGB frames composited over white,
    tests/test_colmap_fixture.py's recipe): frame 0 is val, 16 are train."""
    from PIL import Image

    from laenerf_tpu_torch.data import generate_synthetic_scene

    src, dst = f"{tmp}/cli_blender", f"{tmp}/cli_colmap"
    generate_synthetic_scene(src, n_train=17, n_val=0, n_test=0, H=100,
                             W=100, device=dev)
    Path(dst, "images").mkdir(parents=True)
    tf = json.loads(Path(src, "transforms_train.json").read_text())
    frames = []
    for i, fr in enumerate(tf["frames"]):
        fp = Path(src, fr["file_path"])
        if not fp.suffix:
            fp = fp.with_suffix(".png")
        rgba = np.asarray(Image.open(fp)).astype(np.float32) / 255.0
        rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        name = f"images/frame_{i:03d}.png"
        Image.fromarray((rgb * 255).astype(np.uint8)).save(Path(dst, name))
        frames.append({"file_path": name,
                       "transform_matrix": fr["transform_matrix"]})
    Path(dst, "transforms.json").write_text(json.dumps(
        {"camera_angle_x": tf["camera_angle_x"], "frames": frames}))
    return dst


@contextlib.contextmanager
def wrapped(obj, name, wrap):
    """obj.name replaced by wrap(obj.name) while the block runs."""
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def cli_recorder(rec):
    """Wrappers that record what one CLI run does, on the classes and
    module it calls: each Trainer built, each train step's loss (read back,
    so the step's time ends in a sync), host seconds and K1 launches, the
    host seconds of get_batch (pixel sampling by the error map) and
    update_error_map, each render and the mesh export.

    Under error-map sampling a batch's loss is not the image's: the map
    draws the cells where the error is high. So each step also records its
    per-ray errors reweighted by 1 / p of each ray's cell at the draw
    (self-normalised importance weights), an estimate of the mean error
    over uniformly drawn pixels."""
    from laenerf_tpu_torch.data.provider import NeRFDataset
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.train import Trainer
    from laenerf_tpu_torch.utils import mesh

    def init(real):
        def f(self, *a, **k):
            real(self, *a, **k)
            rec["trainers"].append(self)
            lpips = self.patch_lpips_fn
            if lpips is not None:
                def patch_lpips(a, b):
                    out = lpips(a, b)
                    if "lpips" not in rec:
                        rec["lpips"] = (a.detach().clone(), b.detach().clone(),
                                        out.detach().clone())
                    rec["lpips_calls"] += 1
                    return out
                self.patch_lpips_fn = patch_lpips
        return f

    def step(real):
        def f(self, batch, has_alpha, **kw):
            before = scatter_add_rows.launches
            s0 = time.perf_counter()
            aux = real(self, batch, has_alpha, **kw)
            rec["loss"].append(float(aux["loss"]))
            rec["step_s"].append(time.perf_counter() - s0)
            rec["k1"].append(scatter_add_rows.launches - before)
            if "inds_coarse" in batch:
                w = rec["cell_w"][-1]
                err = aux["per_ray_error"].cpu().numpy()
                rec["uniform_loss"].append(float((w * err).sum() / w.sum()))
            return aux
        return f

    def get_batch(real):
        def f(self, index):
            s0 = time.perf_counter()
            batch = real(self, index)
            rec["batch_s"].append(time.perf_counter() - s0)
            if self not in rec["datasets"]:
                rec["datasets"].append(self)
            if "inds_coarse" in batch:
                em = self.error_map[index]
                rec["cell_w"].append(em.sum() / em[batch["inds_coarse"]])
            return batch
        return f

    def update(real):
        def f(self, *a, **k):
            s0 = time.perf_counter()
            real(self, *a, **k)
            rec["update_s"].append(time.perf_counter() - s0)
        return f

    def render(real):
        def f(self, *a, **k):
            s0 = time.perf_counter()
            img, depth = real(self, *a, **k)
            rec["render_s"].append(time.perf_counter() - s0)
            rec["renders"].append(img)
            return img, depth
        return f

    def save_mesh(real):
        def f(*a, **k):
            s0 = time.perf_counter()
            out = real(*a, **k)
            rec["mesh_s"] = time.perf_counter() - s0
            rec["mesh"] = out
            return out
        return f

    stack = contextlib.ExitStack()
    for obj, name, wrap in (
            (Trainer, "__init__", init), (Trainer, "train_one_batch", step),
            (Trainer, "render_image", render),
            (NeRFDataset, "get_batch", get_batch),
            (NeRFDataset, "update_error_map", update),
            (mesh, "save_density_mesh", save_mesh)):
        stack.enter_context(wrapped(obj, name, wrap))
    return stack


def recorded_run(main, argv):
    """One in-process run of an entry point's main(argv) with its record
    (cli_recorder); rec["rc"] is what main returned."""
    rec = {k: [] for k in ("trainers", "loss", "step_s", "k1", "batch_s",
                           "update_s", "datasets", "render_s", "renders",
                           "cell_w", "uniform_loss")}
    rec["lpips_calls"] = 0
    s0 = time.perf_counter()
    with cli_recorder(rec):
        rec["rc"] = main(argv)
    rec["seconds"] = time.perf_counter() - s0
    return rec


def cli_run(argv):
    """One in-process CLI run with its record."""
    from laenerf_tpu_torch.pipeline import cli

    return recorded_run(cli.main, argv)


def check_steps(rec, n, what):
    """n steps, each with a finite loss and at least one K1 launch."""
    if len(rec["loss"]) != n:
        raise AssertionError(f"{what}: {len(rec['loss'])} steps, not {n}")
    if not all(math.isfinite(v) for v in rec["loss"]):
        raise AssertionError(f"{what}: a non-finite loss")
    if min(rec["k1"]) < 1:
        raise AssertionError(f"{what}: a step launched no K1 "
                             f"({rec['k1']})")


def phase_cli(card, dev, tmp):
    """The command-line entry point on a colmap scene at the CLI's model
    width, in process through laenerf_tpu_torch.pipeline.cli.main: -m nerf
    --error_map for CLI_STEPS steps, --test --save_mesh on its workspace,
    then CLI_PATCH_STEPS more steps with --patch_size 8 and the
    patch-LPIPS term (a synthetic VGG-16 npz). Returns K1's launches in the
    three runs and K1's entry at a CLI step's backward input."""
    from laenerf_tpu_torch.editing.vgg import lpips_fn
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.pipeline import cli

    t_phase = time.perf_counter()
    scene = colmap_scene(tmp, dev)
    ws = f"{tmp}/cli_ws"
    common = [scene, "--workspace", ws] + CLI_FLAGS
    opt = cli.build_parser().parse_args(common)
    model_cfg, render_cfg = cli.make_configs(opt)
    spec = model_cfg.grid_spec
    T = spec.table_rows
    phase("cli", f"colmap scene: 16 train views and 1 val at 100x100 in "
                 f"{time.perf_counter() - t_phase:.1f} s; model: "
                 f"{spec.num_levels} levels x C={spec.level_dim}, "
                 f"{T} table rows, bound {render_cfg.bound}, "
                 f"{render_cfg.cascades} cascades of "
                 f"{render_cfg.grid_size}^3, max_steps "
                 f"{render_cfg.max_steps}, march_iters "
                 f"{render_cfg.march_iters}, m_cap_per_ray "
                 f"{render_cfg.m_cap_per_ray}")
    if (spec.num_levels, spec.level_dim, render_cfg.cascades,
            render_cfg.march_iters) != (16, 2, 2, 1024):
        raise AssertionError("the CLI's configuration is not its default "
                             "width")

    # 1. -m nerf --error_map
    before = scatter_add_rows.launches
    with k1_capture(T, nth=CLI_STEPS // 2) as captured:
        rec = cli_run(common + ["--iters", str(CLI_STEPS)])
    check_steps(rec, CLI_STEPS, "-m nerf")
    tr = rec["trainers"][0]
    raw = [float(np.mean(v)) for v in (rec["loss"][:16], rec["loss"][-16:])]
    uni = rec["uniform_loss"]
    first, last = float(np.mean(uni[:16])), float(np.mean(uni[-16:]))
    if not last < first:
        raise AssertionError(f"CLI loss (reweighted to uniform pixels) did "
                             f"not fall: {first} -> {last}")
    train_ds = rec["datasets"][0]
    moved = int((train_ds.error_map != 1.0).sum())
    if not moved:
        raise AssertionError("the error map did not move")
    ckpts = sorted(Path(ws, "checkpoints").glob("*.npz"))
    if not ckpts:
        raise AssertionError("-m nerf wrote no checkpoint")
    step_ms = 1e3 * float(np.median(rec["step_s"][16:]))
    host_ms = [1e3 * float(np.median(rec[k])) for k in ("batch_s",
                                                        "update_s")]
    share = sum(host_ms) / (step_ms + sum(host_ms))
    occ = tr.occ_state
    phase("cli", f"-m nerf: {CLI_STEPS} steps, loss reweighted to uniform "
                 f"pixels {first:.5f} -> {last:.5f} (first/last 16; the "
                 f"batch loss as sampled by the error map {raw[0]:.5f} -> "
                 f"{raw[1]:.5f}; by 16 steps: "
                 f"{np.round([np.mean(uni[i:i + 16]) for i in range(0, CLI_STEPS, 16)], 5).tolist()}"
                 f"), {step_ms:.1f} ms/step median "
                 f"after 16 (mean {1e3 * np.mean(rec['step_s']):.1f}; loss "
                 f"read back each step), K1 {sum(rec['k1'])} launches "
                 f"(at least one a step); host error-map sampling "
                 f"(get_batch) {host_ms[0]:.2f} ms and update "
                 f"{host_ms[1]:.2f} ms a step median, "
                 f"{100 * share:.1f}% of a step; error map: {moved} of "
                 f"{train_ds.error_map.size} entries moved; "
                 f"{occ.iter_density} occupancy refreshes, grid mean "
                 f"density {float(occ.mean_density):.4f}, occ_frac "
                 f"{float(occ.occupancy.float().mean()):.4f}; val PSNR "
                 f"{tr.stats['psnr'][-1]:.2f} dB; checkpoint "
                 f"{ckpts[-1].name}; run {rec['seconds']:.1f} s ({card})")

    # 2. --test --save_mesh
    rec = cli_run(common + ["--test", "--save_mesh", "--mesh_resolution",
                            str(CLI_MESH_RES)])
    frames = sorted(Path(ws, "results").glob("0*.png"))
    if len(frames) != 11 or len(rec["renders"]) != 11:
        raise AssertionError(f"--test wrote {len(frames)} frames")
    for img in rec["renders"]:
        lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
        if not np.isfinite(img).all() or lo < 0.0 or hi > 1.0 + 1e-5:
            raise AssertionError(f"--test frame out of [0, 1]: [{lo}, {hi}]")
    video = Path(ws, "results", "video.mp4")
    video_frames = list(Path(ws, "results", "video_frames").glob("*.png"))
    if not video.exists() and len(video_frames) != 11:
        raise AssertionError("--test wrote no video")
    verts, faces = rec["mesh"]
    if not Path(ws, "mesh.ply").exists():
        raise AssertionError("--save_mesh wrote no mesh.ply")
    peak = float(rec["trainers"][0].occ_state.density_grid.max())
    phase("cli", f"--test: 11 slerp frames finite in [0, 1], "
                 f"{np.mean(rec['render_s']):.2f} s/frame mean (first "
                 f"{rec['render_s'][0]:.2f}); video: "
                 f"{'video.mp4' if video.exists() else 'video_frames/ (11 PNGs)'}"
                 f"; mesh.ply at {CLI_MESH_RES}^3: {len(verts)} vertices, "
                 f"{len(faces)} faces in {rec['mesh_s']:.1f} s (threshold "
                 f"{opt.mesh_threshold}; the density grid's max {peak:.3f}); "
                 f"run "
                 f"{rec['seconds']:.1f} s ({card})")

    # 3. --patch_size 8: the patch-LPIPS term
    with synthetic_vgg16(tmp):
        rec = cli_run(common + ["--patch_size", "8", "--iters",
                                str(CLI_STEPS + CLI_PATCH_STEPS)])
        cpu_fn = lpips_fn(device="cpu")
    check_steps(rec, CLI_PATCH_STEPS, "--patch_size 8")
    if rec["lpips_calls"] != CLI_PATCH_STEPS:
        raise AssertionError(f"the patch-LPIPS term ran in "
                             f"{rec['lpips_calls']} of {CLI_PATCH_STEPS} "
                             f"steps")
    a, b, out = rec["lpips"]
    card_v = float(out.mean())
    cpu_v = float(cpu_fn(a.float().cpu(), b.float().cpu()).mean())
    rel = abs(card_v - cpu_v) / abs(cpu_v)
    if not rel < 1e-5:
        raise AssertionError(f"patch LPIPS card {card_v} vs CPU {cpu_v}")
    launches = scatter_add_rows.launches - before
    phase("cli", f"--patch_size 8: {CLI_PATCH_STEPS} steps with the "
                 f"patch-LPIPS term ({a.shape[0]} patches of "
                 f"{a.shape[1]}x{a.shape[2]} a step), loss "
                 f"{rec['loss'][0]:.5f} -> {rec['loss'][-1]:.5f}, "
                 f"{1e3 * np.median(rec['step_s']):.1f} ms/step median; "
                 f"one batch's patch LPIPS card {card_v:.7e}, CPU "
                 f"{cpu_v:.7e}, rel {rel:.2e} (f32); K1 launches in the "
                 f"three runs {launches} ({card})")

    # 4. K1 on the captured backward input
    if "idx" not in captured:
        raise AssertionError("no CLI backward reached K1")
    site = k1_site(card, dev, "cli_nerf", captured["idx"], captured["rows"],
                   T, "cli", cancels=True)
    phase("cli", f"phase {time.perf_counter() - t_phase:.1f} s; cuts: "
                 f"--iters 10,000 -> {CLI_STEPS} (+{CLI_PATCH_STEPS} with "
                 f"patches), --scale/--offset 0.02/0 0 1.5 -> 0.33/0 0 0, "
                 f"--mesh_resolution 256 -> {CLI_MESH_RES}, 100x100 frames")
    return launches, site


# the CLIP phase: CLIP guidance on the training phase's trainer
CLIP_STEPS = 32
CLIP_HW = 64  # one 64x64 frame a step: 4,096 rays, a train step's count


def clip_tower_check(card, dev, tower, text_z):
    """The tower's loss and image gradient on one seeded [1, 64, 64, 3]
    input, on the card against the CPU (f32, no TF32). The loss -(z . t)
    of two unit vectors nearly cancels (random weights), so its error is
    held relative to its terms' magnitudes, sum |z_i t_i|; the gradient to
    its largest element."""
    from laenerf_tpu_torch.models.clip_vit import (CLIPVision,
                                                   clip_preprocess,
                                                   clip_similarity_loss,
                                                   clip_vision_forward)

    cpu = CLIPVision(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in tower.state_dict().items()})
    g = torch.Generator().manual_seed(5)
    img = torch.rand((1, CLIP_HW, CLIP_HW, 3), generator=g)
    out = []
    for model, d in ((tower, dev), (cpu, torch.device("cpu"))):
        x = img.to(d).requires_grad_(True)
        loss = clip_similarity_loss(model, x, text_z.to(d))
        loss.backward()
        with torch.no_grad():
            z = clip_vision_forward(model, clip_preprocess(img.to(d)))
        out.append((loss.item(), x.grad.cpu(), z.cpu()))
    (loss_card, grad_card, z_card), (loss_cpu, grad_cpu, z_cpu) = out
    t = text_z.cpu() / text_z.cpu().norm()
    terms = (z_cpu[0] * t).abs().sum().item()
    err_loss = abs(loss_card - loss_cpu) / terms
    err_grad = rel_err(grad_card, grad_cpu)
    if not (err_loss < 1e-5 and err_grad < 1e-4):
        raise AssertionError(f"CLIP tower card vs CPU: loss {loss_card} vs "
                             f"{loss_cpu} ({err_loss} of its terms' "
                             f"magnitudes {terms}), image gradient rel "
                             f"{err_grad}")
    phase("clip", f"ViT-B/16 tower card vs CPU on one 64x64 input: loss "
                  f"{loss_card:.9f} vs {loss_cpu:.9f}, difference "
                  f"{abs(loss_card - loss_cpu):.2e}: {err_loss:.2e} of "
                  f"sum |z_i t_i| = {terms:.4f} (held to 1e-5), "
                  f"{abs(loss_card - loss_cpu) / abs(loss_cpu):.2e} of the "
                  f"loss itself; embedding rel {rel_err(z_card, z_cpu):.2e}; "
                  f"image gradient rel {err_grad:.2e} (held to 1e-4)")


def phase_clip(card, dev, tr, ds):
    """Trainer.train_one_batch_clip on the training phase's trainer:
    ViT-B/16 at its published width with random weights (no npz in the
    repo), a seeded [512] text embedding, one rand_poses camera at 64x64 a
    step. Returns (K1 launches, K1's CLIP site)."""
    from laenerf_tpu_torch.data.provider import rand_poses
    from laenerf_tpu_torch.models import clip_vit
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows

    tower, pretrained = clip_vit.load_clip_vision(device=dev)
    widths = (clip_vit.LAYERS, clip_vit.WIDTH, clip_vit.HEADS,
              clip_vit.MLP_DIM, clip_vit.EMBED_DIM, clip_vit.IMAGE_SIZE,
              clip_vit.PATCH)
    if widths != (12, 768, 12, 3072, 512, 224, 16) or \
            tower.blocks["qkv_w"].shape != (12, 768, 2304):
        raise AssertionError(f"CLIP tower not at ViT-B/16's width: {widths}")
    mb = sum(p.numel() * p.element_size() for p in tower.parameters()) / 2**20
    text_z = torch.randn((clip_vit.EMBED_DIM,),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    clip_tower_check(card, dev, tower, text_z)

    # the tower's forward and backward alone, on a step's 64x64 render
    img = torch.rand((1, CLIP_HW, CLIP_HW, 3), device=dev)

    def fwd():
        x = img.detach().requires_grad_(True)
        clip_vit.clip_similarity_loss(tower, x, text_z)

    def fwd_bwd():
        x = img.detach().requires_grad_(True)
        clip_vit.clip_similarity_loss(tower, x, text_z).backward()

    fwd_ms, fwd_bwd_ms = cuda_ms(fwd, reps=10), cuda_ms(fwd_bwd, reps=10)

    T = tr.model_cfg.grid_spec.table_rows
    rng = np.random.RandomState(6)
    radius = float(np.linalg.norm(ds.poses[:, :3, 3], axis=-1).mean())
    intr = np.asarray(ds.intrinsics, np.float32) * (CLIP_HW / ds.H)
    intr[2], intr[3] = CLIP_HW / 2, CLIP_HW / 2
    before = tr.net.encoder.detach().clone()
    losses, step_s, k1_steps = [], [], []
    scatter_add_rows.launches = 0
    with k1_capture(T, nth=CLIP_STEPS // 2) as captured:
        for _ in range(CLIP_STEPS):
            pose = rand_poses(1, rng, radius=radius)[0]
            n0 = scatter_add_rows.launches
            s0 = time.perf_counter()
            aux = tr.train_one_batch_clip(tower, text_z, pose, intr, CLIP_HW,
                                          CLIP_HW)
            losses.append(float(aux["loss"]))  # syncs the step
            step_s.append(time.perf_counter() - s0)
            k1_steps.append(scatter_add_rows.launches - n0)
    launches = scatter_add_rows.launches
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"CLIP step: a non-finite loss {losses}")
    if min(k1_steps) < 1:
        raise AssertionError(f"CLIP step: a step launched no K1 {k1_steps}")
    moved = (tr.net.encoder.detach() - before).abs().max().item()
    if not moved > 0:
        raise AssertionError("CLIP steps did not move the encoder")
    step_ms = 1e3 * float(np.median(step_s[4:]))
    phase("clip", f"{CLIP_STEPS} train_one_batch_clip steps at "
                  f"{CLIP_HW}x{CLIP_HW} (ViT-B/16 at 12 x 768, 12 heads, "
                  f"MLP 3072, proj 512, 224^2, patch 16; "
                  f"{'pretrained' if pretrained else 'random'} weights, "
                  f"{mb:.1f} MB): loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
                  f"encoder moved by up to {moved:.3e}, K1 {launches} "
                  f"launches ({min(k1_steps)}-{max(k1_steps)} a step); "
                  f"{step_ms:.1f} ms/step median after 4; the tower alone "
                  f"(CUDA events, 10 reps) forward {fwd_ms:.2f} ms, backward "
                  f"{fwd_bwd_ms - fwd_ms:.2f} ms: "
                  f"{100 * fwd_bwd_ms / step_ms:.1f}% of a step ({card})")
    site = k1_site(card, dev, "clip", captured["idx"], captured["rows"], T,
                   "clip", cancels=True)
    return launches, site


# the background phase: a fresh trainer at the training cell's width with
# the background network (bg_radius 4, the 2-D 4-level C = 2 lg19 grid)
BG_STEPS = 64


def phase_background(card, dev, tmp, ds):
    """A fresh Trainer(bg_radius=4.0) at the training cell's width, 64
    steps on the procedural scene, one 100^2 render. Returns (K1 launches,
    K1's background site, the trainer)."""
    from laenerf_tpu_torch.data import NeRFDataset
    from laenerf_tpu_torch.data.rays import pixel_rays
    from laenerf_tpu_torch.models import NeRFConfig, RenderConfig
    from laenerf_tpu_torch.models.nerf import nerf_background
    from laenerf_tpu_torch.models.renderer import render_rays_infer
    from laenerf_tpu_torch.ops.raymarch import sph_from_ray
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.train import Trainer

    model_cfg = NeRFConfig(bound=1.0, num_levels=8, level_dim=4,
                           log2_hashmap_size=19, bg_radius=4.0)
    render_cfg = RenderConfig(bound=1.0, cascades=1, grid_size=128,
                              max_steps=256, march_iters=256,
                              m_cap_per_ray=16, density_thresh=10.0,
                              infer_chunk_events=16, infer_compact_factor=4)
    # targets on white (bg_white): with the training phase's random
    # per-pixel backgrounds the network's target would be noise (the loss
    # then sits at that noise's variance, 1/12)
    tr = Trainer(model_cfg, render_cfg, device=dev, lr=1e-2, iters=2000,
                 eval_chunk=16384, workspace=f"{tmp}/ws_bg", bg_white=True)
    T_bg = model_cfg.bg_grid_spec.table_rows
    tr.mark_untrained(ds)
    losses, step_s = [], []
    scatter_add_rows.launches = 0
    with k1_capture(T_bg, nth=BG_STEPS // 2) as captured:
        for step in range(BG_STEPS):
            s0 = time.perf_counter()
            aux = tr.train_one_batch(ds.get_batch(step % len(ds)),
                                     has_alpha=True)
            losses.append(float(aux["loss"]))
            step_s.append(time.perf_counter() - s0)
    launches = scatter_add_rows.launches
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("background: a non-finite loss")
    if launches < 2 * BG_STEPS:
        raise AssertionError(f"background: K1 launched {launches} times in "
                             f"{BG_STEPS} steps (2 tables a step)")
    first, last = float(np.median(losses[:8])), float(np.median(losses[-8:]))
    if not last < first:
        raise AssertionError(f"background: loss did not fall {first} -> "
                             f"{last}")
    # a 100^2 test view, finite in [0, 1], whose background is the
    # network's: the frame equals the same rays composited on black (the
    # model without its background network) plus (1 - weights) times the
    # network's color at each ray's sphere coordinates
    test = NeRFDataset(tmp, "test")
    img, _ = tr.render_image(test.poses[0], test.intrinsics, test.H, test.W)
    if not (np.isfinite(img).all() and img.min() >= 0.0
            and img.max() <= 1.0 + 1e-5):
        raise AssertionError(f"background render: range [{img.min()}, "
                             f"{img.max()}] or non-finite")
    no_bg = copy.copy(tr.ema_net)  # shares the parameters
    no_bg.cfg = dataclasses.replace(model_cfg, bg_radius=-1.0)
    with torch.no_grad():
        rays_o, rays_d = pixel_rays(tr._tensor(test.poses[0]),
                                    tr._tensor(test.intrinsics), test.H,
                                    test.W)
        out = render_rays_infer(tr.ema_net, tr.occ_state.occupancy, rays_o,
                                rays_d, render_cfg=render_cfg)
        black = render_rays_infer(no_bg, tr.occ_state.occupancy, rays_o,
                                  rays_d, render_cfg=render_cfg,
                                  bg_color=0.0)
        bg = nerf_background(tr.ema_net, sph_from_ray(rays_o, rays_d, 4.0),
                             rays_d)
        share = (1.0 - black["weights_sum"])[:, None]
        gap = (out["image"] - (black["image"] + share * bg)).abs().max()
        shown = (share * (bg - 1.0).abs()).max().item()
        ws_min = black["weights_sum"].min().item()
    if not (gap.item() <= 1e-5 and 1.0 - ws_min > 0.05):
        raise AssertionError(f"background: frame vs black composite plus "
                             f"the network's color {gap.item()}, the "
                             f"background's largest share {1.0 - ws_min}")
    phase("background", f"{BG_STEPS} steps with bg_radius 4 (the 2-D "
                        f"4-level C = 2 grid, {T_bg} rows): loss {first:.5f} "
                        f"-> {last:.5f} (medians of the first/last 8), K1 "
                        f"{launches} launches ({launches / BG_STEPS:.1f} a "
                        f"step); {1e3 * np.median(step_s[8:]):.1f} ms/step "
                        f"median after 8; a {test.H}x{test.W} test view in "
                        f"[{img.min():.4f}, {img.max():.4f}], equal within "
                        f"{gap.item():.2e} to the rays on black plus (1 - "
                        f"weights) x the network's color (weights down to "
                        f"{ws_min:.4f}; the network's color moves a pixel up "
                        f"to {shown:.4f} off white) ({card})")
    site = k1_site(card, dev, "background", captured["idx"],
                   captured["rows"], T_bg, "background", cancels=True,
                   precision="f32")
    return launches, site, tr


DP_STEPS = 8


def _snapshot(rep):
    """A copy of a replica's (net, ema, optimizer, scheduler) state."""
    net, ema, opt, sched = rep
    return ({k: v.clone() for k, v in net.state_dict().items()},
            {k: v.clone() for k, v in ema.state_dict().items()},
            copy.deepcopy(opt.state_dict()), sched.state_dict())


def _restore(rep, snap):
    net, ema, opt, sched = rep
    net.load_state_dict(snap[0])
    ema.load_state_dict(snap[1])
    # a deep copy: load_state_dict keeps the moment tensors it is given
    # where their device and dtype already fit
    opt.load_state_dict(copy.deepcopy(snap[2]))
    sched.load_state_dict(snap[3])


def _grads(net):
    return [torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for p in net.parameters()]


def _max_gap(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def phase_parallel(card, dev, tr, ds, tmp):
    """Ray data-parallelism in a one-process NCCL group (one card allows
    world size 1 only), from copies of the background phase's trainer.

    8 steps: each dp_train_step starts from the state the train_step
    beside it (same batch, background and noises) starts from. The losses
    agree within REL_TOL, the gradients within REL_TOL of their largest
    magnitude, and the dp step's parameters and EMA equal those of Adam,
    the LR step and the EMA applied to its own gradients from that state.
    Two trajectories are not compared: K1 sums in float atomics, so two
    train_steps from one state differ in the last bits of a few table
    rows, and Adam (eps 1e-15) scales such differences in small gradients
    up to a share of the learning rate; the phase prints how far two
    8-step train_step runs drift apart. Then dp_render_image against
    render_image. Returns (K1 launches in the dp steps, K1's rank-shard
    site)."""
    import torch.distributed as dist

    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.parallel import (destroy_mesh, dp_render_image,
                                            dp_train_step, make_mesh)
    from laenerf_tpu_torch.train.trainer import (_ema_update, make_optimizer,
                                                 train_step)

    mesh = make_mesh(dev, rank=0, world_size=1,
                     init_method=f"file://{tmp}/rendezvous")
    try:
        def replica():
            net, ema = copy.deepcopy(tr.net), copy.deepcopy(tr.ema_net)
            rep = (net, ema, *make_optimizer(net.parameters(), 1e-2,
                                             tr.iters))
            _restore(rep, _snapshot((tr.net, tr.ema_net, tr.optimizer,
                                     tr.scheduler)))
            return rep

        single, dp, ref, twin = replica(), replica(), replica(), replica()
        g = torch.Generator(device=dev).manual_seed(7)
        T = tr.model_cfg.grid_spec.table_rows
        occ = tr.occ_state.occupancy
        batches = []
        for step in range(DP_STEPS):
            b = ds.get_batch(step % len(ds))
            n = len(b["inds"])
            bg = torch.rand((n, 3), generator=g, device=dev)
            noises = torch.rand((n,), generator=g, device=dev)
            batches.append((
                (occ, tr._tensor(b["pose"]), tr._tensor(b["intrinsics"]),
                 tr._tensor(b["inds"], torch.int64), tr._tensor(b["pixels"])),
                dict(render_cfg=tr.render_cfg, ema_decay=tr.ema_decay,
                     has_alpha=True, bg_white=tr.bg_white, H=b["H"],
                     W=b["W"], bg=bg, noises=noises)))
        losses = {"single": [], "dp": []}
        gaps = {"loss": 0.0, "grad": 0.0, "update": 0.0}
        scales = {"grad": 0.0, "param": 0.0}
        launches = 0
        # each step launches K1 once on the main table, the single step
        # first: call 2 s + 1 is dp step s's
        with k1_capture(T, nth=2 * (DP_STEPS // 2) + 1) as captured:
            for args, kw in batches:
                snap = _snapshot(single)
                aux = train_step(*single, *args, **kw)
                loss_s = aux["loss"].item()
                grads_s = _grads(single[0])
                _restore(dp, snap)
                n0 = scatter_add_rows.launches
                aux = dp_train_step(mesh, *dp, *args, **kw)
                launches += scatter_add_rows.launches - n0
                loss_d = aux["loss"].item()
                grads_d = _grads(dp[0])
                # the reference update on the dp step's gradients
                _restore(ref, snap)
                with torch.no_grad():
                    for p, gd in zip(ref[0].parameters(), grads_d):
                        p.grad = gd.clone()
                ref[2].step()
                ref[3].step()
                _ema_update(ref[0], ref[1], tr.ema_decay)
                losses["single"].append(loss_s)
                losses["dp"].append(loss_d)
                gaps["loss"] = max(gaps["loss"], abs(loss_d - loss_s)
                                   / abs(loss_s))
                gaps["grad"] = max(gaps["grad"], _max_gap(grads_d, grads_s))
                scales["grad"] = max(scales["grad"], max(
                    gs.abs().max().item() for gs in grads_s))
                gaps["update"] = max(
                    gaps["update"],
                    _max_gap(dp[0].parameters(), ref[0].parameters()),
                    _max_gap(dp[1].parameters(), ref[1].parameters()))
                lrs = [[grp["lr"] for grp in rep[2].param_groups]
                       for rep in (dp, ref)]
                if lrs[0] != lrs[1]:
                    raise AssertionError(f"dp_train_step: learning rates "
                                         f"{lrs[0]} after the step, Adam "
                                         f"and the LR step give {lrs[1]}")
                scales["param"] = max(scales["param"], max(
                    p.abs().max().item() for p in ref[0].parameters()))
        for args, kw in batches:
            train_step(*twin, *args, **kw)
        drift = _max_gap(single[0].parameters(), twin[0].parameters())
        if not gaps["loss"] <= REL_TOL:
            raise AssertionError(f"dp_train_step vs train_step: losses "
                                 f"differ by {gaps['loss']} of the loss")
        if not gaps["grad"] <= REL_TOL * scales["grad"]:
            raise AssertionError(f"dp_train_step vs train_step: gradients "
                                 f"differ by {gaps['grad']} (largest "
                                 f"magnitude {scales['grad']})")
        if not gaps["update"] <= REL_TOL * scales["param"]:
            raise AssertionError(f"dp_train_step: parameters or EMA differ "
                                 f"by {gaps['update']} from Adam and the EMA "
                                 f"on its own gradients (largest magnitude "
                                 f"{scales['param']})")
        if launches < DP_STEPS:
            raise AssertionError(f"dp_train_step: K1 launched {launches} "
                                 f"times in {DP_STEPS} steps")
        pose, intr = ds.poses[0], ds.intrinsics
        img1, _ = tr.render_image(pose, intr, ds.H, ds.W)
        img_dp, _ = dp_render_image(mesh, tr.ema_net, occ, pose, intr, ds.H,
                                    ds.W, render_cfg=tr.render_cfg)
        gap = float(np.abs(img_dp - img1).max())
        if not gap <= 2e-3:
            raise AssertionError(f"dp_render_image vs render_image: {gap}")
        phase("parallel", f"one-process {dist.get_backend()} group (world "
                          f"size 1): {DP_STEPS} dp_train_steps, each beside "
                          f"a train_step from the same state: losses within "
                          f"{gaps['loss']:.3e} of each other (held to "
                          f"{REL_TOL}), gradients within {gaps['grad']:.3e} "
                          f"(largest magnitude {scales['grad']:.4e}, held to "
                          f"{REL_TOL} of it), parameters and EMA within "
                          f"{gaps['update']:.3e} of Adam and the EMA on the "
                          f"dp step's gradients (largest magnitude "
                          f"{scales['param']:.4f}); losses "
                          f"{losses['dp'][0]:.6f} -> {losses['dp'][-1]:.6f}; "
                          f"two {DP_STEPS}-step train_step runs from one "
                          f"state drift {drift:.3e} apart (not held: K1's "
                          f"float atomics under Adam); K1 {launches} "
                          f"launches in the dp steps; dp_render_image vs "
                          f"render_image at {ds.H}x{ds.W}: {gap:.2e} "
                          f"({card})")
        site = k1_site(card, dev, "rank_shard", captured["idx"],
                       captured["rows"], T, "parallel", cancels=True)
    finally:
        destroy_mesh()
    return launches, site


# the gates phase: the port's gate and eval scripts at the quality gate
# model's width (docs/quality_gate_r5.json: 16 levels, C = 2, lg19,
# max_steps 1024, so march_iters 512 and m_cap_per_ray 40). Cuts, listed
# in PERF.md: --iters 30,000 -> 128, --n_train 64 -> 4, --H 800 -> 100;
# the recolor gate's --style_steps 10,000 -> 100, --palette_steps 1,500 ->
# 50, --distill_steps 7,000 -> 16; render_orbit --frames 30 -> 3, --H 400
# -> 64
GATE_STEPS = 128  # at 64 the fine-tune still moved the background more
                  # than the edit moved its region (PERF.md)
GATE_MODEL = ["--num_levels", "16", "--level_dim", "2", "--max_steps",
              "1024"]
GATE_FLAGS = GATE_MODEL + ["--lg", "19", "--n_train", "4", "--H", "100",
                           "--aa", "2"]
RECOLOR_GATE_FLAGS = GATE_MODEL + [
    "--lg", "19", "--style_steps", "100", "--palette_steps", "50",
    "--distill_steps", "16", "--grow_iterations", "4000"]
ORBIT_FLAGS = GATE_MODEL + ["--log2_hashmap_size", "19", "--frames", "3",
                            "--H", "64", "--step", "1", "--step", "2"]


def check_frames(frames, what):
    for img in frames:
        lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
        if not np.isfinite(img).all() or lo < 0.0 or hi > 1.0 + 1e-5:
            raise AssertionError(f"{what}: a frame out of [0, 1]: "
                                 f"[{lo}, {hi}]")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def gate_session(card, tr, ws):
    """EditSession on the gate's trained trainer: a frame equal to
    render_image at the camera's pose, a click at the centre pixel, grow,
    the grow grid, and the selection view restoring the occupancy."""
    from laenerf_tpu_torch.data import NeRFDataset
    from laenerf_tpu_torch.pipeline import EditSession

    s = EditSession(tr, NeRFDataset(f"{ws}/scene", "train"))
    cam = s.camera
    img, _ = s.render_frame(downscale=8)
    H, W = cam.H // 8, cam.W // 8
    intr = cam.intrinsics / 8
    intr[2], intr[3] = W / 2, H / 2
    ref, _ = tr.render_image(cam.pose, intr, H, W)
    gap = float(np.abs(img - ref).max())
    if img.shape != (H, W, 3) or not gap <= 1e-6:
        raise AssertionError(f"EditSession.render_frame: {img.shape}, "
                             f"{gap} from render_image")
    pt = s.click_select(cam.W // 2, cam.H // 2)
    bound = tr.render_cfg.bound
    if not (np.isfinite(pt).all() and np.abs(pt).max() <= bound):
        raise AssertionError(f"click_select: {pt} (bound {bound})")
    clicked = int(s.edit_grid.grid.sum())
    s.grow(iterations=4000)
    grown = int(s.edit_grid.grid.sum())
    if not grown > clicked:
        raise AssertionError(f"grow: {clicked} -> {grown} cells")
    s.extract_grow_grid()
    occ = tr.occ_state
    density = occ.density_grid.cpu().numpy()
    thresh = min(float(occ.mean_density), 0.01)
    shell = s.grow_grid.grid.astype(bool)
    # the grow grid's rule (EditGrid.grid_from_growing_queue): cells of the
    # selection's queue whose density passes the growing threshold; the
    # occupancy's threshold is min(mean density, 10), so a grown cell may
    # lie outside the occupancy
    if not shell.any() or np.any(density[shell] < thresh):
        raise AssertionError(f"extract_grow_grid: {int(shell.sum())} cells, "
                             f"{int((density[shell] < thresh).sum())} under "
                             f"the threshold {thresh}")
    outside = int((shell & (occ.occupancy.cpu().numpy() == 0)).sum())
    before = occ.occupancy
    kept = before.clone()
    sel, _ = s.render_frame(downscale=8, show_selection=True)
    if tr.occ_state.occupancy is not before \
            or not torch.equal(tr.occ_state.occupancy, kept):
        raise AssertionError("render_frame(show_selection=True) did not "
                             "restore the occupancy")
    check_frames([img, sel], "EditSession")
    phase("gates", f"EditSession on the gate's trainer: a {W}x{H} frame "
                   f"{gap:.1e} from render_image; the centre pixel selects "
                   f"({', '.join(f'{v:.4f}' for v in pt)}) ({clicked} "
                   f"cells); grow "
                   f"4000 pops -> {grown} cells; grow grid "
                   f"{int(shell.sum())} cells over the threshold {thresh:.4g}"
                   f" ({outside} of them outside the occupancy); the "
                   f"selection view restores the occupancy ({card})")


def gate_ops_on_card(card, dev, tr):
    """Morton codes and the encoder's input gradient at the gate's width on
    the card, against the same calls on the CPU."""
    from laenerf_tpu_torch.ops import hashgrid, morton

    g = torch.Generator().manual_seed(11)
    coords = torch.randint(0, 1024, (1 << 20, 3), generator=g,
                           dtype=torch.int32)
    coords[:2] = torch.tensor([[1023, 1023, 1023], [0, 1023, 0]])
    codes = morton.morton3d(coords.to(dev))
    ref = morton.morton3d(coords)
    inv = morton.morton3d_invert(codes)
    grid = torch.rand((8, 1 << 15), generator=g)
    bits = morton.packbits(grid.to(dev), 0.5)
    if not (torch.equal(codes.cpu(), ref) and torch.equal(inv.cpu(), coords)
            and torch.equal(bits.cpu(), morton.packbits(grid, 0.5))
            and torch.equal(morton.unpackbits(bits).cpu(),
                            (grid > 0.5).to(torch.uint8))):
        raise AssertionError("morton / packbits on the card differ from "
                             "the CPU")

    spec = tr.model_cfg.grid_spec
    table = tr.net.encoder.detach()
    x = torch.rand((16384, 3), generator=g) * 2.2 - 1.1
    cot = torch.randn((16384, spec.output_dim), generator=g)
    grads = []
    for device in (dev, torch.device("cpu")):
        xd = x.to(device).requires_grad_(True)
        out = hashgrid.hashgrid_encode(table.to(device), xd, spec)
        (out * cot.to(device)).sum().backward()
        grads.append(xd.grad.cpu())
    scale = grads[1].abs().max().item()
    err = (grads[0] - grads[1]).abs().max().item()
    outside = (x.abs() > 1.0).any(dim=-1)
    if not (scale > 0 and err <= 1e-5 * scale
            and not grads[0][outside].any()):
        raise AssertionError(f"encoder input gradient card vs CPU: {err} "
                             f"(largest {scale})")
    phase("gates", f"morton3d / invert on {coords.shape[0]} coordinates "
                   f"(0 and 1023 included) and packbits / unpackbits on "
                   f"{grid.numel()} cells: the card equals the CPU; the "
                   f"encoder's input gradient at the gate's width "
                   f"({spec.num_levels} levels x C={spec.level_dim}, "
                   f"{x.shape[0]} points, {int(outside.sum())} outside the "
                   f"bound at 0): card vs CPU {err:.3e} of the largest "
                   f"{scale:.4e} (held to 1e-5 of it) ({card})")


def phase_gates(card, dev, tmp):
    """The port's gate and eval scripts, in process through their main:
    the quality gate at the gate model's width (its untrained network's
    test PSNR first, --eval_only; then GATE_STEPS steps), the
    recolor gate on its workspace, render_orbit, then EditSession on the
    gate's trainer, Morton codes and the encoder's input gradient on the
    card. Returns K1's launches in the scripts and K1's entry at a gate
    step's backward input."""
    from PIL import Image

    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows
    from laenerf_tpu_torch.scripts import quality_gate, recolor_gate
    from laenerf_tpu_torch.scripts.eval import render_orbit

    t_phase = time.perf_counter()
    ws = f"{tmp}/gate"
    base = ["--workspace", ws] + GATE_FLAGS
    rec = recorded_run(quality_gate.main, base + ["--eval_only"])
    untrained = read_json(f"{ws}/quality_gate.json")
    model_cfg, render_cfg = quality_gate.make_configs(
        quality_gate.build_parser().parse_args(GATE_FLAGS))
    spec = model_cfg.grid_spec
    T = spec.table_rows
    if (spec.num_levels, spec.level_dim, spec.log2_hashmap_size,
            render_cfg.max_steps, render_cfg.march_iters,
            render_cfg.m_cap_per_ray) != (16, 2, 19, 1024, 512, 40):
        raise AssertionError("the gate's configuration is not the gate "
                             "model's width")
    phase("gates", f"quality gate --eval_only on a new workspace (scene "
                   f"generation, the untrained network's test split): "
                   f"test PSNR "
                   f"{untrained['test_psnr']} dB, run "
                   f"{rec['seconds']:.1f} s; model: {spec.num_levels} levels "
                   f"x C={spec.level_dim}, {T} table rows, max_steps "
                   f"{render_cfg.max_steps}, march_iters "
                   f"{render_cfg.march_iters}, m_cap_per_ray "
                   f"{render_cfg.m_cap_per_ray}")

    before = scatter_add_rows.launches
    with k1_capture(T, nth=GATE_STEPS // 2) as captured:
        rec = recorded_run(quality_gate.main,
                           base + ["--iters", str(GATE_STEPS)])
    check_steps(rec, GATE_STEPS, "quality gate")
    q = read_json(f"{ws}/quality_gate.json")
    first, last = (float(np.mean(v)) for v in (rec["loss"][:16],
                                               rec["loss"][-16:]))
    if not last < first:
        raise AssertionError(f"quality gate loss did not fall: {first} -> "
                             f"{last}")
    if not q["test_psnr"] > untrained["test_psnr"]:
        raise AssertionError(f"quality gate: test PSNR {q['test_psnr']} "
                             f"not above the untrained network's "
                             f"{untrained['test_psnr']}")
    if not q["test_ssim"] <= 1.0 or rec["rc"] != 0:
        raise AssertionError(f"quality gate: SSIM {q['test_ssim']}, exit "
                             f"{rec['rc']}")
    pre = rec["renders"]
    if len(pre) != 8:
        raise AssertionError(f"quality gate rendered {len(pre)} test views")
    check_frames(pre, "quality gate")
    tr = rec["trainers"][0]
    step_ms = 1e3 * float(np.median(rec["step_s"][16:]))
    phase("gates", f"quality gate: {GATE_STEPS} steps, loss {first:.5f} -> "
                   f"{last:.5f} (first/last 16), {step_ms:.1f} ms/step "
                   f"median after 16 (mean "
                   f"{1e3 * np.mean(rec['step_s']):.1f}; loss read back each "
                   f"step), K1 {sum(rec['k1'])} launches (at least one a "
                   f"step); test PSNR {q['test_psnr']} dB (untrained "
                   f"{untrained['test_psnr']}), SSIM {q['test_ssim']}, LPIPS "
                   f"{q['test_lpips']}; {len(pre)} test frames finite in "
                   f"[0, 1], {np.mean(rec['render_s']):.2f} s/frame "
                   f"({q['render_s_per_frame']} in the JSON); occ_frac "
                   f"{float(tr.occ_state.occupancy.float().mean()):.4f}; "
                   f"run {rec['seconds']:.1f} s; device {q['device']!r}")

    rargs = recolor_gate.build_parser().parse_args(RECOLOR_GATE_FLAGS)
    n0 = scatter_add_rows.launches
    rec = recorded_run(recolor_gate.main,
                       ["--workspace", ws] + RECOLOR_GATE_FLAGS)
    recolor_k1 = scatter_add_rows.launches - n0
    r = read_json(f"{ws}/recolor_ws/recolor_gate.json")
    steps = (f"{rargs.style_steps} LAENeRF and {rargs.distill_steps} "
             f"fine-tune steps")
    if rec["rc"] != 0 or recolor_k1 < rargs.style_steps + \
            rargs.distill_steps:
        raise AssertionError(f"recolor gate: exit {rec['rc']}, K1 "
                             f"{recolor_k1} launches in {steps}")
    post = rec["renders"][-8:]
    check_frames(post, "recolor gate")
    inside, outside = [], []
    for i, (a, b) in enumerate(zip(post, pre)):
        mask = np.asarray(Image.open(
            f"{ws}/recolor_ws/masks/test/{i:03d}.png"))[..., 1] > 0
        d2 = np.sum((a - b) ** 2, axis=-1) / 3.0
        inside.append(d2[mask])
        outside.append(d2[~mask])
    in_mse = float(np.mean(np.concatenate(inside)))
    out_mse = float(np.mean(np.concatenate(outside)))
    # the edit changes its region more than the background; the gate's
    # bg-MSE is against the ground truth, so it also holds the NeRF's own
    # error after GATE_STEPS steps, and is only required to be finite
    if not (math.isfinite(r["bg_mse"]) and in_mse > out_mse):
        raise AssertionError(f"recolor gate: bg-MSE {r['bg_mse']}; the "
                             f"edit's in-mask MSE {in_mse} not above its "
                             f"MSE outside the masks {out_mse}")
    timings = r["timings"]
    phase("gates", f"recolor gate: bg-MSE {r['bg_mse']:.5f} (post-edit vs "
                   f"ground truth outside the masks); between the pre- and "
                   f"post-edit test renders, MSE {in_mse:.5f} inside the "
                   f"masks ({sum(map(np.size, inside))} pixels) above "
                   f"{out_mse:.5f} outside them; train PSNR after "
                   f"{r['psnr_train_after']:.2f} dB; K1 {recolor_k1} "
                   f"launches in {steps}; phase seconds "
                   + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
                   + f"; wall {r['wall_clock_s']} s, run "
                     f"{rec['seconds']:.1f} s ({card})")

    rec = recorded_run(render_orbit.main, [
        "--workspace", ws, "--save_json", f"{ws}/orbit.json"] + ORBIT_FLAGS)
    o = read_json(f"{ws}/orbit.json")
    oargs = render_orbit.build_parser().parse_args(["--workspace", ws]
                                                   + ORBIT_FLAGS)
    if rec["rc"] != 0 or len(rec["renders"]) != oargs.frames:
        raise AssertionError(f"render_orbit: exit {rec['rc']}, "
                             f"{len(rec['renders'])} frames")
    check_frames(rec["renders"], "render_orbit")
    for step in oargs.step:
        m = o[f"step_{step}"]
        if not (math.isfinite(m["mse_mean"])
                and m["n_pairs"] == oargs.frames - step):
            raise AssertionError(f"render_orbit step {step}: {m}")
    phase("gates", f"render_orbit: {len(rec['renders'])} frames at "
                   f"{oargs.H}x{oargs.H}, "
                   f"{np.mean(rec['render_s']):.2f} s/frame; consistency "
                   f"MSE step 1 {o['step_1']['mse_mean']:.3e} "
                   f"({o['step_1']['n_pairs']} pairs), step 2 "
                   f"{o['step_2']['mse_mean']:.3e} "
                   f"({o['step_2']['n_pairs']} pairs), LPIPS "
                   f"{o['step_1']['lpips_mean']}; run {rec['seconds']:.1f} s")
    launches = scatter_add_rows.launches - before

    gate_session(card, tr, ws)
    gate_ops_on_card(card, dev, tr)
    if "idx" not in captured:
        raise AssertionError("no gate backward reached K1")
    site = k1_site(card, dev, "quality_gate", captured["idx"],
                   captured["rows"], T, "gates", cancels=True)
    phase("gates", f"phase {time.perf_counter() - t_phase:.1f} s; K1 "
                   f"launches in the gate scripts {launches}")
    return launches, site


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    from laenerf_tpu_torch.models import NeRFConfig
    from laenerf_tpu_torch.ops import cuda_build
    from laenerf_tpu_torch.ops.composite import (
        composite_rays_train_packed, composite_rays_train_packed_backward)
    from laenerf_tpu_torch.ops.raymarch import march_rays_train
    from laenerf_tpu_torch.ops.scatter_add import scatter_add_rows

    dev = torch.device("cuda", 0)
    card = card_line()
    phase("device", f"{torch.cuda.get_device_name(0)}, torch "
                    f"{torch.__version__}, CUDA {torch.version.cuda}; "
                    f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(cuda_build.load_library, SOURCES))
    for src in SOURCES:
        info = cuda_build.build_info[src]
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "Used" in ln]
        spills = sum(map(int, re.findall(r"(\d+) bytes spill stores",
                                         info["ptxas"])))
        phase("build", f"{src} built in {info['seconds']:.1f} s (nvcc "
                       f"sm_90a); ptxas: {' | '.join(regs) or 'cached'}; "
                       f"spill stores {spills} B")
        for name, regs, spill, smem in ptxas_kernels(info["ptxas"],
                                                     REPORTED_KERNELS):
            phase("build", f"ptxas {name}: {regs} registers, {smem} B "
                           f"shared memory, {spill} B spill stores")
    phase("build", f"all sources in {time.perf_counter() - t0:.1f} s")
    for src, names in (("gather_probes.cu", GATHER_KERNELS),
                       ("construct_probes.cu", FILL_KERNELS)):
        sass = sass_counts(cuda_build.build_info[src]["path"], names)
        phase("build", f"cuobjdump -sass of {src}: " + (
            "no cuobjdump" if sass is None else "; ".join(
                f"{n} {c['instances']} instances, STG.E.128 in "
                f"{c['stg128']}, LDG.E.128 in {c['ldg128']}, {c['calls']} "
                f"CALL, {c['fadds']} FADD" for n, c in sass.items())))
        if sass and "dynamic_loop_kernel" in sass \
                and not sass["dynamic_loop_kernel"]["fadds"]:
            raise AssertionError("dynamic_loop_kernel has no FADD: its "
                                 "loop over lo[k] was folded away")

    model_cfg = NeRFConfig(bound=1.0, num_levels=8, level_dim=4,
                           log2_hashmap_size=19)
    k1 = phase_k1(card, dev, model_cfg)
    gather_results = phase_gather(card, dev)
    gather_launches = phase_probes(card)
    scatter_results = phase_scatter(card, dev)
    construct_results = phase_constructs(card, dev)
    scatter_launches = phase_scatter_probes(card)
    march, k9_entry = phase_march(card, dev)

    # K8's and K9's launches in each phase whose K1 launches the kernels
    # line sums
    k8, k9, k9_bwd = {}, {}, {}
    counted = ((march_rays_train, k8), (composite_rays_train_packed, k9),
               (composite_rays_train_packed_backward, k9_bwd))

    def main_path(name, run, *args):
        for fn, _ in counted:
            fn.launches = 0
        out = run(*args)
        for fn, per_phase in counted:
            per_phase[name] = fn.launches
        return out

    with tempfile.TemporaryDirectory() as tmp:
        scatter_add_rows.launches = 0
        tr, ds = main_path("train", phase_train, card, dev, tmp)
        train_launches = scatter_add_rows.launches
        if train_launches < TRAIN_STEPS:
            raise AssertionError(f"K1 launched {train_launches} times in "
                                 f"{TRAIN_STEPS} train steps")
        for name, per_phase in (("K8", k8), ("K9's forward", k9),
                                ("K9's backward", k9_bwd)):
            if per_phase["train"] < TRAIN_STEPS:
                raise AssertionError(f"{name} launched {per_phase['train']} "
                                     f"times in {TRAIN_STEPS} train steps")
        main_path("render", phase_render, card, tr, ds)
        launches = scatter_add_rows.launches
        phase("train", f"K1 launches on the main path: {launches}")
        k1_train_us = phase_profile(tr, ds)
        k1_span_turns(tr, ds)
        scatter_add_rows.launches = 0
        recolor_launches, laenerf_site = main_path(
            "recolor", phase_recolor, card, dev, tr, ds, tmp)
        launches += recolor_launches
        phase("recolor", f"K1 launches on the main path, train and recolor: "
                         f"{launches}")
        scatter_add_rows.launches = 0
        style_launches, style_site = main_path(
            "style", phase_style, card, dev, tr, ds, tmp)
        scatter_add_rows.launches = 0
        npr_launches, npr_site = main_path("npr", phase_npr, card, dev, tr,
                                           ds, tmp)
        launches += style_launches + npr_launches
        phase("npr", f"K1 launches on the main path, train, recolor, style "
                     f"and NPR: {launches}")
        phase_lpips(card, tr, tmp)
        clip_launches, clip_site = main_path("clip", phase_clip, card, dev,
                                             tr, ds)
        launches += clip_launches
        scatter_add_rows.launches = 0
        cli_launches, cli_site = main_path("cli", phase_cli, card, dev, tmp)
        launches += cli_launches
        phase("cli", f"K1 launches on the main path, train, recolor, style, "
                     f"NPR, CLIP and CLI: {launches}")
        bg_launches, bg_site, bg_tr = main_path(
            "background", phase_background, card, dev, tmp, ds)
        dp_launches, dp_site = main_path("parallel", phase_parallel, card,
                                         dev, bg_tr, ds, tmp)
        launches += bg_launches + dp_launches
        phase("parallel", f"K1 launches on the main path, train, recolor, "
                          f"style, NPR, CLIP, CLI, background and "
                          f"data-parallel: {launches}")
        scatter_add_rows.launches = 0
        gate_launches, gate_site = main_path("gates", phase_gates, card,
                                             dev, tmp)
        launches += gate_launches
        phase("gates", f"K1 launches on the main path, train, recolor, "
                       f"style, NPR, CLIP, CLI, background, data-parallel "
                       f"and the gates: {launches}; K8's in the same phases "
                       f"{sum(k8.values())} ({k8}); K9's forward "
                       f"{sum(k9.values())} ({k9}), backward "
                       f"{sum(k9_bwd.values())} ({k9_bwd})")

    gather_src = "laenerf_tpu_torch/csrc/gather_probes.cu"
    scatter_src = "laenerf_tpu_torch/csrc/sorted_scatter.cu"
    print(json.dumps({"kernels": [{
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "laenerf_tpu_torch/csrc/scatter_add.cu",
        "replaces": "laenerf_tpu/ops/scatter_add.py:46",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "device_ms": k1["device_ms"],
        "library_device_ms": k1["library_device_ms"],
        "train_step_device_ms": (None if k1_train_us is None
                                 else k1_train_us / 1e3),
        "sites": k1["sites"] + [laenerf_site, style_site, npr_site,
                                cli_site, clip_site, bg_site, dp_site,
                                gate_site],
    }] + [kernel_entry(name, gather_src, gather_results, gather_launches)
          for name in ("take_rows", "take_lanes", "grid_probe")]
        + [kernel_entry(name, scatter_src, scatter_results, scatter_launches)
           for name in ("tile_scatter", "worklist_scatter")]
        + [kernel_entry(name, "laenerf_tpu_torch/csrc/construct_probes.cu",
                        construct_results, scatter_launches)
           for name in dict.fromkeys(r["kernel"]
                                     for r in construct_results)]
        + [dict(march, launches=sum(k8.values())),
           dict(k9_entry, launches=sum(k9.values()),
                backward_launches=sum(k9_bwd.values()))]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
