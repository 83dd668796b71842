"""The gate and evaluation scripts of the port (counterparts of the
repository's scripts/quality_gate.py, scripts/recolor_gate.py and
scripts/eval/), each a module with main(argv=None) and the same flags and
defaults:

    python -m laenerf_tpu_torch.scripts.quality_gate [--iters 30000] ...
    python -m laenerf_tpu_torch.scripts.recolor_gate [--mode recolor] ...
    python -m laenerf_tpu_torch.scripts.eval.render_orbit --workspace ws
    python -m laenerf_tpu_torch.scripts.eval.consistency_metrics --frames_dir d
    python -m laenerf_tpu_torch.scripts.eval.mse_background --scene s ...

They run on the GPU; LAENERF_PLATFORM=cpu runs them on the CPU (the CLI's
select_device), and without a GPU and without it they raise. Importing a
script runs nothing: arguments are parsed inside main.
"""
