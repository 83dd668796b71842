"""The port never imports JAX: every module of laenerf_tpu_torch imports in a
fresh interpreter with no jax in sys.modules afterwards."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, pkgutil, sys
import laenerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(laenerf_tpu_torch.__path__,
                                               "laenerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "laenerf_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(n) >= 20  # every module of the slice was imported


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py never falls back to the CPU: with no visible GPU it
    exits non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
