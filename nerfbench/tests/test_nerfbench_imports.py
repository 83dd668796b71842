"""What the harness and the reference load, by whole top-level names: the
harness never JAX or the JAX package, the reference not the program
either."""

import subprocess
import sys
from pathlib import Path

import pytest

from nerfbench import run

ROOT = Path(__file__).resolve().parents[2]
HARNESS = ("nerfbench.run", "nerfbench.control",
           "nerfbench.drivers.nerf_train", "nerfbench.drivers.laenerf_train",
           "laenerf_tpu_torch.pipeline.cli")
REFERENCE = ("nerfbench.reference.common", "nerfbench.reference.ngp_blender",
             "nerfbench.reference.laenerf_palette8")


def loaded_top_names(modules):
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "print(' '.join(sorted({n.split('.')[0] "
            "for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = loaded_top_names(HARNESS)
    assert "laenerf_tpu_torch" in names  # the program is loaded
    assert not names & {"jax", "jaxlib", "flax", "laenerf_tpu"}


def test_reference_loads_no_program():
    names = loaded_top_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "laenerf_tpu",
                        "laenerf_tpu_torch"}


@pytest.mark.parametrize("loaded,found", [
    (["laenerf_tpu_torch", "laenerf_tpu_torch.ops"], []),
    (["laenerf_tpu", "laenerf_tpu.ops"], ["laenerf_tpu"]),
    (["jax._src.core"], ["jax"]),
    (["jaxlibx", "flaxen"], []),
])
def test_banned_modules_compares_whole_names(monkeypatch, loaded, found):
    fake = {n: None for n in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.banned_modules() == found
