"""What decides `correct`, at a size the CPU runs in seconds: the
reference agrees with the program's CPU path, the control and the planted
faults read far above it, a sound run passes the cells' limits and a run
with the timed path broken underneath fails them. One test runs the
control on the card (marked `cuda`)."""

import importlib

import pytest
import torch

from nerfbench import control, run
from nerfbench.tests import tiny

CELLS = ("ngp_train", "laenerf_recolor")


def _driver(spec):
    return importlib.import_module(
        f"nerfbench.drivers.{spec['traffic']['kind']}")


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_program(cell, tmp_path, monkeypatch):
    tiny.use_cache(monkeypatch, tmp_path)
    spec = tiny.spec(cell)
    r = _driver(spec).Run(spec["config"], spec["traffic"], 2 ** 31 + 7,
                          "cpu")
    r.checked_steps()
    prog, err = r.program_readings()
    assert err is None
    assert max(prog.values()) < 1e-5, prog
    ctl = _driver(spec).control_readings(r)
    for name in ("control_fp8", "half_batch"):
        assert max(ctl[name].values()) > 1e-3, (name, ctl[name])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path, monkeypatch):
    tiny.use_cache(monkeypatch, tmp_path)
    spec = tiny.spec(cell)
    out, _ = run.run_cell(spec, 11, 0.5, 0, device="cpu")
    ok, checks = run.decide(out.readings, spec["limits"], out.error)
    assert ok, checks
    assert out.attempted >= 1 and out.end_to_end["setup_s"] > 0


def _frozen_nerf(monkeypatch):
    mod = importlib.import_module("laenerf_tpu_torch.train.trainer")
    real = mod.make_optimizer

    def make(*a, **k):
        opt, sched = real(*a, **k)
        opt.step = lambda *a, **k: None
        return opt, sched
    monkeypatch.setattr(mod, "make_optimizer", make)


def _half_nerf(monkeypatch):
    mod = importlib.import_module("laenerf_tpu_torch.train.trainer")
    real = mod.train_loss

    def loss(net, occ, pose, intr, inds, pixels, **k):
        h = inds.shape[0] // 2
        return real(net, occ, pose, intr, inds[:h], pixels[:h], **k)
    monkeypatch.setattr(mod, "train_loss", loss)


def _frozen_laenerf(monkeypatch):
    mod = importlib.import_module("laenerf_tpu_torch.editing.style_trainer")
    real = mod.make_style_optimizer

    def make(*a, **k):
        opt = real(*a, **k)
        opt.step = lambda *a, **k: None
        return opt
    monkeypatch.setattr(mod, "make_style_optimizer", make)


def _half_laenerf(monkeypatch):
    mod = importlib.import_module("laenerf_tpu_torch.editing.style_trainer")
    real = mod.laenerf_train_step

    def step(model, optimizer, active, batch, **k):
        b = dict(batch)
        v = b["valid"]
        b["valid"] = v & (torch.arange(v.shape[0], device=v.device)
                          < v.sum() // 2)
        return real(model, optimizer, active, b, **k)
    monkeypatch.setattr(mod, "laenerf_train_step", step)


FAULTS = {
    ("ngp_train", "state_unchanged"): _frozen_nerf,
    ("ngp_train", "half_batch"): _half_nerf,
    ("laenerf_recolor", "state_unchanged"): _frozen_laenerf,
    ("laenerf_recolor", "half_batch"): _half_laenerf,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_broken_step_is_not_correct(cell, fault, tmp_path, monkeypatch):
    tiny.use_cache(monkeypatch, tmp_path)
    spec = tiny.spec(cell)
    FAULTS[cell, fault](monkeypatch)
    out, _ = run.run_cell(spec, 12, 0.5, 0, device="cpu")
    ok, checks = run.decide(out.readings, spec["limits"], out.error)
    assert not ok, checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card, tmp_path, monkeypatch):
    """The reference in float8 in the program's place, on three seeds at a
    test's size (the tiny cell's grid), fails the cell's limits while the
    program passes them."""
    tiny.use_cache(monkeypatch, tmp_path)
    spec = tiny.spec(cell)
    for line in control.readings(cell, [21, 22, 23], 3, card, spec):
        ok, _ = run.decide(line["program"], spec["limits"], line["error"])
        assert ok, line
        bad, _ = run.decide(line["control_fp8"], spec["limits"], None)
        assert not bad, line


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_metrics(cell, tmp_path, monkeypatch):
    """A --trace 1 run: the host spans are read; on the CPU the profiler
    sees no device operation, so the device metrics read nothing."""
    tiny.use_cache(monkeypatch, tmp_path)
    spec = tiny.spec(cell)
    out, _ = run.run_cell(spec, 13, 0.5, 1, device="cpu")
    res, _ = run.result(spec, out, None, 1, {"platform": "cpu"})
    assert res["correct"], res["checks"]
    names = {m["name"] for m in spec["per_layer"]}
    got = set(res["metrics"])
    assert got <= names
    if cell == "ngp_train":
        assert {"batch_ms.train", "occupancy_ms.train"} <= got
    else:
        assert res["metrics"]["window_rays_per_s.edit"]["value"] > 0
    assert "device_idle.train" not in got and "device_idle.edit" not in got
