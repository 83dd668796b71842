"""The `laenerf_style` cell at a size the CPU runs in seconds (tiny.py's
cut, crop_size 32): the reference follows the program, every control and
planted fault reads above the cell's limits, a sound run is correct and a
traced run gives its metrics their inputs; the readers and the counts on
records and shapes worked by hand. One test reads the traced run on the
card (marked `cuda`)."""

import importlib
import json

import pytest
import torch

from nerfbench import counts, counts_vgg, run
from nerfbench.drivers import laenerf_style as drv
from nerfbench.tests import tiny

CELL = "laenerf_style"
METRICS = ("vgg_roofline.style", "step_mfu.style", "device_idle.style",
           "launches_per_step.style")


def spec():
    s = tiny.spec(CELL)
    s["config"]["crop_size"] = 32
    return s


def _fails(readings, limits):
    ok, _ = run.decide(readings, limits, None)
    return not ok


def test_reference_follows_the_program(tmp_path, monkeypatch):
    tiny.use_cache(monkeypatch, tmp_path)
    s = spec()
    r = drv.Run(s["config"], s["traffic"], 2 ** 31 + 9, "cpu")
    r.checked_steps()
    prog, err = r.program_readings()
    assert err is None
    assert max(prog.values()) < 1e-4, prog
    assert prog["gram_gap"] < 1e-6, prog
    ctl = drv.control_readings(r)
    for name, *_ in drv.CONTROLS:
        assert _fails(ctl[name], s["limits"]), (name, ctl[name])
    # the TF32 stack is caught by the Gram term's own limit
    assert ctl["vgg_tf32"]["gram_gap"] > s["limits"]["limits"]["gram_gap"]


def test_sound_run_is_correct(tmp_path, monkeypatch):
    tiny.use_cache(monkeypatch, tmp_path)
    s = spec()
    out, _ = run.run_cell(s, 21, 0.5, 0, device="cpu")
    ok, checks = run.decide(out.readings, s["limits"], out.error)
    assert ok, checks
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap", "gram_gap"}
    assert out.attempted >= 1 and out.end_to_end["setup_s"] > 0


def _bf16_stack(monkeypatch):
    """The program's convolutions with operands and outputs in bfloat16."""
    mod = importlib.import_module("laenerf_tpu_torch.editing.vgg")
    real = mod.F.conv2d

    def conv(x, w, b=None, **k):
        return real(x.bfloat16().float(), w.bfloat16().float(), b,
                    **k).bfloat16().float()

    monkeypatch.setattr(mod, "F", type("F", (), {
        "conv2d": staticmethod(conv), "max_pool2d": mod.F.max_pool2d}))


def _no_gram_gradient(monkeypatch):
    """The Gram term's gradient lost: the crop detached on its way in."""
    mod = importlib.import_module("laenerf_tpu_torch.editing.style")
    real = mod.StyleNetwork.gram_loss
    monkeypatch.setattr(mod.StyleNetwork, "gram_loss",
                        lambda self, img, t: real(self, img.detach(), t))


@pytest.mark.parametrize("fault", [_bf16_stack, _no_gram_gradient])
def test_broken_style_step_is_not_correct(fault, tmp_path, monkeypatch):
    tiny.use_cache(monkeypatch, tmp_path)
    s = spec()
    fault(monkeypatch)
    out, _ = run.run_cell(s, 22, 0.5, 0, device="cpu")
    ok, checks = run.decide(out.readings, s["limits"], out.error)
    assert not ok, checks


def test_traced_run_gives_the_readers_their_inputs(tmp_path, monkeypatch):
    """A --trace 1 run on the CPU: the host-clock metric reads; the
    profiler sees no device operation, so the device metrics read nothing,
    but each profiled call of the stack, forward and backward, carries
    its counted operations."""
    tiny.use_cache(monkeypatch, tmp_path)
    s = spec()
    assert {m["name"] for m in s["per_layer"]} == set(METRICS)
    out, _ = run.run_cell(s, 23, 0.5, 1, device="cpu")
    res, _ = run.result(s, out, None, 1, {"platform": "cpu"})
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"step_mfu.style"}
    assert res["metrics"]["step_mfu.style"]["value"] > 0
    fwd = counts_vgg.stack_flops(s["config"]["vgg19_layout"], (32, 32), 14)
    n_views = s["config"]["n_views"]
    assert out.trace["inputs"]["vgg_flops"] == [fwd] * (2 * n_views)
    # every traced step differentiates its call of the stack
    assert len(out.trace["spans"]["vgg_backward"]) == len(
        out.trace["spans"]["vgg"]) > 2 * n_views


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device metrics read the card")
    return "cuda"


@pytest.mark.cuda
def test_traced_run_reads_its_metrics_on_the_card(card, tmp_path,
                                                  monkeypatch):
    tiny.use_cache(monkeypatch, tmp_path)
    s = spec()
    out, _ = run.run_cell(s, 24, 0.5, 1, device=card)
    res, _ = run.result(s, out, None, 1, {"platform": "gpu"})
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(METRICS), res["metrics"]
    assert 0 < res["metrics"]["vgg_roofline.style"]["value"] <= 100


def _reader(name):
    return run.metric_reader(name)


def test_vgg_roofline_reads_a_worked_record():
    """Two profiled steps: forwards of 10 and 12 µs, backwards of 20 and
    24 µs, 66 µs in all; four calls of 0.67 GFLOP at 67 TFLOP/s take 40
    µs at the least: 60.6%."""
    rec = {"profile": {"span_device_us": {"vgg": [10.0, 12.0],
                                          "vgg_backward": [20.0, 24.0]}},
           "inputs": {"vgg_flops": [0.67e9] * 4}}
    got = _reader("vgg_roofline.style")(rec)
    assert got == pytest.approx(100.0 * 40.0 / 66.0)
    # a parent's record, or calls that do not pair up, read nothing
    assert _reader("vgg_roofline.style")({"profile": None}) is None
    rec["inputs"]["vgg_flops"] = [0.67e9] * 3
    assert _reader("vgg_roofline.style")(rec) is None


def test_step_mfu_reads_a_worked_record():
    """A least time of 1 ms over 500 steps in 5 s (10 ms a step): 10%."""
    rec = {"window_steps": 500, "window_s": 5.0,
           "inputs": {"step_least_s": 1e-3}}
    assert _reader("step_mfu.style")(rec) == pytest.approx(10.0)


def test_style_counts():
    """VGG-19 to conv3_3 at 256x256: 24.39 GFLOP forward (the sum over
    the seven convolutions); the style step's least time adds twice that
    at the float32 rate to the recolor step's operations, so it is
    operation-bound at about 0.73 ms."""
    s = run.load_spec(CELL)
    c = dict(s["config"], table_rows=6_119_864)
    fwd = counts_vgg.stack_flops(c["vgg19_layout"], (256, 256), 14)
    assert fwd == 2 * 9 * 256 * 256 * (3 * 64 + 64 * 64) \
        + 2 * 9 * 128 * 128 * (64 * 128 + 128 * 128) \
        + 2 * 9 * 64 * 64 * (128 * 256 + 2 * 256 * 256)
    assert fwd == pytest.approx(24.39e9, rel=1e-3)
    parts = counts_vgg.laenerf_parts(c, 49_917, 12_300_000, 400 * 480)
    assert counts.step_least_s(*parts) == counts.laenerf_step(
        c, 49_917, 12_300_000, 400 * 480)
    least, by = counts_vgg.style_step(c, 49_917, 12_300_000, 400 * 480)
    assert by == "operations"
    assert least == pytest.approx(2 * fwd / counts.F32_OPS_PER_S
                                  + parts[1] / counts.F32_OPS_PER_S
                                  + parts[0] / counts.BF16_TC_OPS_PER_S)
    assert 0.7e-3 < least < 0.8e-3


def test_configuration_keeps_the_recolor_keys():
    """The style configuration holds every key of the recolor one at the
    same value, beside its own; only warm-up is cut."""
    with open(run.ROOT / "configs" / "laenerf_palette8.json") as f:
        recolor = json.load(f)
    style = run.load_spec(CELL)["config"]
    own = ("name", "about", "published", "assumed")
    for k, v in recolor.items():
        if k not in own:
            assert style[k] == v, k
    assert style["reduced"] == ["warmup_iterations"]
    assert style["style_layers"] == [10, 12, 14]
    assert style["crop_size"] == 256 and style["style_weight"] == 130.0
