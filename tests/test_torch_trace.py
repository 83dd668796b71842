"""The port's tracer (laenerf_tpu_torch/utils/timers.py) inside the NeRF
train step (train/trainer.py) and the LAENeRF step
(editing/style_trainer.py), on the CPU at the sizes of
test_torch_trainer.py and test_torch_editing.py: nothing recorded while
off, the spans' nesting and step ids, the march and sample counters
against what the march and K1 saw, the VGG stack's spans and operation
count inside a style step (editing/vgg.py), and the spans as
`record_function` ranges under a profiler."""

import tempfile
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from laenerf_tpu_torch.data import NeRFDataset, generate_synthetic_scene
from laenerf_tpu_torch.editing import style_trainer as st
from laenerf_tpu_torch.editing import vgg
from laenerf_tpu_torch.editing.style import StyleNetwork
from laenerf_tpu_torch.editing.laenerf import LAENeRFConfig
from laenerf_tpu_torch.models import NeRFConfig, RenderConfig
from laenerf_tpu_torch.ops import raymarch
from laenerf_tpu_torch.train import trainer as ttrain
from laenerf_tpu_torch.utils import timers
from nerfbench import counts_vgg

MODEL_CFG = NeRFConfig(bound=1.0, num_levels=4, log2_hashmap_size=12)
# 128 events in blocks of 32, so the march checks for live rays
RENDER_CFG = RenderConfig(bound=1.0, cascades=1, grid_size=32,
                          max_steps=128, march_iters=128, m_cap_per_ray=16,
                          density_thresh=10.0)
LCFG = LAENeRFConfig(num_levels=4, log2_hashmap_size=12,
                     num_palette_bases=4)
EDIT_HW, N_PAD, CROP = 32, 1024, 16
NERF_PHASES = ("occupancy.refresh", "train.inputs", "render.march",
               "render.network", "render.composite", "train.backward",
               "train.optimizer")
LAENERF_PHASES = ("laenerf.forward", "laenerf.loss", "laenerf.backward",
                  "laenerf.optimizer")


@pytest.fixture(autouse=True)
def tracer_off():
    """Every case starts and ends with the tracer off and empty."""
    timers.stop()
    yield
    timers.stop()


@pytest.fixture(scope="module")
def nerf():
    """A tiny trainer and dataset: step 0 refreshes the occupancy grid."""
    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_scene(tmp, n_train=4, n_val=1, n_test=1, H=16,
                                 W=16, device="cpu")
        ds = NeRFDataset(tmp, "train", num_rays=256)
    tr = ttrain.Trainer(MODEL_CFG, RENDER_CFG, device="cpu", lr=1e-2,
                        iters=100, update_interval=2)
    tr.mark_untrained(ds)
    return tr, ds


class _EditViews:
    """The part of EditDataset that LAENeRFTrainer reads: padded views of
    300 rays in a 20 x 20 box with a 16 x 16 crop."""

    H = W = EDIT_HW
    crop_h = crop_w = CROP

    def __init__(self, n_views=3, seed=7):
        rng = np.random.RandomState(seed)
        box = np.array([r * EDIT_HW + c for r in range(6, 26)
                        for c in range(8, 28)])
        self.views = []
        for _ in range(n_views):
            inds = np.sort(rng.choice(box, 300, replace=False))
            valid = np.arange(N_PAD) < inds.size
            pad = np.full(N_PAD, EDIT_HW * EDIT_HW, np.int32)
            pad[:inds.size] = inds
            d = rng.randn(N_PAD, 3)
            self.views.append({
                "valid": valid, "inds": pad,
                "x_term": (rng.uniform(-0.6, 0.6, (N_PAD, 3))
                           * valid[:, None]).astype(np.float32),
                "dirs": (d / np.linalg.norm(d, axis=-1,
                                            keepdims=True)).astype(
                                                np.float32),
                "targets": rng.rand(N_PAD, 3).astype(np.float32),
                "crop_origin": np.array([6, 8], np.int32),
                "cut_gt": rng.rand(CROP, CROP, 3).astype(np.float32),
                "cut_smooth": rng.rand(CROP, CROP).astype(np.float32),
                "depth_factor": 0.05,
            })

    def __len__(self):
        return len(self.views)

    def epoch_indices(self):
        return np.arange(len(self.views))


class _Style:
    """A style network's interface: a Gram-like loss on the resized crop."""

    targets = None

    def gram_loss(self, x, targets):
        return torch.mean(x ** 2)


def _laenerf(style):
    weights = st.StyleLossWeights(smooth_trans_weight=5e-2, offset_loss=1e-3,
                                  palette_loss_valid=1e-1,
                                  style_weight=1.0 if style else 0.0,
                                  warmup_iterations=0)
    tr = st.LAENeRFTrainer(LCFG, weights, _EditViews(),
                           style_network=_Style() if style else None,
                           crop_size=16, device="cpu")
    tr.step = 1  # past warm-up: the crop losses run
    return tr


def _nerf_steps(nerf, n):
    tr, ds = nerf
    for _ in range(n):
        tr.train_one_batch(ds.get_batch(tr.global_step % len(ds)),
                           has_alpha=True)


def _run(kind, nerf, steps=1):
    if kind == "nerf":
        _nerf_steps(nerf, steps)
    else:
        _laenerf(style=False).train_steps(steps)


def _by_id(rec):
    return {s["id"]: s for s in rec["spans"]}


def _root(s, ids):
    while s["parent"] is not None:
        s = ids[s["parent"]]
    return s


@pytest.mark.parametrize("kind", ["nerf", "laenerf"])
def test_off_records_nothing(kind, nerf, monkeypatch):
    """Off, a step opens no span, enters no profiler range and adds to no
    counter."""
    def refuse(*a, **k):
        raise AssertionError("the tracer recorded while off")

    monkeypatch.setattr(timers.TRACER, "opened", refuse)
    monkeypatch.setattr(timers._Span, "__init__", refuse)
    assert timers.span("train.step", step=0) is timers.span("k1")
    _run(kind, nerf)
    assert timers.TRACER.spans == [] and timers.TRACER.counters == {}
    assert timers.TRACER.open == []


def test_nerf_step_spans_nest(nerf):
    """Two steps (the first refreshes the grid): every span lies inside its
    parent and carries its root train.step's step id."""
    tr, ds = nerf
    tr.global_step = 0
    full = tr.occ_state.iter_density < 16
    batches = [ds.get_batch(i) for i in range(2)]
    timers.start()
    for b in batches:
        tr.train_one_batch(b, has_alpha=True)
    rec = timers.stop()
    ids = _by_id(rec)
    roots = [s for s in rec["spans"] if s["parent"] is None]
    assert [(s["name"], s["step"]) for s in roots] == [("train.step", 0),
                                                      ("train.step", 1)]
    for s in rec["spans"]:
        assert s["end"] is not None and s["start"] <= s["end"]
        assert s["step"] == _root(s, ids)["step"]
        if s["parent"] is not None:
            p = ids[s["parent"]]
            assert p["start"] <= s["start"] and s["end"] <= p["end"], (
                s["name"], p["name"])
    names = {s["name"] for s in rec["spans"]}
    assert set(NERF_PHASES) | {"march.skip_field", "march.alive",
                               "march.block", "march.pack", "k1"} <= names
    for s in rec["spans"]:
        if s["name"] in NERF_PHASES:
            assert ids[s["parent"]]["name"] == "train.step", s["name"]
        elif s["name"].startswith("march."):
            assert ids[s["parent"]]["name"] == "render.march"
    refresh = [s for s in rec["spans"] if s["name"] == "occupancy.refresh"]
    assert [(s["step"], s["attrs"]) for s in refresh] == [(0, {"full": full})]


@pytest.mark.parametrize("kind, parent", [("nerf", "train.backward"),
                                          ("laenerf", "laenerf.backward")])
def test_k1_nests_under_backward(kind, parent, nerf):
    timers.start()
    _run(kind, nerf)
    rec = timers.stop()
    ids = _by_id(rec)
    k1 = [s for s in rec["spans"] if s["name"] == "k1"]
    assert len(k1) == 1
    assert ids[k1[0]["parent"]]["name"] == parent
    assert set(k1[0]["attrs"]) == {"rows", "C", "table_rows"}


def test_spans_nest_across_threads():
    """The stack of open spans is the process's: a span opened on another
    thread (as autograd's backward thread does) nests under the span open
    on the main thread."""
    timers.start()
    with timers.span("train.backward", step=5):
        t = threading.Thread(target=lambda: timers.span("k1").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    rec = timers.stop()
    back, k1 = rec["spans"]
    assert (k1["name"], k1["parent"], k1["step"]) == ("k1", back["id"], 5)


def test_march_counters_match_the_events_run(nerf, monkeypatch):
    """march.events is the events the march ran, march.slots N times that,
    and the march.block spans' events add up to it."""
    calls = []
    real = raymarch.make_march_event

    def counted(*a, **k):
        event = real(*a, **k)

        def f(t):
            calls.append(t.shape[0])
            return event(t)
        return f

    monkeypatch.setattr(raymarch, "make_march_event", counted)
    timers.start()
    _nerf_steps(nerf, 2)
    rec = timers.stop()
    c = rec["counters"]
    assert c["march.events"] == len(calls) > 0
    assert c["march.slots"] == sum(calls) == 256 * len(calls)
    blocks = [s["attrs"]["events"] for s in rec["spans"]
              if s["name"] == "march.block"]
    assert sum(blocks) == len(calls)
    assert c["sync.march_alive"] == sum(
        s["name"] == "march.alive" for s in rec["spans"])


def test_samples_match_k1_rows(nerf):
    """Each step's K1 call adds one row a (sample, level, corner):
    render.samples x num_levels x 8 rows."""
    for _ in range(3):
        timers.start()
        _nerf_steps(nerf, 1)
        rec = timers.stop()
        (k1,) = [s for s in rec["spans"] if s["name"] == "k1"]
        assert k1["attrs"]["rows"] == (rec["counters"]["render.samples"]
                                       * MODEL_CFG.num_levels * 8) > 0
        assert k1["attrs"]["C"] == MODEL_CFG.level_dim


@pytest.mark.parametrize("style", [False, True])
def test_laenerf_step_phases(style):
    """Each LAENeRF step has its four phases once each under laenerf.step,
    the crop under the loss (and the Gram term under the crop), and the
    steps' ids run on from the trainer's step."""
    tr = _laenerf(style)
    timers.start()
    tr.train_steps(4)
    rec = timers.stop()
    ids = _by_id(rec)
    roots = [s for s in rec["spans"] if s["parent"] is None]
    assert [(s["name"], s["step"]) for s in roots] == [
        ("laenerf.step", i) for i in range(1, 5)]
    for root in roots:
        kids = [s["name"] for s in rec["spans"] if s["parent"] == root["id"]]
        assert sorted(kids) == sorted(LAENERF_PHASES)
    want = {"laenerf.crop": "laenerf.loss", "laenerf.gram": "laenerf.crop"}
    found = {s["name"]: ids[s["parent"]]["name"] for s in rec["spans"]
             if s["name"] in want}
    assert found == (want if style else {"laenerf.crop": "laenerf.loss"})
    assert sum(s["name"] == "laenerf.crop" for s in rec["spans"]) == 4


@pytest.mark.parametrize("recording", [False, True])
def test_spans_are_profiler_ranges(recording, nerf):
    """Under a profiler, recording or not, each span is a record_function
    range named after it."""
    if recording:
        timers.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nerf_steps(nerf, 1)
        _laenerf(style=True).train_steps(1)
    timers.stop()
    ranges = {e.name for e in prof.events()
              if e.name.startswith(timers.PREFIX)}
    want = {"train.step", "train.inputs", "render.march", "march.block",
            "render.network", "train.backward", "k1", "laenerf.step",
            "laenerf.loss", "laenerf.crop", "laenerf.gram", "data.batch"}
    assert {timers.PREFIX + n for n in want} <= ranges


def test_phase_timer_spans():
    """PhaseTimer keeps its totals and makes each phase a pipeline span."""
    timer = timers.PhaseTimer()
    timers.start()
    timer.start("edit_dataset")
    with timers.span("laenerf.step", step=3):
        pass
    dt = timer.stop("edit_dataset")
    rec = timers.stop()
    phase, step = rec["spans"]
    assert phase["name"] == "pipeline.edit_dataset"
    assert step["parent"] == phase["id"]
    assert timer["edit_dataset"] == dt > 0
    assert abs(dt - (phase["end"] - phase["start"]) / 1e9) < 1e-2
    assert set(timer.summary()) == {"edit_dataset", "sum"}


STYLE_LAYERS = (10, 12, 14)
VGG19_TO_14 = [64, 64, "M", 128, 128, "M", 256, 256, 256]


@pytest.fixture(scope="module")
def style_net():
    """A StyleNetwork at the crop's size, on vgg_init's seeded filters."""
    img = np.random.RandomState(3).rand(3, CROP, CROP).astype(np.float32)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*random filters")
        return StyleNetwork(img, style_layers=STYLE_LAYERS, size=CROP,
                            device="cpu")


def _style_trainer(style_net):
    weights = st.StyleLossWeights(smooth_trans_weight=5e-2, offset_loss=1e-3,
                                  palette_loss_valid=1e-1, style_weight=1.0,
                                  warmup_iterations=0)
    tr = st.LAENeRFTrainer(LCFG, weights, _EditViews(),
                           style_network=style_net, crop_size=CROP,
                           device="cpu")
    tr.step = 1  # past warm-up: the Gram term runs
    return tr


def test_vgg_spans_nest(style_net):
    """A style step's stack: style.vgg under laenerf.gram with its size and
    layers, style.vgg_backward under laenerf.backward, inside it and
    before K1 (the encoder's backward comes last)."""
    tr = _style_trainer(style_net)
    timers.start()
    tr.train_steps(2)
    rec = timers.stop()
    ids = _by_id(rec)
    fw = [s for s in rec["spans"] if s["name"] == "style.vgg"]
    bw = [s for s in rec["spans"] if s["name"] == "style.vgg_backward"]
    assert len(fw) == len(bw) == 2
    for s in fw:
        assert ids[s["parent"]]["name"] == "laenerf.gram"
        assert s["attrs"] == {"size": [CROP, CROP],
                              "layers": list(STYLE_LAYERS)}
    for s in bw:
        p = ids[s["parent"]]
        assert p["name"] == "laenerf.backward" and s["attrs"] == {}
        assert p["start"] <= s["start"] <= s["end"] <= p["end"]
        assert s["step"] == p["step"]
        (k1,) = [k for k in rec["spans"]
                 if k["name"] == "k1" and k["parent"] == p["id"]]
        assert s["end"] <= k1["start"]


def test_vgg_backward_nests_across_threads(style_net):
    """The stack's backward run on another thread (as autograd's is on the
    card) nests under the span open on the main thread."""
    x = torch.rand((3, 20, 24), requires_grad=True)
    timers.start()
    loss = style_net(x)
    with timers.span("laenerf.backward", step=9):
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    rec = timers.stop()
    ids = _by_id(rec)
    (bw,) = [s for s in rec["spans"] if s["name"] == "style.vgg_backward"]
    assert ids[bw["parent"]]["name"] == "laenerf.backward"
    assert bw["step"] == 9 and bw["end"] is not None
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_vgg_flops_match_the_count(style_net):
    """style.vgg_flops adds the benchmark's count of the stack's
    convolutions: twice the forward's for a differentiated call (the input
    gradient costs as much again), once for one under no_grad; and the
    ImageNet constants' two uploads a call count as waits."""
    fwd = counts_vgg.stack_flops(VGG19_TO_14, (CROP, CROP), 14)
    assert vgg.vgg_flops(style_net.kinds, (CROP, CROP), 14) == fwd
    tr = _style_trainer(style_net)
    timers.start()
    tr.train_steps(3)
    with torch.no_grad():
        style_net(torch.rand((3, 12, 12)))
    rec = timers.stop()
    assert rec["counters"]["style.vgg_flops"] == 3 * 2 * fwd + fwd
    assert rec["counters"]["sync.vgg_normalize"] == 4 * 2


def test_style_off_records_nothing(style_net, monkeypatch):
    """Off, a style step opens no span, adds to no counter and puts no
    span node into the autograd graph; its numbers are those of a
    recorded step."""
    def refuse(*a, **k):
        raise AssertionError("the tracer recorded while off")

    losses = {}
    for on in (True, False):
        tr = _style_trainer(style_net)
        if on:
            timers.start()
        else:
            monkeypatch.setattr(timers.TRACER, "opened", refuse)
            monkeypatch.setattr(timers._Span, "__init__", refuse)
            monkeypatch.setattr(vgg._OpenBackward, "apply", refuse)
        losses[on] = tr.train_steps(2)
        losses[on, "params"] = {n: p.detach().clone()
                                for n, p in tr.model.named_parameters()}
        timers.stop()
    assert timers.TRACER.spans == [] and timers.TRACER.counters == {}
    assert losses[True] == losses[False]
    for n, p in losses[True, "params"].items():
        assert torch.equal(p, losses[False, "params"][n]), n
