"""program_readers.py on records built by hand, and program_trace.py's
measurement on the CPU at the tiny size."""

import pytest

from nerfbench import program_readers as pr
from nerfbench import program_trace
from nerfbench.tests import tiny

MS = 1_000_000  # ns


def _span(i, name, parent, step, start_ms, end_ms, **attrs):
    return {"name": name, "id": i, "parent": parent, "step": step,
            "attrs": attrs, "start": start_ms * MS, "end": end_ms * MS}


def _train_record():
    """Two train steps: marches of 2 and 4 ms, 64 and 32 events of 10
    rays, 240 samples, 14 waits."""
    spans = [_span(0, "train.step", None, 0, 0, 10),
             _span(1, "render.march", 0, 0, 1, 3),
             _span(2, "march.block", 1, 0, 1, 2, events=32),
             _span(3, "train.step", None, 1, 10, 20),
             _span(4, "render.march", 3, 1, 11, 15),
             # a step cut by the end of the recording counts for nothing
             _span(5, "train.step", None, 2, 20, 20)]
    spans[-1]["end"] = None
    counters = {"march.events": 96, "march.slots": 960,
                "render.samples": 240, "sync.march_alive": 10,
                "sync.host_copy": 4}
    return {"program": {"spans": spans, "counters": counters},
            "window_s": 0.02, "window_steps": 2}


def _edit_record():
    """Two LAENeRF steps: forward 1 and 3 ms, loss 2 ms in the first
    only (its crop inside), backward 4 ms, optimizer 1 ms."""
    spans = [_span(0, "laenerf.step", None, 7, 0, 10),
             _span(1, "laenerf.forward", 0, 7, 0, 1),
             _span(2, "laenerf.loss", 0, 7, 1, 3),
             _span(3, "laenerf.crop", 2, 7, 2, 3),
             _span(4, "laenerf.backward", 0, 7, 3, 7),
             _span(5, "laenerf.optimizer", 0, 7, 7, 8),
             _span(6, "laenerf.step", None, 8, 10, 20),
             _span(7, "laenerf.forward", 6, 8, 10, 13),
             _span(8, "laenerf.backward", 6, 8, 13, 17),
             _span(9, "laenerf.optimizer", 6, 8, 17, 18)]
    return {"program": {"spans": spans, "counters": {}},
            "window_s": 0.02, "window_steps": 2}


TRAIN = {"march_ms.train": 3.0, "march_events.train": 48.0,
         "march_yield.train": 25.0, "host_syncs.train": 7.0}
EDIT = {"forward_ms.edit": 2.0, "loss_ms.edit": 1.0,
        "backward_ms.edit": 4.0, "optimizer_ms.edit": 1.0}


@pytest.mark.parametrize("record, want", [(_train_record, TRAIN),
                                          (_edit_record, EDIT)])
def test_readers_on_a_hand_built_record(record, want):
    rec = record()
    got = {k: f(rec) for k, f in pr.READERS.items()}
    for name, value in got.items():
        if name in want:
            assert value == pytest.approx(want[name]), name
        else:  # the other step's metrics find nothing here
            assert value is None, name


@pytest.mark.parametrize("rec", [
    None, {}, {"program": None},
    {"program": {"spans": [], "counters": {}}},
    # a record the parent's run writes: no program key
    {"spans": {"k1": [0.001]}, "meta": {}, "profile": None, "inputs": {},
     "window_s": 1.0, "window_steps": 2, "window_work": 16384}])
def test_readers_without_a_program_trace(rec):
    assert all(f(rec) is None for f in pr.READERS.values())


@pytest.mark.parametrize("cell, names", [
    ("ngp_train", set(TRAIN)), ("laenerf_recolor", set(EDIT))])
def test_measure_reads_its_cell(cell, names, tmp_path, monkeypatch):
    """The tool's traced window gives its cell's four metrics; the NeRF
    cell's program counts agree with the harness's K1 rows."""
    tiny.use_cache(monkeypatch, tmp_path)
    out = program_trace.measure(tiny.spec(cell), 1234567890123, 0.5, "cpu",
                                turns=1, turn_seconds=0.2, check_steps=2,
                                audit_steps=0)
    assert set(out["metrics"]) == names
    assert all(v > 0 for v in out["metrics"].values())
    assert len(out["turns"]["off"]) == len(out["turns"]["on"]) == 1
    if cell == "ngp_train":
        assert out["k1_rows_check"]["equal"]
        assert 0 < out["metrics"]["march_yield.train"] <= 100
    else:
        assert abs(out["edit_time_check"]["gap_pct"]) < 50
