"""counts.py against numbers worked by hand."""

import json
from pathlib import Path

import pytest

from nerfbench import counts, probe, readers
from nerfbench.reference.common import GridSpec

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                  / "ngp_blender.json").read_text())


def test_table_rows_of_the_published_grid():
    # 16 levels from 16 to 2048, 2^19 rows at most: the dense levels hold
    # (res + 1)^3 rows rounded up to 8 (17^3 = 4,913 -> 4,920, 24^3, 32^3,
    # 44^3, 60^3), the rest 524,288
    spec = GridSpec(16, 2, 16, 19, 2048.0)
    assert spec.level_sizes[:5] == (4920, 13824, 32768, 85184, 216000)
    assert spec.table_rows == 6_119_864


def test_k1_bytes_at_the_train_site():
    # 8,192 rays x 32 samples = 262,144 samples, 16 levels x 8 corners:
    # 33,554,432 rows of C = 2 bf16 (4 B), int32 indices (4 B), and the
    # 6,119,864 x 2 float32 table (48,958,912 B)
    n = counts.k1_bytes(262_144 * 128, 2, 6_119_864)
    assert n == 33_554_432 * 8 + 48_958_912 == 317_394_368
    ms, by = counts.bound_of(n)
    assert by == "bytes"
    assert ms == pytest.approx(317_394_368 / 3.35e12 * 1e3)
    assert 0.0947 < ms < 0.0948  # ~95 µs


def test_k1_bytes_at_the_laenerf_site():
    # ~55,000 rays x 128 rows at C = 2: 56.3 MB of rows and indices and
    # the 49 MB table, ~31 µs
    ms, _ = counts.bound_of(counts.k1_bytes(55_000 * 128, 2, 6_119_864))
    assert ms == pytest.approx((55_000 * 128 * 8 + 48_958_912)
                               / 3.35e12 * 1e3)
    assert 0.031 < ms < 0.032


def test_mlp_flops():
    # sigma net 32 -> 64 -> 16, colour net 31 -> 64 -> 64 -> 3
    assert counts.mlp_flops([32, 64, 16]) == 2 * (2048 + 1024) == 6144
    assert counts.mlp_flops([31, 64, 64, 3]) == 2 * (1984 + 4096 + 192)


def test_nerf_step_is_byte_bound():
    c = dict(CFG, table_rows=6_119_864)
    n_params = 6_119_864 * 2 + 3072 + 12544 // 2
    least, by = counts.nerf_step(c, 8192, 262_144, 1024, n_params)
    assert by == "bytes"
    # forward rows read (the whole table: 33.5 M rows > 6.1 M), the
    # gradient table written, Adam and EMA 10 words a parameter, the rays
    n_bytes = (48_958_912 + 48_958_912 + 10 * n_params * 4 + 8192 * 16)
    assert least == pytest.approx(n_bytes / 3.35e12)
    # ~15 GFLOP of MLP products, fwd and bwd: 15 µs at 989 TFLOP/s
    mlp = 3 * 262_144 * (6144 + 12544)
    assert 14.6e9 < mlp < 14.8e9
    # a 1.3 s step reads as ~0.014% of the roofline
    assert 0.012 < 100 * least / 1.3 < 0.016


def test_laenerf_step_is_byte_bound():
    c = {"num_levels": 16, "level_dim": 2, "table_rows": 6_119_864,
         "num_palette_bases": 8, "hidden_dim": 64, "num_layers": 3,
         "dir_degree": 3}
    least, by = counts.laenerf_step(c, 55_000, 12_260_000, 400 * 400)
    assert by == "bytes"
    assert 1.2e-4 < least < 1.5e-4


def _record():
    # two K1 calls of 335 MB each: 0.1 ms apiece at 3.35 TB/s
    return {"profile": {"busy_s": 0.1, "window_s": 0.4,
                        "kernels_per_step": 300.0,
                        "span_device_us": {"k1": [100.0, 100.0]}},
            "inputs": {"k1_bytes": [335_000_000, 335_000_000],
                       "step_least_s": 0.02},
            "spans": {"batch": [0.001, 0.003]},
            "window_steps": 10, "window_s": 2.0}


def test_readers_against_a_worked_record():
    rec = _record()
    assert readers.device_idle(rec) == pytest.approx(75.0)
    assert readers.launches_per_step(rec) == 300.0
    assert readers.k1_roofline(rec) == pytest.approx(100.0)
    assert readers.step_mfu(rec) == pytest.approx(10.0)  # 0.02 s of 0.2 s
    assert readers.span_ms(rec, "batch") == pytest.approx(2.0)


def test_readers_find_nothing_to_read():
    for read in (readers.device_idle, readers.launches_per_step,
                 readers.k1_roofline, readers.step_mfu):
        assert read(None) is None
    rec = _record()
    rec["profile"] = None
    assert readers.device_idle(rec) is None
    assert readers.k1_roofline(rec) is None
    rec = _record()
    rec["inputs"]["k1_bytes"] = rec["inputs"]["k1_bytes"][:1]
    assert readers.k1_roofline(rec) is None  # calls and bytes disagree
    assert readers.span_ms(rec, "occupancy") is None


def test_fenced_spans_own_the_operations_between_their_markers():
    # two k1 calls; the profiler's device clock runs 30 µs early, so the
    # first call's fill seems to start before its host range: the markers
    # still bracket it
    ranges = [(100.0, "k1"), (400.0, "k1")]
    marks = [75.0, 140.0, 375.0, 430.0]
    ops = [(50.0, 5.0), (80.0, 15.0), (100.0, 20.0), (380.0, 10.0),
           (390.0, 30.0), (500.0, 7.0)]
    assert probe.fenced_device_us(ranges, marks, ops) == {"k1": [35.0, 40.0]}
    assert probe.fenced_device_us(ranges, marks[:3], ops) == {}
