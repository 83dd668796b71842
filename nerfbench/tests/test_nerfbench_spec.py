"""BENCHMARK.json against the benchmark's contract, every cell resolving
its files by name, and a cell added as new files only."""

import json
import re
import shutil
from pathlib import Path

import pytest

from nerfbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nerfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files(cell):
    spec = run.load_spec(cell)
    kind = spec["traffic"]["kind"]
    assert (ROOT / "nerfbench" / "drivers" / f"{kind}.py").is_file()
    assert spec["cell"]["chips"] in run.load_driver(spec).CHIPS
    assert spec["limits"]["limits"]
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(run.metric_reader(m["name"]))


def test_names_units_and_lengths():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)


def test_new_cell_is_new_files_only(tmp_path, monkeypatch):
    """A throwaway configuration, mix, limits and metric, added as new files
    to a copy of the benchmark plus new entries in its BENCHMARK.json,
    resolve by name; no file that was there changes."""
    src = ROOT / "nerfbench"
    dst = tmp_path / "nerfbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__"))
    before = {p.relative_to(dst): p.read_bytes() for p in dst.rglob("*")
              if p.is_file()}
    shutil.copy(dst / "configs" / "ngp_blender.json",
                dst / "configs" / "throwaway_cfg.json")
    mix = json.loads((dst / "traffic" / "train_scratch_8k.json").read_text())
    mix["num_rays"] = 4096
    (dst / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    shutil.copy(dst / "limits" / "ngp_train.json",
                dst / "limits" / "throwaway_cell.json")
    (dst / "metrics" / "throwaway_metric.py").write_text(
        "def read(rec):\n    return None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "throwaway_cfg", "source": "x",
        "file": "nerfbench/configs/throwaway_cfg.json", "reduced": [],
        "why": "x"})
    bench["workloads"].append({
        "name": "throwaway_cell", "config": "throwaway_cfg",
        "traffic": "throwaway_mix", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("throwaway_cell")
    bench["per_layer"].append({
        "name": "throwaway_metric", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "x",
        "moves": "train_rays_per_s", "workloads": ["throwaway_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", dst)
    spec = run.load_spec("throwaway_cell", tmp_path / "BENCHMARK.json")
    assert spec["traffic"]["num_rays"] == 4096
    assert spec["config"]["num_levels"] == 16
    assert [m["name"] for m in spec["per_layer"]] == ["throwaway_metric"]
    assert {m["name"] for m in spec["end_to_end"]} == {
        "train_rays_per_s", "setup_s"}
    assert run.metric_reader("throwaway_metric")(None) is None
    after = {p.relative_to(dst): p.read_bytes() for p in dst.rglob("*")
             if p.is_file() and p.relative_to(dst) in before}
    assert after == before
