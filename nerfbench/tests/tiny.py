"""Cells cut to a size the CPU runs in seconds, for the tests: the same
drivers, references and limits, a 4-level 2^12-row grid, a 16^3
occupancy grid, 64 march events, 24x24 or 32x32 images of 4 views."""

from nerfbench import harness, run

TINY_GRID = {"num_levels": 4, "log2_hashmap_size": 12}


def spec(workload):
    s = run.load_spec(workload)
    s["config"].update(TINY_GRID)
    if s["traffic"]["kind"] == "nerf_train":
        s["config"].update(grid_size=16, max_steps=64, march_iters=64,
                           n_views=4, image_hw=24)
        s["traffic"].update(num_rays=128, profile_steps=1)
    else:
        s["config"].update(n_views=4, image_hw=32)
        s["traffic"].update(chunk_steps=5)
    return s


def use_cache(monkeypatch, path):
    monkeypatch.setattr(harness, "CACHE", path)
