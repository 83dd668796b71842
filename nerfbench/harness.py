"""What every traffic driver shares: the process's age, the input cache,
seeded weights drawn on the device, the measured window and the record a
driver hands back."""

import dataclasses
import hashlib
import json
import math
import os
import shutil
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "_cache"


def process_age_s():
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def input_key(*parts):
    """Cache key of derived inputs: the generator sources and the
    parameters they ran with."""
    h = hashlib.sha256()
    for src in sorted((ROOT / "scenes").glob("*.py")):
        h.update(src.read_bytes())
    h.update(json.dumps(parts, sort_keys=True).encode())
    return h.hexdigest()[:16]


def cached(name, key, build):
    """Path of the cached input `name` under _cache/<key>/, built by
    build(path) the first time. A build writes a fixed temporary name and
    renames it, so a cut-off build leaves no entry."""
    d = CACHE / key
    path = d / name
    if not path.exists():
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / (name + ".partial")
        if tmp.is_dir():
            shutil.rmtree(tmp)
        elif tmp.exists():
            tmp.unlink()
        build(tmp)
        os.replace(tmp, path)
    return path


def uniform(shape, lo, hi, generator, device):
    return torch.empty(shape, device=device).uniform_(lo, hi,
                                                      generator=generator)


def draw_mlp(layer_dims, generator, device):
    """Bias-free layers' weights [out, in], U(-1/sqrt(in), 1/sqrt(in))."""
    return [uniform((o, i), -1 / math.sqrt(i), 1 / math.sqrt(i), generator,
                    device) for i, o in zip(layer_dims[:-1], layer_dims[1:])]


@torch.no_grad()
def load_leaves(module, leaves):
    for name, p in module.named_parameters():
        p.copy_(leaves[name])


def first_gradient(optimizer, module, beta1):
    """The gradient Adam took at its first step, by leaf: its first moment
    over (1 - beta1); zeros for a leaf Adam holds no state for."""
    out = {}
    for name, p in module.named_parameters():
        st = optimizer.state.get(p, {})
        m = st.get("exp_avg")
        out[name] = (m / (1.0 - beta1) if m is not None
                     else torch.zeros_like(p)).detach().to("cpu", copy=True)
    return out


def sync():
    """Wait for the card, where this process has used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def window(step, seconds):
    """Call step() until `seconds` have passed, closed loop, and wait for
    the device. Returns (calls, elapsed seconds, summed step results, the
    host seconds between successive calls' returns)."""
    sync()
    t0 = last = time.perf_counter()
    calls = work = 0
    gaps = []
    while True:
        work += step()
        calls += 1
        now = time.perf_counter()
        gaps.append(now - last)
        last = now
        if now - t0 >= seconds:
            break
    sync()
    return calls, time.perf_counter() - t0, work, gaps


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to run.py."""

    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value
    readings: dict  # number compared -> value
    memory_peak_bytes: int
    trace: dict = None  # per-layer inputs for the metric readers
    error: str = None  # why the comparison could not be made
