"""Checkpoint save/load (counterpart of laenerf_tpu/train/checkpoints.py).

One .npz per checkpoint with flat keys, plus a .json sidecar for the
scalars. A key is the JAX package's `jax.tree_util.keystr` of the leaf's
path: `['name']` for a dict entry, `[i]` for a list or tuple item, `.name`
for an attribute (the JAX package's registered dataclasses, here any
object with a `__dict__`, such as `types.SimpleNamespace`). So a tree built
with the same nesting saves under the same names as the JAX package's, and
each package reads the other's weights. `CheckpointManager` keeps rolling
`max_keep` checkpoints and a best-by-metric one that keeps the occupancy
state.
"""

import glob
import json
import os
from types import SimpleNamespace

import numpy as np
import torch


def _leaf(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten_tree(tree, prefix: str = ""):
    """{keystr path: numpy leaf} of a tree of dicts, lists, tuples and
    attribute objects whose leaves are tensors, arrays or scalars."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}[{i}]"))
    elif isinstance(tree, SimpleNamespace):
        for k, v in vars(tree).items():
            out.update(flatten_tree(v, f"{prefix}.{k}"))
    else:
        out[prefix] = _leaf(tree)
    return out


def _unflatten_like(like, data, prefix, stale):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, data, f"{prefix}[{k!r}]", stale)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, data, f"{prefix}[{i}]", stale)
                          for i, v in enumerate(like))
    if isinstance(like, SimpleNamespace):
        return SimpleNamespace(**{
            k: _unflatten_like(v, data, f"{prefix}.{k}", stale)
            for k, v in vars(like).items()})
    if prefix not in data:
        if "opt_state" in prefix:
            stale.append(prefix)
            return _leaf(like)
        raise KeyError(f"checkpoint missing {prefix}")
    return data[prefix]


def save_pytree(path, tree, meta=None):
    """Save a tree of arrays to an .npz (+ a sidecar .json for meta)."""
    np.savez(path, **flatten_tree(tree))
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f)


def load_pytree(path, like):
    """Load an .npz into the structure of `like`; leaves come back as numpy
    arrays. Keys under opt_state that the file lacks keep `like`'s leaves
    (an optimizer's state may change layout; the weights may not); any
    other missing key raises KeyError. Returns (tree, meta)."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    stale = []
    tree = _unflatten_like(like, data, "", stale)
    if stale:
        print(f"[ckpt] {path}: {len(stale)} opt_state leaves reinitialized "
              "(weights loaded normally)", flush=True)
    return tree, _load_meta(path)


def _load_meta(path):
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            return json.load(f)
    return {}


class CheckpointManager:
    """Rolling checkpoints under <workspace>/checkpoints."""

    def __init__(self, workspace, name="ngp", max_keep=2):
        self.dir = os.path.join(workspace, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.name = name
        self.max_keep = max_keep
        self.best_metric = None

    def _steps(self):
        return sorted(glob.glob(os.path.join(self.dir,
                                             f"{self.name}_step*.npz")))

    def save(self, step, tree, meta=None):
        path = os.path.join(self.dir, f"{self.name}_step{step:08d}.npz")
        save_pytree(path, tree, meta)
        for old in self._steps()[: -self.max_keep]:
            os.remove(old)
            if os.path.exists(old + ".json"):
                os.remove(old + ".json")
        return path

    def save_best(self, metric, tree, meta=None, higher_better=True):
        if self.best_metric is None or (
                metric > self.best_metric if higher_better
                else metric < self.best_metric):
            self.best_metric = metric
            meta = dict(meta or {}, best_metric=metric)
            save_pytree(os.path.join(self.dir, f"{self.name}_best.npz"), tree,
                        meta)
            return True
        return False

    def latest(self):
        ckpts = self._steps()
        return ckpts[-1] if ckpts else None

    def best(self):
        p = os.path.join(self.dir, f"{self.name}_best.npz")
        return p if os.path.exists(p) else None

    def resolve(self, mode="latest"):
        """scratch / latest / best / <path> -> path or None."""
        if mode == "scratch":
            return None
        if mode == "latest":
            return self.latest() or self.best()
        if mode == "best":
            return self.best() or self.latest()
        return mode if os.path.exists(mode) else None
