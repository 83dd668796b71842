"""Traffic kind `laenerf_train`: LAENeRF recolor training through
`LAENeRFTrainer.train_steps` in the pipeline's chunks, every step past
warm-up (so the crop losses run), on an edit dataset built from the
scene's exact geometry and loaded with `EditDataset.load`. Closed loop.

Set-up builds the trainer on the loaded dataset, loads the harness's
weights, sets the step counter past warm-up, runs the first `check_steps`
steps through `train_steps` (keeping each step's view, the program's
uniform draw for its re-jitter along the ray and Adam's first moment after
the first step), then one epoch so that every view is on the device. The
same trainer runs the window. After the window the program is freed and
the reference follows the checked steps (reference/laenerf_palette8.py)
on batches it reads from the dataset file itself, re-jittered from those
draws.
"""

import gc
import importlib
import math
import statistics

import numpy as np
import torch

from .. import compare, counts, harness
from ..probe import Spans, patched, spanned
from ..reference import common as ref_common
from ..reference import laenerf_palette8 as ref
from ..scenes.edit_plate import write_edit_dataset

CHIPS = (1,)

NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "change_gap")


def program():
    return {m.split(".")[-1]: importlib.import_module("laenerf_tpu_torch." + m)
            for m in ("editing.style_trainer", "editing.laenerf",
                      "editing.edit_dataset", "ops.hashgrid")}


def ref_config(cfg):
    return dict(cfg, table_rows=ref_common.grid_spec(cfg).table_rows)


def dataset_path(c, device):
    key = harness.input_key("lego_class_plate_edit", c["n_views"],
                            c["image_hw"], c["camera_angle_x"],
                            c["camera_radius"], c["scale"])
    return harness.cached("edit.npz", key, lambda p: write_edit_dataset(
        p, c["n_views"], c["image_hw"], c["image_hw"],
        c["scale"], c["camera_angle_x"], c["camera_radius"], device=device))


def draw_leaves(c, seed, device):
    """The start: the hash table U(-1e-4, 1e-4), the MLPs' weights
    U(-1/sqrt(in), 1/sqrt(in)) and the palette U(0, 1), drawn on the
    device from the seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, C, K = c["num_levels"], c["level_dim"], c["num_palette_bases"]
    hidden = [c["hidden_dim"]] * (c["num_layers"] - 1)
    leaves = {"encoder": harness.uniform((c["table_rows"], C), -1e-4, 1e-4,
                                         g, device)}
    for i, w in enumerate(harness.draw_mlp([L * C] + hidden + [K], g,
                                           device)):
        leaves[f"weight_net.layers.{i}.weight"] = w
    for i, w in enumerate(harness.draw_mlp(
            [L * C + c["dir_degree"] ** 2] + hidden + [3], g, device)):
        leaves[f"offset_net.layers.{i}.weight"] = w
    leaves["palette"] = harness.uniform((K, 3), 0.0, 1.0, g, device)
    return leaves


class Run:
    def __init__(self, cfg, traffic, seed, device, spans=None):
        P = program()
        self.P = P
        self.c = c = ref_config(cfg)
        # the pipeline's NeRF Trainer sets the matmul precision for the
        # process before its LAENeRF phase; this cell builds no Trainer
        importlib.import_module(
            "laenerf_tpu_torch.train.trainer").configure_matmul_precision()
        self.traffic = traffic
        self.device = torch.device(device)
        self.spans = spans or Spans()
        self.path = path = dataset_path(c, self.device)
        self.ds = P["edit_dataset"].EditDataset.load(str(path))
        self.ds.rng = np.random.RandomState(seed % 2 ** 32)
        lcfg = P["laenerf"].LAENeRFConfig(
            bound=c["bound"], num_layers=c["num_layers"],
            hidden_dim=c["hidden_dim"],
            num_palette_bases=c["num_palette_bases"],
            dir_degree=c["dir_degree"], num_levels=c["num_levels"],
            level_dim=c["level_dim"], base_resolution=c["base_resolution"],
            log2_hashmap_size=c["log2_hashmap_size"])
        weights = P["style_trainer"].StyleLossWeights(
            weight_loss_non_uniform=c["weight_loss_non_uniform"],
            offset_loss=c["offset_loss"],
            palette_loss_valid=c["palette_loss_valid"],
            smooth_trans_weight=c["smooth_trans_weight"],
            warmup_iterations=c["warmup_iterations"])
        self.tr = P["style_trainer"].LAENeRFTrainer(
            lcfg, weights, self.ds, device=self.device, lr=c["lr"],
            seed=seed)
        self.leaves = draw_leaves(c, seed, self.device)
        harness.load_leaves(self.tr.model, self.leaves)
        self.leaves = {k: v.cpu() for k, v in self.leaves.items()}
        # the window starts past warm-up
        self.tr.step = c["warmup_iterations"] + 1
        self.n_valid = [int(v["n_valid"]) for v in self.ds.views]
        self.orders = []
        real = self.ds.epoch_indices

        def epoch_indices(*a, **k):
            order = real(*a, **k)
            self.orders.append(order)
            return order

        self.ds.epoch_indices = epoch_indices

    def run_steps(self, n):
        """train_steps(n); returns the valid rays of the n steps (the views
        are the first n of the shuffles the call drew)."""
        self.orders.clear()
        with self.spans.span("steps"):
            self.tr.train_steps(n)
        views = np.concatenate(self.orders)[:n]
        return sum(self.n_valid[int(i)] for i in views)

    def window_step(self):
        return self.run_steps(self.traffic["chunk_steps"])

    def checked_steps(self):
        P, tr = self.P, self.tr
        draws, steps, prog = [], [], {}

        def obs(real):
            def f(model, optimizer, active, batch, **kw):
                if len(steps) == 1:
                    prog["grad1"] = harness.first_gradient(optimizer, model,
                                                           0.9)
                steps.append(draws.pop().cpu() if draws else None)
                aux = real(model, optimizer, active, batch, **kw)
                prog.setdefault("losses", []).append(aux["loss"])
                return aux
            return f

        n = self.traffic["check_steps"]
        with patched(P["style_trainer"], "laenerf_train_step", obs), \
                patched(P["style_trainer"], "torch",
                        lambda real: _RandRecorder(real, draws)):
            self.run_steps(n)
        views = [int(i) for i in np.concatenate(self.orders)[:n]]
        if "grad1" not in prog:  # a single checked step
            prog["grad1"] = harness.first_gradient(tr.optimizer, tr.model,
                                                   0.9)
        prog["losses"] = [float(v) for v in prog.get("losses", [])]
        prog["params"] = {k: p.detach().to("cpu", copy=True)
                          for k, p in tr.model.named_parameters()}
        self.prog = prog
        self.steps = list(zip(views, steps))
        # one epoch, so that every view is on the device before the window
        self.run_steps(len(self.ds))

    def trace_patches(self):
        P, spans = self.P, self.spans

        def k1_meta(a, k):
            return {"rows": a[0].numel(), "C": a[1].shape[-1],
                    "table_rows": a[2], "profiled": spans.profiled}

        return [
            (P["hashgrid"], "scatter_add_rows",
             spanned(spans, "k1", fence=True, meta=k1_meta)),
            (P["style_trainer"], "laenerf_forward_train",
             spanned(spans, "forward")),
            (P["style_trainer"], "_crop_losses", spanned(spans, "crop")),
        ]

    def after_window_trace(self):
        return len(self.ds)

    def profiled(self, n):
        """One train_steps call of n steps: with n the number of views,
        each view once. Returns their valid rays."""
        return self.run_steps(n)

    def trace_inputs(self):
        """The profiled K1 calls' bytes, counting the valid (region) rows
        of each view once (the profiled stretch runs each view once), and
        a step's least time over the views' mean valid rows."""
        c = self.c
        n_params = sum(v.numel() for v in self.leaves.values())
        meta = [m for m in self.spans.meta.get("k1", []) if m["profiled"]]
        per_row = c["num_levels"] * 8
        k1 = ([counts.k1_bytes(n * per_row, m["C"], m["table_rows"])
               for n, m in zip(self.n_valid, meta)]
              if len(meta) == len(self.n_valid) else [])
        least = counts.laenerf_step(c, statistics.fmean(self.n_valid),
                                    n_params,
                                    self.ds.crop_h * self.ds.crop_w)[0]
        return {"k1_bytes": k1, "step_least_s": least}

    def free(self):
        del self.tr, self.ds
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def reference_batches(self):
        """The checked steps' batches from the dataset file: each step's
        view, its termination points moved along the ray by the program's
        uniform draw u as (u - 0.5) * the view's depth_factor."""
        dev = self.device
        keys = ("inds", "valid", "dirs", "targets", "x_term", "cut_gt",
                "cut_smooth")
        with np.load(self.path) as data:
            arrays = {k: data[k] for k in keys + ("crop_origin",
                                                  "depth_factor")}
        batches = []
        for i, u in self.steps:
            b = {k: torch.as_tensor(arrays[k][i], device=dev) for k in keys}
            if u is not None:
                d = (u.to(dev) - 0.5) * float(arrays["depth_factor"][i])
                b["x_term"] = b["x_term"] + d[:, None] * b["dirs"]
            b["crop_origin"] = tuple(int(v) for v in arrays["crop_origin"][i])
            batches.append(b)
        return batches

    def reference(self, precision="bf16", fault=None):
        dev = self.device
        leaves = {k: v.to(dev) for k, v in self.leaves.items()}
        batches = self.reference_batches()
        c = self.c
        crop_h, crop_w = batches[0]["cut_gt"].shape[:2]
        out = ref.train(leaves, batches, c, c["image_hw"], c["image_hw"],
                        crop_h, crop_w, precision, fault)
        return out, leaves

    def program_readings(self):
        try:
            out, leaves = self.reference()
        except (RuntimeError, IndexError, ValueError, KeyError) as e:
            return {n: math.inf for n in NUMBERS}, repr(e)
        return compare.train_readings(self.prog, out, leaves), None


class _RandRecorder:
    """The torch module as the program's trainer sees it, with each
    torch.rand draw kept (the re-jitter's uniform draw)."""

    def __init__(self, real, out):
        self._real, self._out = real, out

    def __getattr__(self, name):
        return getattr(self._real, name)

    def rand(self, *a, **k):
        t = self._real.rand(*a, **k)
        self._out.append(t.clone())
        return t


def control_readings(run):
    out, leaves = run.reference()
    res, losses = {}, {"reference": out["losses"]}
    for name, prec, fault in (("control_fp8", "fp8", None),
                              ("half_batch", "bf16", "half_batch")):
        alt, _ = run.reference(prec, fault)
        res[name] = compare.train_readings(alt, out, leaves)
        losses[name] = alt["losses"]
    res["losses"] = losses
    return res
