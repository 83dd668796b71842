"""Traffic kind `nerf_train`: NeRF training from a drawn network, one
`Trainer.train_one_batch` call a step on batches of `NeRFDataset.get_batch`
over the views in the dataset's seeded shuffle, the occupancy refresh on
the program's schedule. Closed loop.

The start decides the work: how far the march runs a step follows the
density the network learns, and so the occupancy grid's pruning. Where the
mix names a `start_seed`, the network, the dataset's shuffle and pixel
draws and the trainer's own draws all come from it, so that every run does
the same work whatever --seed; otherwise they come from --seed.

Set-up builds the trainer, loads the harness's weights into it, loads the
cached scene, marks the untrained cells (as `Trainer.train` does) and runs
the first `check_steps` steps through the window's own call and feed,
keeping what the reference needs. The same trainer then runs the window.
After the window the program is freed and the reference follows those
steps (reference/ngp_blender.py).
"""

import gc
import importlib
import json
import math
import statistics
import sys
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from .. import compare, counts, harness
from ..probe import Spans, patched, spanned
from ..reference import common as ref_common
from ..reference import ngp_blender as ref
from ..scenes.lego_class import write_blender_scene

CHIPS = (1,)

# the band of occupancy cells in which the reference takes the program's
# bits: twice occupancy_gap's limit (8e-7) of the grid's largest density,
# so that no sound program's rounding flips a bit outside it
BAND_REL = 1.6e-6

MODULES = ("train.trainer", "models.renderer", "models.occupancy",
           "ops.hashgrid", "data.provider", "models.nerf")


def program():
    return {m.split(".")[-1]: importlib.import_module("laenerf_tpu_torch." + m)
            for m in MODULES}


def ref_config(cfg):
    return dict(cfg, table_rows=ref_common.grid_spec(cfg).table_rows)


def scene_dir(cfg, device):
    key = harness.input_key("lego_class_blender", cfg["n_views"],
                            cfg["image_hw"], cfg["camera_angle_x"],
                            cfg["camera_radius"])
    return harness.cached("scene", key, lambda p: write_blender_scene(
        str(p), cfg["n_views"], cfg["image_hw"], cfg["image_hw"],
        cfg["camera_angle_x"], cfg["camera_radius"], device=device))


def draw_leaves(c, seed, device):
    """The start: the hash table U(-1e-4, 1e-4) and the MLPs' weights
    U(-1/sqrt(in), 1/sqrt(in)), drawn on the device from the seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, C = c["num_levels"], c["level_dim"]
    leaves = {"encoder": harness.uniform((c["table_rows"], C), -1e-4, 1e-4,
                                         g, device)}
    sigma = harness.draw_mlp([L * C, c["hidden_dim"], 1 + c["geo_feat_dim"]],
                             g, device)
    color = harness.draw_mlp([c["sh_degree"] ** 2 + c["geo_feat_dim"],
                              c["hidden_dim_color"], c["hidden_dim_color"],
                              3], g, device)
    for i, w in enumerate(sigma):
        leaves[f"sigma_net.layers.{i}.weight"] = w
    for i, w in enumerate(color):
        leaves[f"color_net.layers.{i}.weight"] = w
    return leaves


class Run:
    """One cell run: set-up, the checked steps, the window, the trace."""

    def __init__(self, cfg, traffic, seed, device, spans=None):
        P = program()
        self.P = P
        self.c = ref_config(cfg)
        self.traffic = traffic
        self.device = torch.device(device)
        self.spans = spans or Spans()
        seed = traffic.get("start_seed", seed)
        c = self.c
        model_cfg = P["nerf"].NeRFConfig(
            bound=c["bound"], num_layers=2, hidden_dim=c["hidden_dim"],
            geo_feat_dim=c["geo_feat_dim"], num_layers_color=3,
            hidden_dim_color=c["hidden_dim_color"], sh_degree=c["sh_degree"],
            num_levels=c["num_levels"], level_dim=c["level_dim"],
            base_resolution=c["base_resolution"],
            log2_hashmap_size=c["log2_hashmap_size"])
        render_cfg = P["renderer"].RenderConfig(
            bound=c["bound"], cascades=c["cascades"],
            grid_size=c["grid_size"], dt_gamma=c["dt_gamma"],
            max_steps=c["max_steps"], min_near=c["min_near"],
            density_scale=c["density_scale"],
            density_thresh=c["density_thresh"], t_thresh=c["t_thresh"],
            march_iters=c["march_iters"], m_cap_per_ray=c["m_cap_per_ray"])
        self.scene = scene_dir(c, self.device)
        self.tr = P["trainer"].Trainer(
            model_cfg, render_cfg, device=self.device, lr=c["lr"],
            iters=c["iters"], ema_decay=c["ema_decay"],
            update_interval=c["update_interval"], seed=seed)
        self.leaves = draw_leaves(c, seed, self.device)
        harness.load_leaves(self.tr.net, self.leaves)
        harness.load_leaves(self.tr.ema_net, self.leaves)
        self.leaves = {k: v.cpu() for k, v in self.leaves.items()}
        self.ds = P["provider"].NeRFDataset(
            str(self.scene), "train", scale=c["scale"],
            num_rays=traffic["num_rays"], seed=seed % 2 ** 32)
        self.tr.mark_untrained(self.ds)
        self.batches = self._feed()

    def _feed(self):
        while True:
            for i in self.ds.epoch_indices():
                yield self.ds.get_batch(int(i))

    def step(self):
        with self.spans.span("batch"):
            b = next(self.batches)
        with self.spans.span("step"):
            aux = self.tr.train_one_batch(b, has_alpha=True)
        return b, aux

    def window_step(self):
        self.step()
        return self.traffic["num_rays"]

    # -- the checked steps ---------------------------------------------

    def checked_steps(self):
        """Run the first check_steps steps, keeping the program's draws,
        the bits it marched with, its losses, its first gradient (from
        Adam's first moment), its first refresh and its parameters after
        the last of them."""
        P, tr = self.P, self.tr
        rec = {"noises": [], "occupancy": [], "bg": [], "jitter": []}

        def obs_march(real):
            def f(*a, **k):
                rec["occupancy"].append(a[2].clone())
                rec["noises"].append(a[5].clone())
                return real(*a, **k)
            return f

        def obs_render(real):
            def f(*a, **k):
                rec["bg"].append(k["bg_color"].clone())
                return real(*a, **k)
            return f

        def obs_jitter(real):
            def f(*a, **k):
                out = real(*a, **k)
                rec["jitter"].append(out.clone())
                return out
            return f

        prog = {"losses": []}
        steps = []
        with patched(P["renderer"], "march_rays_train", obs_march), \
                patched(P["trainer"], "render_rays_train", obs_render), \
                patched(P["occupancy"], "_draw_jitter", obs_jitter):
            for k in range(self.traffic["check_steps"]):
                b, aux = self.step()
                steps.append(b)
                prog["losses"].append(aux["loss"])
                if k == 0:
                    prog["grad1"] = harness.first_gradient(tr.optimizer,
                                                           tr.net, 0.9)
                    prog["grid"] = tr.occ_state.density_grid[0].to(
                        "cpu", copy=True)
        prog["losses"] = [float(v) for v in prog["losses"]]
        prog["params"] = {n: p.detach().to("cpu", copy=True)
                          for n, p in tr.net.named_parameters()}
        prog["ema"] = {n: p.detach().to("cpu", copy=True)
                       for n, p in tr.ema_net.named_parameters()}
        self.prog = prog
        self.rec = {k: [t.cpu() for t in v] for k, v in rec.items()}
        self.steps = [{"index": int(b["index"]),
                       "inds": np.asarray(b["inds"]).copy()} for b in steps]

    # -- the trace -----------------------------------------------------

    def trace_patches(self):
        P, spans = self.P, self.spans

        def k1_meta(a, k):
            return {"rows": a[0].numel(), "C": a[1].shape[-1],
                    "table_rows": a[2], "profiled": spans.profiled}

        return [
            (P["trainer"], "occ_update", spanned(spans, "occupancy",
                                                 sync=True)),
            (P["hashgrid"], "scatter_add_rows",
             spanned(spans, "k1", fence=True, meta=k1_meta)),
            (P["renderer"], "march_rays_train", spanned(spans, "march")),
            (P["renderer"], "nerf_forward", spanned(spans, "network")),
            (P["renderer"], "composite_rays_train",
             spanned(spans, "composite")),
            (P["trainer"], "_apply_step", spanned(spans, "backward_adam")),
        ]

    def after_window_trace(self):
        """Steps until one occupancy refresh has been timed; returns the
        length of the profiled stretch."""
        while not self.spans.times.get("occupancy"):
            self.step()
        return self.traffic["profile_steps"]

    def profiled(self, n):
        for _ in range(n):
            self.step()

    def trace_inputs(self):
        """Each profiled K1 call's bytes (every row a valid sample's) and
        a step's least time over the mean samples of the traced steps."""
        meta = self.spans.meta.get("k1", [])
        c = self.c
        n_samples = [m["rows"] / (c["num_levels"] * 8) for m in meta]
        n_params = sum(v.numel() for v in self.leaves.values())
        least = counts.nerf_step(
            c, self.traffic["num_rays"], statistics.fmean(n_samples),
            c["march_iters"], n_params)[0] if n_samples else None
        return {"k1_bytes": [counts.k1_bytes(m["rows"], m["C"],
                                             m["table_rows"])
                             for m in meta if m["profiled"]],
                "step_least_s": least}

    # -- the reference -------------------------------------------------

    def free(self):
        del self.tr, self.ds, self.batches
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def reference_inputs(self):
        """The reference's own reading of the scene files: poses through
        the instant-ngp convention, intrinsics from camera_angle_x, pixels
        from the PNGs at the program's pixel draws."""
        from ..scenes.edit_plate import nerf_matrix_to_ngp

        dev, c = self.device, self.c
        with open(Path(self.scene) / "transforms_train.json") as f:
            meta = json.load(f)
        poses = torch.tensor(np.stack([
            nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32),
                               c["scale"]) for fr in meta["frames"]]),
            device=dev)
        H = W = c["image_hw"]
        fl = W / (2 * np.tan(meta["camera_angle_x"] / 2))
        intr = torch.tensor(np.array([fl, fl, W / 2, H / 2], np.float32),
                            device=dev)
        steps = []
        for k, s in enumerate(self.steps):
            fr = meta["frames"][s["index"]]
            img = np.asarray(Image.open(Path(self.scene) / (
                fr["file_path"] + ".png"))).astype(np.float32) / 255.0
            inds = torch.as_tensor(s["inds"], dtype=torch.int64, device=dev)
            pix = torch.tensor(img.reshape(-1, 4), device=dev)[inds]
            steps.append({"pose": poses[s["index"]], "intrinsics": intr,
                          "inds": inds, "pixels": pix, "W": W,
                          "bg": self.rec["bg"][k].to(dev),
                          "noises": self.rec["noises"][k].to(dev),
                          "occupancy": self.rec["occupancy"][k].to(dev)})
        refresh = {"poses": poses, "intrinsics": intr,
                   "jitter": self.rec["jitter"][0].to(dev)}
        return steps, refresh

    def reference(self, precision="bf16", fault=None):
        steps, refresh = self.reference_inputs()
        leaves = {k: v.to(self.device) for k, v in self.leaves.items()}
        out = ref.train(leaves, steps, refresh, self.c, precision, fault,
                        BAND_REL)
        return out, leaves

    def readings(self, prog, out, leaves):
        r = compare.train_readings(prog, out, leaves)
        r["occupancy_gap"] = occupancy_gap(prog["grid"], self.rec["occupancy"],
                                           out)
        return r

    def program_readings(self):
        try:
            out, leaves = self.reference()
        except (RuntimeError, IndexError, ValueError) as e:
            return {n: math.inf for n in NUMBERS}, repr(e)
        self.band_cells = out["band_cells"]
        print(f"nerfbench: {self.band_cells} of {out['grid'].numel()} "
              f"occupancy cells lie within a rounding of the threshold; "
              f"the reference marches there with the program's bits",
              file=sys.stderr)
        return self.readings(self.prog, out, leaves), None


NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "change_gap",
           "occupancy_gap")


def occupancy_gap(grid, bits_marched, out):
    """The first refresh checked on its own: the largest gap of the
    program's density grid from the reference's, over the largest
    reference density, or the largest share, over the checked steps, of
    the cells outside the reference's band where the bits the program
    marched with differ from the reference's, whichever is larger."""
    gr = out["grid"]
    gp = grid.to(gr.device)
    if gp.shape != gr.shape or not bits_marched:
        return math.inf
    rel = float((gp - gr).abs().max() / gr.abs().max().clamp(min=1e-30))
    bits, band = ref.occupancy_bits(gr, out["threshold"], BAND_REL)
    outside = max(int((~band).sum()), 1)
    mism = max(float((((b[0].to(gr.device) > 0) != bits) & ~band).sum())
               / outside for b in bits_marched)
    return max(rel, mism)


def control_readings(run):
    """The control (the reference in float8 in the program's place) and
    the planted faults, each against the reference."""
    out, leaves = run.reference()
    res, losses = {}, {"reference": out["losses"]}
    for name, prec, fault in (("control_fp8", "fp8", None),
                              ("half_batch", "bf16", "half_batch")):
        alt, _ = run.reference(prec, fault)
        alt_prog = {"losses": alt["losses"], "grad1": alt["grad1"],
                    "params": alt["params"], "ema": alt["ema"],
                    "grid": alt["grid"]}
        bits = (alt["grid"] > alt["threshold"])[None].to(torch.uint8)
        r = compare.train_readings(alt_prog, out, leaves)
        r["occupancy_gap"] = occupancy_gap(alt["grid"], [bits], out)
        res[name] = r
        losses[name] = alt["losses"]
    res["losses"] = losses
    return res
