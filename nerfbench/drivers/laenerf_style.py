"""Traffic kind `laenerf_style`: LAENeRF style training through
`LAENeRFTrainer.train_steps` in the pipeline's chunks, every step past
warm-up, so that each step adds VGG-19's Gram loss on the crop resized to
`crop_size`, the depth-guided TV, the smooth transition and the depth
discontinuity. The trainer holds a `StyleNetwork` on the wave style image,
as `EditPipeline(mode="style")` builds it. Closed loop.

The recolor kind's driver (`laenerf_train.py`) does the rest: the same
edit dataset (one cache entry for both kinds), the same seeded start, the
checked steps and their re-jitter draws, the profiled epoch. Beyond it,
set-up draws VGG-19's filters from the seed (vgg_init's He recipe) and
hands them to the StyleNetwork as it is built, and keeps the style crop
the network took; the checked steps also keep the program's Gram term.
With --trace 1 the stack's forward and its input gradient are each a
fenced span (`vgg`, `vgg_backward`), the second opened and closed by two
identity autograd nodes around the stack. After the window the reference
(reference/laenerf_style.py) follows the checked steps and computes a
fourth number, `gram_gap`.
"""

import importlib
import math
import statistics
import warnings

import numpy as np
import torch

from .. import compare, counts_vgg, harness
from ..probe import Spans, patched
from ..reference import laenerf_style as ref
from ..scenes.wave_style import wave_image
from . import laenerf_train as recolor

CHIPS = (1,)

NUMBERS = recolor.NUMBERS + ("gram_gap",)

# the filters' generator stream, apart from the LAENeRF weights' (the seed)
VGG_STREAM = 1 << 62


def program():
    P = recolor.program()
    for m in ("editing.style", "editing.vgg"):
        P[m.split(".")[-1]] = importlib.import_module("laenerf_tpu_torch." + m)
    return P


def draw_vgg(c, seed, device):
    """VGG-19's filters to the deepest style layer by feature index, (w
    [cout, cin, 3, 3] N(0, 2 / (9 cin)), b zeros): vgg_init's recipe,
    drawn on the device from the seed."""
    g = torch.Generator(device=device).manual_seed(seed ^ VGG_STREAM)
    out, cin = {}, 3
    for i, kind, cout in counts_vgg.layers(c["vgg19_layout"],
                                           max(c["style_layers"])):
        if kind == "conv":
            std = math.sqrt(2.0 / (9 * cin))
            w = torch.empty((cout, cin, 3, 3), device=device).normal_(
                0.0, std, generator=g)
            out[i] = (w, torch.zeros((cout,), device=device))
            cin = cout
    return out


class _OpenSpan(torch.autograd.Function):
    """Identity on the stack's outputs; on the way back, once every output's
    gradient has arrived, enters the span `back`."""

    @staticmethod
    def forward(ctx, back, *outs):
        ctx.back = back
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.back.__enter__()
        return (None,) + grads


class _CloseSpan(torch.autograd.Function):
    """Identity on the stack's input; on the way back, once the input
    gradient is formed, leaves the span `back`."""

    @staticmethod
    def forward(ctx, back, x):
        ctx.back = back
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.back.__exit__(None, None, None)
        return None, grad


class Run(recolor.Run):
    def __init__(self, cfg, traffic, seed, device, spans=None):
        P = program()
        self.P = P
        self.c = c = recolor.ref_config(cfg)
        importlib.import_module(
            "laenerf_tpu_torch.train.trainer").configure_matmul_precision()
        self.traffic = traffic
        self.device = torch.device(device)
        self.spans = spans or Spans()
        self.path = path = recolor.dataset_path(c, self.device)
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
            style_weight=c["style_weight"], tv_weight=c["tv_weight"],
            tv_depth_guide=c["tv_depth_guide"],
            depth_disc_weight=c["depth_disc_weight"],
            warmup_iterations=c["warmup_iterations"])
        filters = draw_vgg(c, seed, self.device)
        self.vgg = {i: (w.cpu(), b.cpu()) for i, (w, b) in filters.items()}

        def vgg_init(real):
            def f(*a, **k):
                params, kinds, _ = real(*a, **k)
                for i, wb in filters.items():
                    params[i] = wb
                return params, kinds, False
            return f

        crops = []

        def random_crop(real):
            def f(sn, img):
                crops.append(np.array(real(sn, img)))
                return crops[-1]
            return f

        style = P["style"]
        with patched(style, "vgg_init", vgg_init), \
                patched(style.StyleNetwork, "_random_crop", random_crop), \
                warnings.catch_warnings():
            # the filters are the harness's, random by design
            warnings.filterwarnings("ignore", "No pretrained vgg19")
            sn = style.StyleNetwork(
                wave_image(), style_layers=tuple(c["style_layers"]),
                size=c["crop_size"], preserve_color=c["preserve_color"],
                seed=seed % 2 ** 32, device=self.device)
        (self.style_crop,) = crops
        self.tr = P["style_trainer"].LAENeRFTrainer(
            lcfg, weights, self.ds, style_network=sn,
            crop_size=c["crop_size"], device=self.device, lr=c["lr"],
            seed=seed)
        self.leaves = recolor.draw_leaves(c, seed, self.device)
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

    def checked_steps(self):
        """The recolor driver's checked steps, keeping also each step's
        Gram term as the program computed it."""
        sn = self.tr.style_network
        real, grams = sn.gram_loss, []

        def gram_loss(x, targets):
            g = real(x, targets)
            grams.append(g.detach())
            return g

        sn.gram_loss = gram_loss
        try:
            super().checked_steps()
        finally:
            del sn.gram_loss
        self.prog["grams"] = [float(g)
                              for g in grams[:self.traffic["check_steps"]]]

    def trace_patches(self):
        return super().trace_patches() + [
            (self.P["style"], "vgg_features", self._vgg_spans)]

    def _vgg_spans(self, real):
        """The stack's forward as the fenced span `vgg` and, where the call
        will be differentiated, its input gradient as the fenced span
        `vgg_backward`; each with the convolutions' counted operations."""
        spans, c = self.spans, self.c

        def wrapper(params, kinds, x, out_layers):
            flops = counts_vgg.stack_flops(c["vgg19_layout"], x.shape[-2:],
                                           max(out_layers), x.shape[0])
            meta = {"flops": flops, "profiled": spans.profiled}
            if not (spans.on and torch.is_grad_enabled()
                    and x.requires_grad):
                with spans.span("vgg", fence=True, **meta):
                    return real(params, kinds, x, out_layers)
            back = spans.span("vgg_backward", fence=True, **meta)
            with spans.span("vgg", fence=True, **meta):
                outs = real(params, kinds, _CloseSpan.apply(back, x),
                            out_layers)
            return list(_OpenSpan.apply(back, *outs))
        return wrapper

    def trace_inputs(self):
        """The recolor driver's inputs, the counted operations of each
        profiled call of the stack (forwards, then input gradients, the
        order in which the reader adds the spans' device times), and the
        style step's least time."""
        c = self.c
        out = super().trace_inputs()
        out["vgg_flops"] = [m["flops"] for name in ("vgg", "vgg_backward")
                            for m in self.spans.meta.get(name, [])
                            if m["profiled"]]
        n_params = sum(v.numel() for v in self.leaves.values())
        out["step_least_s"] = counts_vgg.style_step(
            c, statistics.fmean(self.n_valid), n_params,
            self.ds.crop_h * self.ds.crop_w)[0]
        return out

    def reference_batches(self):
        """The recolor driver's batches with each view's two depth-edge
        maps."""
        batches = super().reference_batches()
        with np.load(self.path) as data:
            maps = {k: data[k] for k in ("tv_h", "tv_v")}
        for b, (i, _) in zip(batches, self.steps):
            for k, a in maps.items():
                b[k] = torch.as_tensor(a[i], device=self.device)
        return batches

    def reference(self, precision="bf16", fault=None, vgg="f32"):
        dev, c = self.device, self.c
        leaves = {k: v.to(dev) for k, v in self.leaves.items()}
        batches = self.reference_batches()
        crop_h, crop_w = batches[0]["cut_gt"].shape[:2]
        style = {"filters": {i: (w.to(dev), b.to(dev))
                             for i, (w, b) in self.vgg.items()},
                 "crop": torch.as_tensor(self.style_crop, device=dev),
                 "layers": tuple(c["style_layers"]),
                 "size": c["crop_size"]}
        out = ref.train(leaves, batches, c, c["image_hw"], c["image_hw"],
                        crop_h, crop_w, style, precision, fault, vgg)
        return out, leaves

    def program_readings(self):
        try:
            out, leaves = self.reference()
        except (RuntimeError, IndexError, ValueError, KeyError) as e:
            return {n: math.inf for n in NUMBERS}, repr(e)
        return readings(self.prog, out, leaves), None


def readings(prog, ref_out, start):
    """The recolor cell's numbers, and gram_gap: the largest relative gap
    of a checked step's Gram term."""
    out = compare.train_readings(prog, ref_out, start)
    out["gram_gap"] = compare.loss_gap(prog["grams"], ref_out["grams"])
    return out


CONTROLS = (("control_fp8", "fp8", None, "f32"),
            ("half_batch", "bf16", "half_batch", "f32"),
            ("vgg_tf32", "bf16", None, "tf32"),
            ("vgg_bf16", "bf16", None, "bf16"))


def control_readings(run):
    out, leaves = run.reference()
    res, losses = {}, {"reference": out["losses"]}
    for name, prec, fault, vgg in CONTROLS:
        alt, _ = run.reference(prec, fault, vgg)
        res[name] = readings(alt, out, leaves)
        losses[name] = alt["losses"]
    res["losses"] = losses
    return res
