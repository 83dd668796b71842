"""The port's style mode against the benchmark's plain reference
(nerfbench/reference/laenerf_style.py), on the CPU at a small size: a
4-level 2^12-row grid, 32x32 views, crop_size 32, seeded random weights
and VGG-19 filters (vgg_init's seeded draw, handed to both). The
reference writes out the stack, the Grams, the antialiased resize and the
crop terms itself and imports nothing of the port.

Tolerances (bounds on the error), each with its reason:
  * VGG features and the Gram term: 1e-5 of the largest |reference| (one
    F.conv2d and one float32 product each side; the ImageNet constants
    and the normalisation round alike, the sums run in the same order).
  * the resize: 1e-6 of the largest |reference| (the reference applies
    the triangle filter as two float32 products with weights made in
    float64, PyTorch sums the same taps in another order).
  * the depth-guided TV and the depth discontinuity: 1e-6 relative (the
    same float32 terms summed in another order).
  * a whole style step, two steps from the same start: the losses at
    1e-5 relative, the first step's gradient by leaf at 1e-3 of the
    leaf's largest |reference| (the MLPs and the table rows round to
    bfloat16 at the same points on both sides, so an operand that lands
    on the other side of a rounding boundary moves a gradient entry by
    one bfloat16 step of its input, ~4e-3 relative, rarely; the encoder's
    rows are summed in float64 by the reference).
  * the parameters' change over the two steps by leaf, at 1e-3 of the
    leaf's largest |reference| change or twice what the rounding control
    shows, whichever is larger. Adam (eps 1e-8) divides each gradient
    entry by its own size, so an entry near zero that moves by one
    bfloat16 step moves its change by a share of lr that is large
    against the leaf's largest change. The control is the reference
    with its colour targets (the MSE's and the smooth transition's)
    moved one float32 ulp up and down: the two sides take the same inputs
    and part only by float32 roundings downstream of the networks (the
    resize's sums, for one), which move the cotangents by about as much.
    The control moves the encoder's change by 1.8e-3 of its largest, so
    the fixed 1e-3 sits below the reference's own rounding there. (A
    move of x_term is no control: the finest grid level scales its last
    bit by ~2^11, and both sides take the same x_term.)
  * a stack in bfloat16 (operands and outputs rounded, products summed in
    float32) departs from the float32 reference's Gram term by more than
    the cell's `gram_gap` limit (nerfbench/limits/laenerf_style.json), so
    that limit catches a VGG run below its stated precision.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from laenerf_tpu_torch.editing import style as tstyle
from laenerf_tpu_torch.editing import style_trainer as st
from laenerf_tpu_torch.editing import vgg as tvgg
from laenerf_tpu_torch.editing.laenerf import (LAENeRFConfig, LAENeRFLosses,
                                               laenerf_init)
from laenerf_tpu_torch.utils.images import resize_bilinear
from nerfbench.reference import common as ref_common
from nerfbench.reference import laenerf_style as ref
from nerfbench.scenes.wave_style import wave_image

ROOT = Path(__file__).resolve().parents[1]
LAYERS = (10, 12, 14)
LAYOUT = [64, 64, "M", 128, 128, "M", 256, 256, 256]
SIZE = 32
HW, N_PAD, CROP = 32, 1024, (24, 28)
LCFG = LAENeRFConfig(num_levels=4, log2_hashmap_size=12,
                     num_palette_bases=8)
WEIGHTS = st.StyleLossWeights(
    weight_loss_non_uniform=1e-7, offset_loss=5e-5, palette_loss_valid=1.0,
    smooth_trans_weight=1e-3, style_weight=130.0, tv_weight=1e-4,
    tv_depth_guide=True, depth_disc_weight=5e-4, warmup_iterations=0)


@pytest.fixture(scope="module")
def sn():
    """A StyleNetwork at SIZE on a SIZE x SIZE wave image (its crop is the
    whole image), with vgg_init's seeded random filters."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*random filters")
        return tstyle.StyleNetwork(wave_image(SIZE), style_layers=LAYERS,
                                   size=SIZE, seed=3, device="cpu")


def _filters(sn):
    return {i: sn.params[i] for i in range(max(LAYERS) + 1)
            if sn.params[i] is not None}


def _style(sn):
    return {"filters": _filters(sn),
            "crop": torch.as_tensor(wave_image(SIZE)), "layers": LAYERS,
            "size": SIZE}


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_vgg_features_match(sn):
    img = torch.rand((3, SIZE, SIZE),
                     generator=torch.Generator().manual_seed(1))
    got = tvgg.vgg_features(sn.params, sn.kinds,
                            tvgg.normalize_imagenet(img)[None], LAYERS)
    want = ref.features(_filters(sn), LAYOUT, img, LAYERS)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= 1e-5


def test_gram_term_matches(sn):
    img = torch.rand((3, SIZE, SIZE),
                     generator=torch.Generator().manual_seed(2))
    targets = ref.grams(ref.features(_filters(sn), LAYOUT,
                                     torch.as_tensor(wave_image(SIZE)),
                                     LAYERS))
    for t, r in zip(sn.targets, targets):
        assert _rel(t, r) <= 1e-5
    got = sn.gram_loss(img, sn.targets)
    want = ref.gram_term(ref.grams(ref.features(_filters(sn), LAYOUT, img,
                                                LAYERS)), targets)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("hw", [(24, 28), (45, 70)])  # grows, shrinks
def test_resize_matches(hw):
    img = torch.rand((3,) + hw, generator=torch.Generator().manual_seed(3))
    got = resize_bilinear(img, (SIZE, SIZE))
    want = ref.resize(img, SIZE)
    assert _rel(got, want) <= 1e-6


def _maps(seed, h=20, w=22):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((3, h, w), generator=g),
            torch.rand((h, w - 1), generator=g) * 0.3,
            torch.rand((h - 1, w), generator=g) * 0.3,
            torch.rand((h, w), generator=g))


@pytest.mark.parametrize("term", ["tv_depth_guided", "depth_discontinuity"])
def test_crop_terms_match(term):
    img, tv_v, tv_h, smooth = _maps(4)
    if term == "tv_depth_guided":
        got = LAENeRFLosses.tv_depth_weighted(img, tv_v, tv_h, smooth)
        want = ref.tv_depth_guided(img, tv_v, tv_h, smooth)
    else:
        got = LAENeRFLosses.depth_discontinuity(img, tv_v, tv_h)
        want = ref.depth_discontinuity(img, tv_v, tv_h)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def _view(seed):
    """One padded view: 400 region rays in a box inside a 24 x 28 crop
    window of the 32 x 32 image, with its crop maps."""
    rng = np.random.RandomState(seed)
    ch, cw = CROP
    origin = (4, 2)
    box = np.array([(origin[0] + r) * HW + origin[1] + c
                    for r in range(2, ch - 2) for c in range(2, cw - 2)])
    inds = np.sort(rng.choice(box, 400, replace=False))
    n = inds.size
    pad = np.full(N_PAD, HW * HW, np.int64)
    pad[:n] = inds
    valid = np.arange(N_PAD) < n
    d = rng.randn(N_PAD, 3)
    tv_v = rng.rand(ch, cw - 1) * (rng.rand(ch, cw - 1) < 0.2)
    tv_h = rng.rand(ch - 1, cw) * (rng.rand(ch - 1, cw) < 0.2)
    view = {
        "valid": valid, "inds": pad,
        "x_term": rng.uniform(-0.6, 0.6, (N_PAD, 3)) * valid[:, None],
        "dirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
        "targets": rng.rand(N_PAD, 3),
        "cut_gt": rng.rand(ch, cw, 3), "cut_smooth": rng.rand(ch, cw),
        "tv_v": tv_v, "tv_h": tv_h}
    batch = {k: torch.as_tensor(v if v.dtype in (np.bool_, np.int64)
                                else v.astype(np.float32))
             for k, v in view.items()}
    batch["crop_origin"] = origin
    return batch


def _config():
    c = {"bound": 1.0, "num_levels": LCFG.num_levels,
         "level_dim": LCFG.level_dim,
         "base_resolution": LCFG.base_resolution,
         "log2_hashmap_size": LCFG.log2_hashmap_size,
         "desired_resolution": 2048.0, "num_layers": LCFG.num_layers,
         "hidden_dim": LCFG.hidden_dim,
         "num_palette_bases": LCFG.num_palette_bases,
         "dir_degree": LCFG.dir_degree, "lr": 1e-3,
         "weight_loss_non_uniform": WEIGHTS.weight_loss_non_uniform,
         "offset_loss": WEIGHTS.offset_loss,
         "palette_loss_valid": WEIGHTS.palette_loss_valid,
         "smooth_trans_weight": WEIGHTS.smooth_trans_weight,
         "style_weight": WEIGHTS.style_weight,
         "tv_weight": WEIGHTS.tv_weight,
         "depth_disc_weight": WEIGHTS.depth_disc_weight,
         "vgg19_layout": LAYOUT}
    c["table_rows"] = ref_common.grid_spec(c).table_rows
    return c


def _program_steps(sn, batches, leaves):
    """The port's laenerf_train_step over the batches from `leaves`;
    returns (losses, first gradient, parameters) by leaf."""
    g = torch.Generator().manual_seed(0)
    model, active = laenerf_init(LCFG, device="cpu", generator=g)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(leaves[n])
    opt = st.make_style_optimizer(model, 1e-3)
    losses, grad1 = [], None
    for b in batches:
        aux = st.laenerf_train_step(
            model, opt, active, b, weights=WEIGHTS, H=HW, W=HW,
            crop_h=CROP[0], crop_w=CROP[1], past_warmup=True,
            crop_origin=b["crop_origin"], style_network=sn,
            gram_targets=sn.targets, crop_size=SIZE)
        losses.append(float(aux["loss"]))
        if grad1 is None:
            grad1 = {n: p.grad.clone() for n, p in model.named_parameters()}
    return losses, grad1, {n: p.detach().clone()
                           for n, p in model.named_parameters()}


def _leaves():
    """The start: the table U(-0.5, 0.5), so that colours vary across the
    crop, the MLPs U(-1/sqrt(in), 1/sqrt(in)), the palette U(0, 1)."""
    g = torch.Generator().manual_seed(5)
    model, _ = laenerf_init(LCFG, device="cpu", generator=g)
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    out["encoder"] = torch.rand(out["encoder"].shape, generator=g) - 0.5
    return out


def _moved(batches, key, toward):
    """The batches with `key` moved one float32 ulp toward +-inf."""
    return [dict(b, **{key: torch.nextafter(
        b[key], torch.full_like(b[key], toward))}) for b in batches]


def test_style_step_matches(sn):
    batches = [_view(6), _view(7)]
    leaves = _leaves()
    losses, grad1, params = _program_steps(sn, batches, leaves)
    out = ref.train(leaves, batches, _config(), HW, HW, CROP[0], CROP[1],
                    _style(sn))
    # the rounding control: the reference with its colour targets moved
    # one ulp
    controls = [ref.train(leaves, _moved(batches, key, toward), _config(),
                          HW, HW, CROP[0], CROP[1], _style(sn))
                for key in ("targets", "cut_gt")
                for toward in (float("inf"), float("-inf"))]
    for got, want in zip(losses, out["losses"]):
        assert abs(got - want) <= 1e-5 * abs(want)
    for n in ref.LEAVES:
        assert _rel(grad1[n], out["grad1"][n]) <= 1e-3, n
        want = out["params"][n] - leaves[n]
        bound = max(1e-3, 2 * max(_rel(c["params"][n] - leaves[n], want)
                                  for c in controls))
        err = _rel(params[n] - leaves[n], want)
        print(f"{n}: change error {err:.3e}, bound {bound:.3e}")
        assert err <= bound, f"{n}: {err:.3e} > {bound:.3e}"
    # the Gram term is a share of the loss that the comparison can see
    assert out["grams"][0] * WEIGHTS.style_weight > 0.01 * out["losses"][0]


def test_bf16_stack_fails_the_gram_limit(sn):
    with open(ROOT / "nerfbench" / "limits" / "laenerf_style.json") as f:
        limit = json.load(f)["limits"]["gram_gap"]
    batches = [_view(8)]
    leaves = _leaves()
    f32 = ref.train(leaves, batches, _config(), HW, HW, CROP[0], CROP[1],
                    _style(sn))
    bf16 = ref.train(leaves, batches, _config(), HW, HW, CROP[0], CROP[1],
                     _style(sn), vgg="bf16")
    gap = abs(bf16["grams"][0] - f32["grams"][0]) / abs(f32["grams"][0])
    assert gap > limit, (gap, limit)
