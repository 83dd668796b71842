"""VGG-19/16 feature stacks for the Gram style loss, NPR feature matching
and LPIPS (counterpart of laenerf_tpu/editing/vgg.py).

Pretrained weights load from a local npz in torchvision's `features`
state-dict layout (`{i}.weight` [cout, cin, 3, 3], `{i}.bias`), named by
LAENERF_VGG19_NPZ / LAENERF_VGG16_NPZ or found as
~/.cache/laenerf_tpu_weights/vgg19_features.npz (vgg16_...). Without one,
He-initialised random filters are drawn from np.random.RandomState(seed)
in the JAX package's order, so both packages hold equal filters, and a
warning is emitted.

Filters are stored OIHW (F.conv2d's layout, the npz's own). The stack is
frozen: no tensor here requires a gradient, so a backward through it forms
only the input's gradient. Convolutions and products run in full f32
(vgg_init turns TF32 off).

Tracing (utils/timers.py): a call is the span `style.vgg` (attributes
`size`, the input's [h, w], and `layers`) and adds its counted operations
to `style.vgg_flops` (vgg_flops: the forward, plus as many again for the
input gradient where the call will be differentiated). The input gradient
through the stack is the span `style.vgg_backward`, opened and closed by
two identity autograd nodes at the stack's outputs and input; it runs on
autograd's thread and nests under the span that called backward. The
ImageNet constants' two uploads are host waits, `sync.vgg_normalize`.
With the tracer and the profiler off none of this runs.
"""

import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..train.trainer import configure_matmul_precision
from ..utils import timers

# torchvision `features` layer indices: out_channels, or "M" for a max-pool
VGG19_LAYOUT = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
VGG16_LAYOUT = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_WEIGHTS_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                            "laenerf_tpu_weights")


def _layer_indices(layout):
    """torchvision features indices -> (kind, out_channels): a conv at i,
    its ReLU at i + 1, a pool at its own index."""
    idx = []
    for c in layout:
        if c == "M":
            idx.append(("pool", None))
        else:
            idx.append(("conv", c))
            idx.append(("relu", None))
    return idx


def _npz_path(arch):
    """The pretrained weights' npz of arch, or None."""
    path = os.environ.get(f"LAENERF_{arch.upper()}_NPZ")
    if path is None:
        path = os.path.join(_WEIGHTS_DIR, f"{arch}_features.npz")
    return path if os.path.exists(path) else None


def vgg_init(arch: str = "vgg19", seed: int = 0, *, device="cuda"):
    """A VGG feature stack on `device`.

    Returns (params, kinds, pretrained): params aligned with torchvision's
    feature indices, (w [cout, cin, 3, 3], b [cout]) at a conv and None
    elsewhere; kinds from _layer_indices.
    """
    configure_matmul_precision()
    layout = VGG19_LAYOUT if arch == "vgg19" else VGG16_LAYOUT
    kinds = _layer_indices(layout)
    path = _npz_path(arch)
    pretrained = path is not None
    if pretrained:
        with np.load(path) as z:
            npz = {k: z[k] for k in z.files}
    if not pretrained:
        warnings.warn(
            f"No pretrained {arch} weights found; using random filters "
            f"(style/LPIPS quality degraded). See editing/vgg.py docstring.",
            stacklevel=2)
    rng = np.random.RandomState(seed)
    params = []
    cin = 3
    for i, (kind, cout) in enumerate(kinds):
        if kind != "conv":
            params.append(None)
            continue
        if pretrained:
            w, b = npz[f"{i}.weight"], npz[f"{i}.bias"]
        else:
            # the JAX package draws HWIO [3, 3, cin, cout]
            std = math.sqrt(2.0 / (cin * 9))
            w = rng.normal(0, std, (3, 3, cin, cout)).astype(np.float32)
            w = np.transpose(w, (3, 2, 0, 1))
            b = np.zeros((cout,), np.float32)
        params.append(tuple(
            torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                         device=device) for a in (w, b)))
        cin = cout
    return params, kinds, pretrained


def vgg_flops(kinds, hw, max_layer, batch=1):
    """Operations of the stack's convolutions up to feature index
    max_layer on a batch of [3, h, w] inputs: a multiply-add counts 2, a
    3x3 filter 9 taps a channel pair, a max-pool halves h and w."""
    h, w = (int(v) for v in hw)
    cin, total = 3, 0
    for kind, cout in kinds[:max_layer + 1]:
        if kind == "conv":
            total += 2 * 9 * cin * cout * h * w * batch
            cin = cout
        elif kind == "pool":
            h, w = h // 2, w // 2
    return total


class _OpenBackward(torch.autograd.Function):
    """Identity on the stack's outputs; on the way back, once every
    output's gradient has arrived, opens the backward span."""

    @staticmethod
    def forward(ctx, back, *outs):
        ctx.back = back
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.back.__enter__()
        return (None,) + grads


class _CloseBackward(torch.autograd.Function):
    """Identity on the stack's input; on the way back, after the input
    gradient is formed, closes the backward span."""

    @staticmethod
    def forward(ctx, back, x):
        ctx.back = back
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.back.__exit__(None, None, None)
        return None, grad


def vgg_features(params, kinds, x, out_layers):
    """Run the stack on x [B, 3, H, W] (ImageNet-normalised) and return the
    activations at the torchvision feature indices in out_layers, in
    index order; the stack stops after the largest."""
    if not timers.active():
        return _stack(params, kinds, x, out_layers)
    grad = torch.is_grad_enabled() and x.requires_grad
    flops = vgg_flops(kinds, x.shape[-2:], max(out_layers), x.shape[0])
    timers.count("style.vgg_flops", 2 * flops if grad else flops)
    with timers.span("style.vgg", size=list(x.shape[-2:]),
                     layers=list(out_layers)):
        if not grad:
            return _stack(params, kinds, x, out_layers)
        back = timers.span("style.vgg_backward")
        outs = _stack(params, kinds, _CloseBackward.apply(back, x),
                      out_layers)
        return list(_OpenBackward.apply(back, *outs))


def _stack(params, kinds, x, out_layers):
    max_layer = max(out_layers)
    outs = []
    h = x
    for i, (kind, _) in enumerate(kinds):
        if i > max_layer:
            break
        if kind == "conv":
            w, b = params[i]
            h = F.conv2d(h, w, b, padding=1)
        elif kind == "relu":
            h = torch.relu(h)
        else:
            h = F.max_pool2d(h, 2, 2)
        if i in out_layers:
            outs.append(h)
    return outs


def normalize_imagenet(img):
    """img [..., 3, H, W] in [0, 1] -> ImageNet-normalised."""
    timers.count("sync.vgg_normalize", 2)  # the constants' two uploads
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=img.device)[:, None, None]
    return (img - mean) / std


# LPIPS's layers, (feature index, pools before it): relu1_2 .. relu5_3
_LPIPS_LAYERS = ((3, 0), (8, 1), (15, 2), (22, 3), (29, 4))


def lpips_fn(device="cuda"):
    """Perceptual distance through VGG-16 features: the unit-weight
    VGG-LPIPS variant, the mean squared distance of channel-normalised
    features at relu1_2 .. relu5_3, averaged over the layers. Layers whose
    pooled size would fall below 1 pixel are dropped for small images.
    Raises RuntimeError without pretrained VGG-16 weights.

    Returns dist(a, b) for images in [0, 1] on `device`: [H, W, 3] pairs
    give a 0-d tensor, [B, H, W, 3] batches the [B] distances of their
    pairs (one pass through the stack for the whole batch)."""
    if _npz_path("vgg16") is None:
        raise RuntimeError("LPIPS requires local vgg16 weights")
    params, kinds, _ = vgg_init("vgg16", device=device)

    def prep(x):
        return normalize_imagenet(torch.movedim(x, -1, -3))

    def dist(a, b):
        single = a.dim() == 3
        if single:
            a, b = a[None], b[None]
        size = min(a.shape[1], a.shape[2])
        layers = tuple(l for l, p in _LPIPS_LAYERS if size >> (p + 1) >= 1)
        fa = vgg_features(params, kinds, prep(a), layers)
        fb = vgg_features(params, kinds, prep(b), layers)
        total = 0.0
        for xa, xb in zip(fa, fb):
            na = xa / torch.clamp(torch.linalg.vector_norm(
                xa, dim=1, keepdim=True), min=1e-8)
            nb = xb / torch.clamp(torch.linalg.vector_norm(
                xb, dim=1, keepdim=True), min=1e-8)
            total = total + torch.mean(torch.sum((na - nb) ** 2, dim=1),
                                       dim=(1, 2))
        total = total / len(layers)
        return total[0] if single else total

    return dist
