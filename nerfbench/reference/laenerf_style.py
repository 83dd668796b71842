"""Plain reference of LAENeRF style training at
`configs/laenerf_style_vgg19.json`: the recolor step of
`laenerf_palette8.py` (the hash-grid encoder, the weight and offset nets,
the masked MSE and the weight, offset and palette regularizers) plus the
crop terms that LAENeRF's style mode adds past warm-up (Radl et al., CVPR
2024): the predictions scattered into the view's crop window, the crop
resized to the style size with an antialiased bilinear filter, VGG-19's
features to conv3_3 (Simonyan and Zisserman, arXiv 1409.1556, torchvision
`features` indices), the Gram loss against the style crop's Grams, the
depth-guided total variation, the smooth-transition term and the depth
discontinuity; then the backward and Adam with the palette at twice the
learning rate. Float32 throughout (the MLPs and the table rows rounded to
bfloat16 where the configuration states it), both TF32 flags False.

Departures from the published description, each as the configuration
runs it: the filters are He-random from the seed (N(0, 2 / (9 cin)), zero
biases), not ImageNet-trained; the style image is the procedural wave,
not `wave_style.png`; the Gram matrices are normalised by c * h * w and
their squared differences summed over the three layers and divided by
the total element count (one MSE over the stacked Grams), as the LAENeRF
code does; the Gram outputs are the convolutions' outputs before their
ReLUs (indices 10, 12 and 14 are convolutions).

It follows the program's first steps from the same start: the weights and
filters the harness drew, the style crop the program took, and each step's
batch as the harness reads it from the dataset file.
"""

import torch
import torch.nn.functional as F

from .common import Adam, no_tf32, rnd
from .laenerf_palette8 import LEAVES, _forward

# ImageNet's channel means and deviations (torchvision's normalisation)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _kinds(layout):
    """The stack in torchvision `features` order: ("conv", cout),
    ("relu", None) or ("pool", None) at each index."""
    out = []
    for item in layout:
        if item == "M":
            out.append(("pool", None))
        else:
            out += [("conv", item), ("relu", None)]
    return out


class _Tf32(torch.autograd.Function):
    """Rounds to TF32 (10 stored mantissa bits, to nearest, ties away from
    zero, as the tensor cores take float32 operands), and the gradient on
    the way back the same."""

    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def _round_tf32(x):
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _conv(x, w, b, vgg):
    """A 3x3 convolution, padding 1, at the stack's precision: "f32";
    "bf16" (operands and output rounded to bfloat16, products summed in
    float32); "tf32" (on the card cuDNN's TF32 kernels, which train()
    allows; on the CPU, which has none, the operands rounded to TF32)."""
    if vgg == "bf16":
        return rnd(F.conv2d(rnd(x, "bf16"), rnd(w, "bf16"), b, padding=1),
                   "bf16")
    if vgg == "tf32" and not x.is_cuda:
        return F.conv2d(_Tf32.apply(x), _Tf32.apply(w), b, padding=1)
    return F.conv2d(x, w, b, padding=1)


def features(filters, layout, x, layers, vgg="f32"):
    """Activations [1, c, h, w] at the feature indices `layers` of an image
    x [3, h, w] in [0, 1]: ImageNet-normalised, then the stack to the
    largest index. filters: {index: (w [cout, cin, 3, 3], b [cout])}."""
    mean = torch.tensor(MEAN, device=x.device)[:, None, None]
    std = torch.tensor(STD, device=x.device)[:, None, None]
    h = ((x - mean) / std)[None]
    outs = []
    for i, (kind, _) in enumerate(_kinds(layout)):
        if i > max(layers):
            break
        if kind == "conv":
            h = _conv(h, *filters[i], vgg)
        elif kind == "relu":
            h = torch.relu(h)
        else:
            h = F.max_pool2d(h, 2, 2)
        if i in layers:
            outs.append(h)
    return outs


def grams(feats):
    """Gram matrices [c, c] of [1, c, h, w] features over c * h * w."""
    out = []
    for f in feats:
        _, c, h, w = f.shape
        flat = f[0].reshape(c, h * w)
        out.append(flat @ flat.T / (c * h * w))
    return out


def gram_term(gs, targets):
    """Summed squared Gram differences over the total element count."""
    total = sum(torch.sum((g - t) ** 2) for g, t in zip(gs, targets))
    return total / sum(g.numel() for g in gs)


def _filter_weights(n_in, n_out, device):
    """[n_out, n_in]: the half-pixel triangle filter, widened by the scale
    where it shrinks (antialiasing), each row summing to one."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float64) + 0.5) * scale
    pos = torch.arange(n_in, dtype=torch.float64) + 0.5
    w = torch.clamp(1.0 - (pos[None] - centre[:, None]).abs() / support,
                    min=0.0)
    return (w / w.sum(dim=1, keepdim=True)).float().to(device)


def resize(img, size):
    """img [c, h, w] resized to [c, size, size], antialiased bilinear."""
    if tuple(img.shape[1:]) == (size, size):
        return img
    rows = _filter_weights(img.shape[1], size, img.device)
    cols = _filter_weights(img.shape[2], size, img.device)
    return rows @ img @ cols.T


def tv_depth_guided(img, tv_v, tv_h, smooth):
    """Squared neighbour differences of img [3, h, w], weighted away from
    depth edges (1 - the edge maps) and from the transition shell
    (1 - smooth at the later pixel of each pair)."""
    dv = (1.0 - tv_v) * (1.0 - smooth[:, 1:])
    dh = (1.0 - tv_h) * (1.0 - smooth[1:, :])
    down = (img[:, 1:, :] - img[:, :-1, :]) ** 2
    right = (img[:, :, 1:] - img[:, :, :-1]) ** 2
    return torch.sum(down * dh[None]) + torch.sum(right * dv[None])


def depth_discontinuity(img, tv_v, tv_h):
    """Minus the squared neighbour differences weighted by the edge maps,
    each scaled to its largest value: a reward for colour edges at depth
    edges."""
    dv = tv_v / torch.clamp(tv_v.max(), min=1e-8)
    dh = tv_h / torch.clamp(tv_h.max(), min=1e-8)
    down = (img[:, 1:, :] - img[:, :-1, :]) ** 2
    right = (img[:, :, 1:] - img[:, :, :-1]) ** 2
    return -torch.sum(down * dh[None]) - torch.sum(right * dv[None])


def loss_of(p, b, c, style, targets, H, W, crop_h, crop_w, precision,
            fault=None, vgg="f32"):
    """One style step's loss on the batch b of a view past warm-up.
    Returns (loss, mse, the unweighted Gram term)."""
    valid = b["valid"]
    if fault == "half_batch":  # the second half of the valid rows left out
        valid = valid & (torch.arange(valid.shape[0], device=valid.device)
                         < valid.sum() // 2)
    vm = valid[:, None].float()
    n_valid = torch.clamp(valid.sum(), min=1)
    colors, w_hat, o_hat = _forward(p, b["x_term"], b["dirs"], c, precision)
    mse = torch.sum((colors - b["targets"]) ** 2 * vm) / (3 * n_valid)
    loss = mse + c["weight_loss_non_uniform"] * torch.sum(
        (1.0 - w_hat.amax(dim=-1)) * valid.float())
    loss = loss + c["offset_loss"] * torch.sum((o_hat * vm) ** 2)
    pal = p["palette"]
    loss = loss + c["palette_loss_valid"] * torch.sum(torch.floor(pal) * pal)
    img = torch.zeros((H * W + 1, 3), device=colors.device).index_put(
        (b["inds"].long(),), colors * vm)[:H * W].reshape(H, W, 3)
    cx, cy = b["crop_origin"]
    crop = img[cx:cx + crop_h, cy:cy + crop_w]
    chw = crop.permute(2, 0, 1)
    x = resize(chw, style["size"])
    gram = gram_term(grams(features(style["filters"], c["vgg19_layout"], x,
                                    style["layers"], vgg)), targets)
    smooth = b["cut_smooth"]
    loss = loss + c["style_weight"] * gram
    loss = loss + c["tv_weight"] * tv_depth_guided(chw, b["tv_v"], b["tv_h"],
                                                   smooth)
    loss = loss + c["smooth_trans_weight"] * torch.sum(
        torch.sum((crop - b["cut_gt"]) ** 2, dim=-1) * smooth)
    loss = loss + c["depth_disc_weight"] * depth_discontinuity(
        chw, b["tv_v"], b["tv_h"])
    return loss, mse, gram


def train(leaves, batches, c, H, W, crop_h, crop_w, style, precision="bf16",
          fault=None, vgg="f32"):
    """Follow the program's first len(batches) steps from `leaves`.

    style: filters {index: (w, b)}, crop (the style image's window the
    program took, [3, size, size]), layers, size. vgg: the stack's
    precision ("f32" as configured; "tf32" and "bf16" are controls).
    Returns dict: losses, mses, grams [n], grad1 by leaf, params by leaf.
    """
    no_tf32()
    # the cuDNN flag reaches the stack's convolutions only: the grid, the
    # MLPs and the Grams are products under the matmul flag, left False
    torch.backends.cudnn.allow_tf32 = vgg == "tf32"
    try:
        with torch.no_grad():
            targets = grams(features(style["filters"], c["vgg19_layout"],
                                     style["crop"], style["layers"], vgg))
        p = {k: leaves[k].clone().requires_grad_(True) for k in LEAVES}
        params = [p[k] for k in LEAVES]
        lrs = [c["lr"]] * (len(LEAVES) - 1) + [2 * c["lr"]]
        opt = Adam(params, lrs, (0.9, 0.999), 1e-8)
        out = {"losses": [], "mses": [], "grams": []}
        for k, b in enumerate(batches):
            loss, mse, gram = loss_of(p, b, c, style, targets, H, W, crop_h,
                                      crop_w, precision, fault, vgg)
            grads = torch.autograd.grad(loss, params)
            if k == 0:
                out["grad1"] = {n: g.detach() for n, g in zip(LEAVES, grads)}
            out["losses"].append(float(loss.detach()))
            out["mses"].append(float(mse.detach()))
            out["grams"].append(float(gram.detach()))
            if fault != "frozen":
                opt.step([g.detach() for g in grads])
        out["params"] = {n: q.detach() for n, q in zip(LEAVES, params)}
        return out
    finally:
        no_tf32()
