"""Plain reference of LAENeRF recolor training at
`configs/laenerf_palette8.json`: the hash-grid encoder over termination
points, the weight net with its softmax over the palette, the offset net
on the encoding and the view direction's SH, the colours, the masked MSE,
the weight, offset and palette regularizers, the crop window's smooth-
transition loss, the backward and Adam with the palette at twice the
learning rate (LAENeRF, CVPR 2024).

It follows the program's first steps from the same start: the weights the
harness drew, and each step's batch as the harness reads it from the
dataset file (the view the program's shuffle chose, its termination
points moved along the ray by the program's uniform draw), which it
reads as inputs.
"""

import torch

from .common import Adam, grid_encode, grid_spec, mlp, no_tf32, sh_encode

LEAVES = ("encoder", "weight_net.layers.0.weight",
          "weight_net.layers.1.weight", "weight_net.layers.2.weight",
          "offset_net.layers.0.weight", "offset_net.layers.1.weight",
          "offset_net.layers.2.weight", "palette")


def _forward(p, x, d, c, precision):
    feats = grid_encode(p["encoder"], x, grid_spec(c), c["bound"], precision)
    n = c["num_layers"]
    logits = mlp([p[f"weight_net.layers.{i}.weight"] for i in range(n)],
                 feats, precision)
    w_hat = torch.softmax(logits, dim=-1)
    off_in = torch.cat([feats, sh_encode(d, c["dir_degree"])], dim=-1)
    o_hat = torch.tanh(mlp([p[f"offset_net.layers.{i}.weight"]
                            for i in range(n)], off_in, precision))
    return torch.clamp(w_hat @ p["palette"] + o_hat, 0.0, 1.0), w_hat, o_hat


def loss_of(p, b, c, H, W, crop_h, crop_w, precision, fault=None):
    """One step's loss on the batch b of a view (all palette bases
    active, past warm-up)."""
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
    # the crop window of the predictions scattered into the image
    img = torch.zeros((H * W + 1, 3), device=colors.device).index_put(
        (b["inds"].long(),), colors * vm)[:H * W].reshape(H, W, 3)
    cx, cy = b["crop_origin"]
    crop = img[cx:cx + crop_h, cy:cy + crop_w]
    loss = loss + c["smooth_trans_weight"] * torch.sum(
        torch.sum((crop - b["cut_gt"]) ** 2, dim=-1) * b["cut_smooth"])
    return loss, mse


def train(leaves, batches, c, H, W, crop_h, crop_w, precision="bf16",
          fault=None):
    """Follow the program's first len(batches) steps from `leaves`.
    Returns dict: losses, mses [n], grad1 by leaf, params by leaf."""
    no_tf32()
    p = {k: leaves[k].clone().requires_grad_(True) for k in LEAVES}
    params = [p[k] for k in LEAVES]
    lrs = [c["lr"]] * (len(LEAVES) - 1) + [2 * c["lr"]]
    opt = Adam(params, lrs, (0.9, 0.999), 1e-8)
    out = {"losses": [], "mses": []}
    for k, b in enumerate(batches):
        loss, mse = loss_of(p, b, c, H, W, crop_h, crop_w, precision, fault)
        grads = torch.autograd.grad(loss, params)
        if k == 0:
            out["grad1"] = {n: g.detach() for n, g in zip(LEAVES, grads)}
        out["losses"].append(float(loss.detach()))
        out["mses"].append(float(mse.detach()))
        if fault != "frozen":
            opt.step([g.detach() for g in grads])
    out["params"] = {n: q.detach() for n, q in zip(LEAVES, params)}
    return out
