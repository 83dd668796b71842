"""Parameter conversion between the JAX package's param pytrees and the
port's modules, and a numpy-only reader of the JAX package's checkpoints.

The JAX NeRF tree (as numpy arrays) is {"encoder": [T, C], "sigma_net":
[W...], "color_net": [W...]}, plus {"encoder_bg": [T_bg, 2], "bg_net":
[W...]} for a model with a background network; the LAENeRF tree is {"encoder": [T, C],
"weight_net": [W...], "offset_net": [W...], "palette": [K, 3]}. The JAX
package stores MLP weights [in, out]; nn.Linear stores [out, in], so the
weights are transposed both ways. Its VGG stacks are lists of (w [kh, kw,
cin, cout], b) or None; the port's hold w as [cout, cin, kh, kw]. The
CLIP tower keeps the JAX layout (x @ w, blocks stacked on [12, ...]); its
tree {"patch_w", ..., "ln_pre": {"w", "b"}, "blocks": {...}} maps to the
state dict's dotted names.
"""

import re

import numpy as np
import torch

_NETS = ("sigma_net", "color_net")
_LAENERF_NETS = ("weight_net", "offset_net")


def _from_jax(tree, nets, plain):
    sd = {k: torch.tensor(np.asarray(tree[k], np.float32)) for k in plain}
    for name in nets:
        for i, w in enumerate(tree[name]):
            sd[f"{name}.layers.{i}.weight"] = torch.tensor(
                np.ascontiguousarray(np.asarray(w, np.float32).T))
    return sd


def tree_from_state_dict(sd):
    """A port state dict (or any {parameter name: tensor} of the same
    names) -> the JAX-layout tree of numpy arrays."""
    tree = {}
    for name, v in sd.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        m = re.fullmatch(r"(\w+)\.layers\.(\d+)\.weight", name)
        if m is None:
            tree[name] = a
            continue
        layers = tree.setdefault(m.group(1), [])
        i = int(m.group(2))
        layers.extend([None] * (i + 1 - len(layers)))
        layers[i] = np.ascontiguousarray(a.T)
    return tree


def params_from_jax(tree):
    """JAX NeRF param tree (numpy arrays) -> NeRFNetwork state dict (with
    the background network's leaves where the tree has them)."""
    if "encoder_bg" in tree:
        return _from_jax(tree, _NETS + ("bg_net",), ("encoder", "encoder_bg"))
    return _from_jax(tree, _NETS, ("encoder",))


def params_to_numpy(net):
    """NeRFNetwork -> JAX-layout param tree of numpy arrays."""
    return tree_from_state_dict(net.state_dict())


def laenerf_params_from_jax(tree):
    """JAX LAENeRF param tree (numpy arrays) -> LAENeRF state dict."""
    return _from_jax(tree, _LAENERF_NETS, ("encoder", "palette"))


def laenerf_params_to_numpy(model):
    """LAENeRF -> JAX-layout param tree of numpy arrays."""
    return tree_from_state_dict(model.state_dict())


def clip_params_from_jax(tree):
    """JAX CLIP vision pytree (numpy leaves) -> CLIPVision state dict."""
    sd = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sd.update({f"{k}.{n}": torch.tensor(np.asarray(a, np.float32))
                       for n, a in v.items()})
        else:
            sd[k] = torch.tensor(np.asarray(v, np.float32))
    return sd


def clip_params_to_numpy(model):
    """CLIPVision -> the JAX package's pytree of numpy arrays."""
    tree = {}
    for name, v in model.state_dict().items():
        a = v.detach().cpu().numpy()
        if "." in name:
            group, leaf = name.split(".", 1)
            tree.setdefault(group, {})[leaf] = a
        else:
            tree[name] = a
    return tree


def vgg_params_from_jax(params, device="cpu"):
    """JAX VGG params (a list of (w HWIO, b) or None) -> the port's stack
    (w OIHW, b) float32 tensors on device."""
    return [None if p is None else (
        torch.tensor(np.ascontiguousarray(
            np.transpose(np.asarray(p[0], np.float32), (3, 2, 0, 1))),
            device=device),
        torch.tensor(np.asarray(p[1], np.float32), device=device))
        for p in params]


def vgg_params_to_numpy(params):
    """The port's VGG stack -> the JAX layout (w HWIO, b) numpy list."""
    return [None if p is None else (
        np.ascontiguousarray(np.transpose(p[0].detach().cpu().numpy(),
                                          (2, 3, 1, 0))),
        p[1].detach().cpu().numpy()) for p in params]


def _subtree(data, prefix):
    """The {"encoder": ..., "<net>": [...], ...} tree stored under the
    keystr prefix (e.g. "['state'].params")."""
    tree = {}
    pat = re.compile(re.escape(prefix) + r"\['(\w+)'\](?:\[(\d+)\])?$")
    for key in data:
        m = pat.match(key)
        if m is None:
            continue
        if m.group(2) is None:
            tree[m.group(1)] = data[key]
        else:
            layers = tree.setdefault(m.group(1), {})
            layers[int(m.group(2))] = data[key]
    return {k: [v[i] for i in sorted(v)] if isinstance(v, dict) else v
            for k, v in tree.items()}


def load_jax_checkpoint(path):
    """Read a JAX Trainer checkpoint (.npz) with numpy alone.

    Returns {"params": NeRFNetwork state dict, "ema_params": state dict,
    "occ": {"density_grid", "occupancy", "mean_density", "iter_density"}
    numpy arrays, "step": int}. A trained LAENeRF's style_enc.npz (the
    recolor, style and NPR pipelines') reads as {"params": LAENeRF state
    dict, "active": [K] bool numpy}.
    """
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    if "['active']" in data:
        return {"params": laenerf_params_from_jax(_subtree(data,
                                                           "['params']")),
                "active": data["['active']"].astype(bool)}
    occ = {k: data[f"['occ'].{k}"] for k in (
        "density_grid", "occupancy", "mean_density", "iter_density")}
    return {
        "params": params_from_jax(_subtree(data, "['state'].params")),
        "ema_params": params_from_jax(_subtree(data,
                                               "['state'].ema_params")),
        "occ": occ,
        "step": int(data["['state'].step"]),
    }
