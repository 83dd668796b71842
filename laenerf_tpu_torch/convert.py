"""Parameter conversion between the JAX package's param pytree and the
port's NeRFNetwork state dict.

The JAX tree (as numpy arrays) is {"encoder": [T, C], "sigma_net": [W...],
"color_net": [W...]}, with MLP weights stored [in, out]; nn.Linear stores
[out, in], so the weights are transposed both ways.
"""

import numpy as np
import torch

_NETS = ("sigma_net", "color_net")


def params_from_jax(tree):
    """JAX param tree (numpy arrays) -> NeRFNetwork state dict."""
    sd = {"encoder": torch.tensor(np.asarray(tree["encoder"], np.float32))}
    for name in _NETS:
        for i, w in enumerate(tree[name]):
            sd[f"{name}.layers.{i}.weight"] = torch.tensor(
                np.ascontiguousarray(np.asarray(w, np.float32).T))
    return sd


def params_to_numpy(net):
    """NeRFNetwork -> JAX-layout param tree of numpy arrays."""
    tree = {"encoder": net.encoder.detach().cpu().numpy()}
    for name in _NETS:
        tree[name] = [np.ascontiguousarray(lin.weight.detach().cpu().numpy().T)
                      for lin in getattr(net, name).layers]
    return tree
