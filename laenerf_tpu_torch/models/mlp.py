"""Bias-free MLP (counterpart of laenerf_tpu/models/mlp.py).

bf16 inputs and weights, f32 accumulation, bf16 activations, f32 output: a
bf16 `F.linear` accumulates in f32 and rounds its result to bf16 once, which
is what the JAX package's `dot(..., preferred_element_type=f32)` followed by
a bf16 cast computes (ReLU commutes with the rounding). On the card this
needs `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False`, which the train and render entry points set.

Weights are `nn.Linear(bias=False)` in PyTorch's [out, in] layout; the JAX
package stores [in, out] (convert.py transposes).
"""

import math
from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F


class MLP(nn.Module):
    """ReLU between layers, none after the last."""

    def __init__(self, dims: Sequence[int], *, device, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(din, dout, bias=False, device=device)
            for din, dout in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for lin in self.layers:
                # torch.nn.Linear's default kaiming-uniform bound
                bound = 1.0 / math.sqrt(lin.in_features)
                lin.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return mlp_apply(self, x)


def mlp_init(dims: Sequence[int], *, device, generator=None) -> MLP:
    return MLP(dims, device=device, generator=generator)


def mlp_apply(mlp: MLP, x, compute_dtype=torch.bfloat16,
              out_dtype=torch.float32):
    h = x.to(compute_dtype)
    n = len(mlp.layers)
    for i, lin in enumerate(mlp.layers):
        h = F.linear(h, lin.weight.to(compute_dtype))
        if i != n - 1:
            h = torch.relu(h)
    return h.to(out_dtype)
