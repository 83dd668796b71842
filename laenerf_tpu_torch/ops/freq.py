"""Positional (frequency) encoding (counterpart of laenerf_tpu/ops/freq.py):
[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(deg-1) x), cos(2^(deg-1) x)], each
term D wide, so D + 2 * D * degree channels."""

import torch


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + 2 * input_dim * degree


def freq_encode(x, degree: int = 4):
    """[..., D] coordinates -> [..., D + 2 * D * degree]: the identity, then
    a (sin, cos) pair per octave."""
    outs = [x]
    for f in range(degree):
        xs = x * (2.0 ** f)
        outs += [torch.sin(xs), torch.cos(xs)]
    return torch.cat(outs, dim=-1)
