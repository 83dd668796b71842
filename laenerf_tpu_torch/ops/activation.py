"""Truncated exponential activation (counterpart of
laenerf_tpu/ops/activation.py): forward exp(x); the backward clamps the saved
input to [-15, 15] so bf16 training does not blow up on large densities."""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)
