"""Truncated-gradient exponential (counterpart of ngp_pl_tpu/ops/trunc_exp.py,
reference models/custom_functions.py:162-173).

The forward clamps its input to [-30, 30], so a density logit past ~88.7
cannot overflow f32 exp; the backward re-exponentiates the input clamped to
[-15, 15], which bounds the gradient without biasing the forward value.
"""
from __future__ import annotations

import torch


class TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, -30.0, 30.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)
