"""Gradient reversal (port of facodec_tpu/ops/gradrev.py).

Identity in the forward pass, `-alpha * grad` in the backward pass: the
adversarial branches of the predictor heads train their heads to predict a
factor and the quantizer streams to hide it.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, alpha: float) -> torch.Tensor:
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.alpha * g, None


def gradient_reversal(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return _GradientReversal.apply(x, alpha)


class GradientReversal(nn.Module):
    """`gradient_reversal` as a module: index 0 of the reference's
    `nn.Sequential(GradientReversal, head)` branches, so the heads' keys
    keep their `.1.` level."""

    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gradient_reversal(x, self.alpha)
