"""Snake activations and Mish (NTC layout).

Port of facodec_tpu/nn/activations.py: `Snake1d` (the codec's) and
`SnakeBeta` (the predictor heads', inside the alias-free activations). `sin2` is not `torch.sin(x) ** 2`:
it clamps at +-3e4, reduces modulo pi with a 3-constant Cody-Waite split
(`torch.round` rounds half to even, as `jnp.round` does) and evaluates the
degree-13 fdlibm polynomial, so that the port computes the same numbers as
the JAX package on large activations. The constants are copied exactly; the
CUDA residual-unit kernel (csrc/resunit.cu) uses the same ones.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

PI_A = 3.140625  # 11 significand bits: k*PI_A exact for k < 2^13
PI_B = 9.6750259399414062e-4  # next 12 bits of pi
PI_C = 1.5099580252808664e-07  # remainder (f32)
SIN2_RANGE = 3.0e4
SIN_COEFFS = (  # fdlibm __kernel_sin minimax, f32-truncated
    -1.6666667163e-01, 8.3333337680e-03, -1.9841270114e-04,
    2.7557314297e-06, -2.5050759689e-08, 1.5896910177e-10,
)


def sin2(x: torch.Tensor) -> torch.Tensor:
    """sin(x)^2 at f32-sin accuracy for |x| <= 2.5e4; clamped beyond 3e4."""
    x = torch.clamp(x, -SIN2_RANGE, SIN2_RANGE)
    k = torch.round(x * (1.0 / math.pi))
    t = ((x - k * PI_A) - k * PI_B) - k * PI_C
    t2 = t * t
    p = torch.full_like(t, SIN_COEFFS[-1])
    for c in SIN_COEFFS[-2::-1]:
        p = p * t2 + c
    s = t + t * t2 * p
    return s * s


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + (alpha + 1e-9)^-1 * sin^2(alpha * x); the reciprocal is taken on
    the parameter, as in the JAX package. alpha (float32) broadcasts over
    (B, T). A bf16 x (the bfloat16_act policy) is computed on in float32 and
    only the result is rounded back to bf16."""
    recip = 1.0 / (alpha + 1e-9)
    return (x + sin2(alpha * x) * recip).to(x.dtype)


class Snake1d(nn.Module):
    """Per-channel snake; alpha kept in the torch shape (1, C, 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha.reshape(1, 1, self.channels))


class SnakeBeta(nn.Module):
    """x + 1 / (beta + 1e-9) * sin^2(alpha * x) with per-channel alpha and
    beta of shape (C,); with `alpha_logscale` both are stored as logs
    (initialised to 0) and exponentiated on each call."""

    def __init__(self, in_features: int, alpha_logscale: bool = False):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        init = torch.zeros if alpha_logscale else torch.ones
        self.alpha = nn.Parameter(init(in_features))
        self.beta = nn.Parameter(init(in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.alpha[None, None, :], self.beta[None, None, :]
        if self.alpha_logscale:
            a, b = torch.exp(a), torch.exp(b)
        return (x + sin2(x * a) * (1.0 / (b + 1e-9))).to(x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))
