"""Snake activation and Mish (NTC layout).

Port of facodec_tpu/nn/activations.py. `sin2` is not `torch.sin(x) ** 2`:
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
    the parameter, as in the JAX package. alpha broadcasts over (B, T)."""
    recip = 1.0 / (alpha + 1e-9)
    return x + sin2(alpha * x) * recip


class Snake1d(nn.Module):
    """Per-channel snake; alpha kept in the torch shape (1, C, 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha.reshape(1, 1, self.channels))


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))
