"""Alias-free (anti-aliased) resampling around an activation (NTC layout).

Port of facodec_tpu/nn/alias_free.py: Kaiser-windowed sinc low-pass taps
around each nonlinearity. The taps are computed in numpy, as the JAX package
computes them; the torch reference's `*.filter` buffers are not in a
checkpoint the port reads (utils/weights.py drops them), so each resampler
holds its taps as a non-persistent buffer built here. The resamplers are
depthwise convolutions with one set of taps for every channel, in the
dtype of their input, as the JAX package's `lax.conv` runs on whatever
dtype comes in: a bf16 input (the predictor heads under `bfloat16_act`)
takes bf16-rounded taps, sums in float32 and rounds the result to bf16 (on
the CPU a float32 conv of the bf16 values, rounded after).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from facodec_tpu_torch.nn.activations import SnakeBeta


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Low-pass taps (K,) float32, as the reference's alias_free_torch filter."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros_like(time, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


def _default_kernel(ratio: int, kernel_size: Optional[int]) -> int:
    return int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size


class _Resample(nn.Module):
    def __init__(self, ratio: int, kernel_size: int):
        super().__init__()
        self.ratio, self.kernel_size = ratio, kernel_size
        taps = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size)
        self.register_buffer("taps", torch.from_numpy(taps), persistent=False)

    def _weight(self, channels: int) -> torch.Tensor:
        """(C, 1, K): the taps for every channel of a depthwise conv."""
        return self.taps[None, None, :].expand(channels, 1, self.kernel_size)

    def _conv(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn(x, taps) over the NCT x, in x's dtype (the module docstring)."""
        w = self._weight(x.shape[1]).to(x.dtype)
        if x.dtype == torch.float32 or x.device.type == "cuda":
            return fn(x, w)
        return fn(x.float(), w.float()).to(x.dtype)


class UpSample1d(_Resample):
    """ratio-x upsampling: edge pad, depthwise transposed conv, trim."""

    def __init__(self, ratio: int = 2, kernel_size: Optional[int] = None):
        super().__init__(ratio, _default_kernel(ratio, kernel_size))
        ks = self.kernel_size
        self.pad = ks // ratio - 1
        self.pad_left = self.pad * ratio + (ks - ratio) // 2
        self.pad_right = self.pad * ratio + (ks - ratio + 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        xt = F.pad(x.transpose(1, 2), (self.pad, self.pad), mode="replicate")
        y = self.ratio * self._conv(
            lambda a, w: F.conv_transpose1d(a, w, stride=self.ratio, groups=C), xt)
        return y[..., self.pad_left : y.shape[-1] - self.pad_right].transpose(1, 2)


class DownSample1d(_Resample):
    """ratio-x downsampling: edge pad, depthwise low-pass conv at stride."""

    def __init__(self, ratio: int = 2, kernel_size: Optional[int] = None):
        super().__init__(ratio, _default_kernel(ratio, kernel_size))
        ks = self.kernel_size
        self.pad_left = ks // 2 - int(ks % 2 == 0)
        self.pad_right = ks // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        xt = F.pad(x.transpose(1, 2), (self.pad_left, self.pad_right), mode="replicate")
        y = self._conv(lambda a, w: F.conv1d(a, w, stride=self.ratio, groups=C), xt)
        return y.transpose(1, 2)


class Activation1d(nn.Module):
    """2x-oversampled SnakeBeta: upsample -> act -> downsample."""

    def __init__(self, snake_features: int, alpha_logscale: bool = True, up_ratio: int = 2,
                 down_ratio: int = 2, up_kernel_size: int = 12, down_kernel_size: int = 12):
        super().__init__()
        self.upsample = UpSample1d(up_ratio, up_kernel_size)
        self.act = SnakeBeta(snake_features, alpha_logscale)
        self.downsample = DownSample1d(down_ratio, down_kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.downsample(self.act(self.upsample(x)))
