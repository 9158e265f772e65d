"""Convolution layers in NTC layout with torch parameter layout.

Port of facodec_tpu/nn/conv.py, one-shot only (no streaming state), with
the options the codec uses: every conv has a bias and one group. Conv
weights are (O, I, K), transposed-conv weights (I, O, K); weight norm keeps
`weight_g` / `weight_v` as parameters and computes `v * (g / ||v||)` over
every dim but 0 on each call. Activations are NTC at every public function;
`F.conv1d` runs on the NCT transpose.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from facodec_tpu_torch.ops.padding import get_extra_padding_for_conv1d, pad1d


def apply_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))
    return v * (g / norm)


def conv1d_ntc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               stride: int = 1, dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """1-D conv over NTC input with a (O, I, K) weight. A pointwise conv is a
    matmul over channels and runs as one, as in the JAX package."""
    if weight.shape[-1] == 1 and stride == 1 and padding == 0:
        return F.linear(x, weight[:, :, 0], bias)
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding,
                 dilation=dilation)
    return y.transpose(1, 2)


class _WeightNormConv(nn.Module):
    """Holds `weight_g`/`weight_v` (or a plain `weight`) and `bias`."""

    def _init_weight(self, shape: Tuple[int, int, int], weight_norm: bool, out_channels: int):
        if weight_norm:
            self.weight_v = nn.Parameter(torch.empty(shape))
            self.weight_g = nn.Parameter(torch.empty(shape[0], 1, 1))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.weight_norm = weight_norm

    def effective_weight(self) -> torch.Tensor:
        if self.weight_norm:
            return apply_weight_norm(self.weight_v, self.weight_g)
        return self.weight


class Conv1d(_WeightNormConv):
    """torch-style Conv1d with symmetric zero padding, NTC activations."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, weight_norm: bool = False):
        super().__init__()
        self.padding = padding
        self._init_weight((out_channels, in_channels, kernel_size), weight_norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_ntc(x, self.effective_weight(), self.bias, padding=self.padding)


class SConv1d(_WeightNormConv):
    """Conv1d with the codec's automatic reflect padding: causal=True pads
    `(k_eff - stride, extra)`; causal=False splits `k_eff - stride` with the
    extra on the right."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, causal: bool = False,
                 norm: str = "weight_norm"):
        super().__init__()
        self.kernel_size, self.stride, self.dilation, self.causal = (
            kernel_size, stride, dilation, causal)
        self._init_weight((out_channels, in_channels, kernel_size), norm == "weight_norm",
                          out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_eff = (self.kernel_size - 1) * self.dilation + 1
        padding_total = k_eff - self.stride
        extra = get_extra_padding_for_conv1d(x.shape[1], k_eff, self.stride, padding_total)
        if self.causal:
            pl, pr = padding_total, extra
        else:
            pl, pr = padding_total - padding_total // 2, padding_total // 2 + extra
        if pl or pr:
            x = pad1d(x, (pl, pr))
        return conv1d_ntc(x, self.effective_weight(), self.bias, stride=self.stride,
                          dilation=self.dilation)


class SConvTranspose1d(_WeightNormConv):
    """Weight-normed ConvTranspose1d (I, O, K) that trims `k - stride`
    samples: all on the right when causal, split otherwise."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False):
        super().__init__()
        self.kernel_size, self.stride, self.causal = kernel_size, stride, causal
        self._init_weight((in_channels, out_channels, kernel_size), True, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.effective_weight(), self.bias,
                               stride=self.stride).transpose(1, 2)
        padding_total = self.kernel_size - self.stride
        pr = padding_total if self.causal else padding_total // 2
        return y[:, padding_total - pr : y.shape[1] - pr]
