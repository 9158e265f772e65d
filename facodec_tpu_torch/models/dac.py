"""DAC-style causal convolutional encoder and decoder (NTC layout).

Port of facodec_tpu/models/dac.py, one-shot only. Submodules sit in
`nn.ModuleList`s named `block` (encoder side) and `model` (decoder), so that
`block.1.block.0.block.1.weight_v` maps onto the JAX path
('block_1', 'block_0', 'block_1', 'weight_v').

Every ResidualUnit goes through `ops.kernels.resunit.fused_residual_unit`:
the CUDA kernel for a tensor on the card, the plain composition on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from facodec_tpu_torch.nn.activations import Snake1d
from facodec_tpu_torch.nn.conv import SConv1d, SConvTranspose1d
from facodec_tpu_torch.nn.lstm import SLSTM
from facodec_tpu_torch.ops.kernels.resunit import fused_residual_unit


class ResidualUnit(nn.Module):
    """Snake -> dilated 7-tap conv -> Snake -> 1x1 conv, residual add."""

    def __init__(self, dim: int = 16, dilation: int = 1, causal: bool = False):
        super().__init__()
        self.dilation, self.causal = dilation, causal
        self.block = nn.ModuleList([
            Snake1d(dim),
            SConv1d(dim, dim, 7, dilation=dilation, causal=causal),
            Snake1d(dim),
            SConv1d(dim, dim, 1, causal=causal),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        snake1, conv7, snake2, conv1 = self.block
        return fused_residual_unit(
            x.contiguous(), conv7.effective_weight(), conv7.bias, conv1.effective_weight(),
            conv1.bias, snake1.alpha, snake2.alpha, self.dilation, self.causal,
        )


class EncoderBlock(nn.Module):
    """3 dilated residual units + strided down-conv; channels double."""

    def __init__(self, dim: int = 16, stride: int = 1, causal: bool = False):
        super().__init__()
        h = dim // 2
        self.block = nn.ModuleList([
            ResidualUnit(h, dilation=1, causal=causal),
            ResidualUnit(h, dilation=3, causal=causal),
            ResidualUnit(h, dilation=9, causal=causal),
            Snake1d(h),
            SConv1d(h, dim, 2 * stride, stride=stride, causal=causal),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.block:
            x = layer(x)
        return x


class Encoder(nn.Module):
    """Wave (B, T, 1) -> latent (B, T / hop, d_latent); hop = prod(strides)."""

    def __init__(self, d_model: int = 64, strides: Sequence[int] = (2, 4, 8, 8),
                 d_latent: int = 64, causal: bool = False, lstm: int = 2):
        super().__init__()
        d = d_model
        layers = [SConv1d(1, d, 7, causal=causal)]
        for stride in strides:
            d *= 2
            layers.append(EncoderBlock(d, stride=stride, causal=causal))
        if lstm:
            layers.append(SLSTM(d, lstm))
        layers += [Snake1d(d), SConv1d(d, d_latent, 3, causal=causal)]
        self.block = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.block:
            x = layer(x)
        return x


class DecoderBlock(nn.Module):
    """Snake -> strided transpose up-conv -> 3 dilated residual units."""

    def __init__(self, input_dim: int = 16, output_dim: int = 8, stride: int = 1,
                 causal: bool = False):
        super().__init__()
        self.block = nn.ModuleList([
            Snake1d(input_dim),
            SConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride, causal=causal),
            ResidualUnit(output_dim, dilation=1, causal=causal),
            ResidualUnit(output_dim, dilation=3, causal=causal),
            ResidualUnit(output_dim, dilation=9, causal=causal),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.block:
            x = layer(x)
        return x


class Decoder(nn.Module):
    """Latent (B, T', C) -> wave (B, T, 1), ending in tanh."""

    def __init__(self, input_channel: int, channels: int, rates: Sequence[int],
                 causal: bool = False, lstm: int = 2):
        super().__init__()
        layers = [SConv1d(input_channel, channels, 7, causal=causal)]
        if lstm:
            layers.append(SLSTM(channels, lstm))
        output_dim = channels
        for i, stride in enumerate(rates):
            input_dim = channels // 2**i
            output_dim = channels // 2 ** (i + 1)
            layers.append(DecoderBlock(input_dim, output_dim, stride, causal=causal))
        layers += [Snake1d(output_dim), SConv1d(output_dim, 1, 7, causal=causal)]
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model:
            x = layer(x)
        return torch.tanh(x)
