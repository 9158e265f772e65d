"""Global timbre (style) encoder with its multi-head attention, eval mode.

Port of facodec_tpu/models/style_encoder.py. One timbre vector per utterance
from an 80-bin mel: 1x1 spectral convs + Mish, two GLU conv blocks, one
self-attention layer, then masked temporal average pooling. The attention is
plain `softmax(QK^T)V`: the JAX package has no kernel for it. NTC layout;
masks are (B, T, 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from facodec_tpu_torch.nn.activations import mish
from facodec_tpu_torch.nn.conv import Conv1d


class Mish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


class MultiHeadAttention(nn.Module):
    """Conv-1x1 q/k/v attention; channels are grouped per head as
    [head0 dims, head1 dims, ...]. Masked scores are filled with -1e4."""

    def __init__(self, channels: int, out_channels: int, n_heads: int):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        H = self.n_heads
        kc = self.channels // H
        B, Tq, _ = x.shape
        Tk = c.shape[1]
        q = self.conv_q(x).reshape(B, Tq, H, kc).transpose(1, 2)
        k = self.conv_k(c).reshape(B, Tk, H, kc).transpose(1, 2)
        v = self.conv_v(c).reshape(B, Tk, H, kc).transpose(1, 2)
        scores = (q / math.sqrt(kc)) @ k.transpose(-1, -2)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        out = torch.softmax(scores, dim=-1) @ v
        return self.conv_o(out.transpose(1, 2).reshape(B, Tq, self.channels))


class Conv1dGLU(nn.Module):
    """Conv1d (zero padding 2) + gated linear unit + residual."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.out_channels = out_channels
        self.conv1 = Conv1d(in_channels, 2 * out_channels, kernel_size, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        return x + h[..., :self.out_channels] * torch.sigmoid(h[..., self.out_channels:])


class StyleEncoder(nn.Module):
    """mel (B, T, in_dim) + mask (B, T, 1) -> timbre vector (B, out_dim)."""

    def __init__(self, in_dim: int = 513, hidden_dim: int = 128, out_dim: int = 256,
                 kernel_size: int = 5, n_head: int = 2):
        super().__init__()
        # the indices of the torch reference's Sequential, dropout as Identity
        self.spectral = nn.ModuleList([
            Conv1d(in_dim, hidden_dim, 1), Mish(), nn.Identity(),
            Conv1d(hidden_dim, hidden_dim, 1), Mish(), nn.Identity(),
        ])
        self.temporal = nn.ModuleList([
            Conv1dGLU(hidden_dim, hidden_dim, kernel_size),
            Conv1dGLU(hidden_dim, hidden_dim, kernel_size),
        ])
        self.slf_attn = MultiHeadAttention(hidden_dim, hidden_dim, n_head)
        self.fc = Conv1d(hidden_dim, out_dim, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = torch.ones(x.shape[0], x.shape[1], 1, dtype=x.dtype, device=x.device)
        for layer in self.spectral:
            x = layer(x)
        x = x * mask
        # the mask is applied once after both GLU blocks, as in the reference
        x = self.temporal[1](self.temporal[0](x)) * mask
        m = mask[:, :, 0]
        attn_mask = m[:, None, :, None] * m[:, None, None, :]
        x = x + self.slf_attn(x, x, attn_mask=attn_mask)
        x = self.fc(x)
        # the reference sums x unmasked and divides by the masked length
        return torch.sum(x, dim=1) / torch.sum(mask, dim=1)
