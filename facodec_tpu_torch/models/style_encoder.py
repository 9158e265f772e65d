"""Global timbre (style) encoder with its multi-head attention.

Port of facodec_tpu/models/style_encoder.py. One timbre vector per utterance
from an 80-bin mel: 1x1 spectral convs + Mish, two GLU conv blocks, one
self-attention layer, then masked temporal average pooling. The attention is
plain `softmax(QK^T)V`: the JAX package has no kernel for it. Under the
`bfloat16_act` policy its two products take bf16-rounded operands and
accumulate in float32, as the JAX package's do. NTC layout; masks are
(B, T, 1). With `train=True` the JAX package's five dropouts (after each
spectral Mish, in each GLU block, on the attention weights and on the
attention's output) draw from the caller's generator at `dropout`; in eval
there is no draw.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from facodec_tpu_torch.nn.activations import mish
from facodec_tpu_torch.nn.basic import dropout
from facodec_tpu_torch.nn.conv import Conv1d
from facodec_tpu_torch.ops.precision import bf16_values, compute_dtype


class Mish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


class MultiHeadAttention(nn.Module):
    """Conv-1x1 q/k/v attention; channels are grouped per head as
    [head0 dims, head1 dims, ...]. Masked scores are filled with -1e4."""

    def __init__(self, channels: int, out_channels: int, n_heads: int, p_dropout: float = 0.0):
        super().__init__()
        self.channels, self.n_heads, self.p_dropout = channels, n_heads, p_dropout
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        H = self.n_heads
        kc = self.channels // H
        B, Tq, _ = x.shape
        Tk = c.shape[1]
        q = self.conv_q(x).reshape(B, Tq, H, kc).transpose(1, 2)
        k = self.conv_k(c).reshape(B, Tk, H, kc).transpose(1, 2)
        v = self.conv_v(c).reshape(B, Tk, H, kc).transpose(1, 2)
        q = q / math.sqrt(kc)
        bf16 = compute_dtype() == torch.bfloat16
        if bf16:
            q, k, v = bf16_values(q), bf16_values(k), bf16_values(v)
        scores = q @ k.transpose(-1, -2)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = dropout(torch.softmax(scores, dim=-1), self.p_dropout, train, generator)
        out = (bf16_values(p_attn) if bf16 else p_attn) @ v
        return self.conv_o(out.transpose(1, 2).reshape(B, Tq, self.channels))


class Conv1dGLU(nn.Module):
    """Conv1d (zero padding 2) + gated linear unit + residual."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.out_channels, self.p_dropout = out_channels, p_dropout
        self.conv1 = Conv1d(in_channels, 2 * out_channels, kernel_size, padding=2)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv1(x)
        y = h[..., :self.out_channels] * torch.sigmoid(h[..., self.out_channels:])
        return x + dropout(y, self.p_dropout, train, generator)


class StyleEncoder(nn.Module):
    """mel (B, T, in_dim) + mask (B, T, 1) -> timbre vector (B, out_dim)."""

    def __init__(self, in_dim: int = 513, hidden_dim: int = 128, out_dim: int = 256,
                 kernel_size: int = 5, n_head: int = 2, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        # the indices of the torch reference's Sequential (its dropouts at 2
        # and 5 hold no parameters)
        self.spectral = nn.ModuleList([
            Conv1d(in_dim, hidden_dim, 1), Mish(), nn.Identity(),
            Conv1d(hidden_dim, hidden_dim, 1), Mish(), nn.Identity(),
        ])
        self.temporal = nn.ModuleList([
            Conv1dGLU(hidden_dim, hidden_dim, kernel_size, dropout),
            Conv1dGLU(hidden_dim, hidden_dim, kernel_size, dropout),
        ])
        self.slf_attn = MultiHeadAttention(hidden_dim, hidden_dim, n_head, dropout)
        self.fc = Conv1d(hidden_dim, out_dim, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if mask is None:
            mask = torch.ones(x.shape[0], x.shape[1], 1, dtype=x.dtype, device=x.device)
        p = self.dropout
        x = dropout(mish(self.spectral[0](x)), p, train, generator)
        x = dropout(mish(self.spectral[3](x)), p, train, generator) * mask
        # the mask is applied once after both GLU blocks, as in the reference
        x = self.temporal[0](x, train, generator)
        x = self.temporal[1](x, train, generator) * mask
        m = mask[:, :, 0]
        attn_mask = m[:, None, :, None] * m[:, None, None, :]
        y = self.slf_attn(x, x, attn_mask=attn_mask, train=train, generator=generator)
        x = x + dropout(y, p, train, generator)
        x = self.fc(x)
        # the reference sums x unmasked and divides by the masked length
        return torch.sum(x, dim=1) / torch.sum(mask, dim=1)
