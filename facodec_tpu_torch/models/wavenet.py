"""WaveNet stack with the gated tanh/sigmoid unit and optional global
conditioning (port of facodec_tpu/models/wavenet.py `WN` and
`wn_stream_state`). NTC layout. Every caller passes an all-ones mask, a
no-op that is left out here. With `train=True` the gated activations go
through dropout at `p_dropout`, drawn from the caller's generator; in eval
there is no draw.

Streaming (causal only): `stream` carries each in_layer's conv left context
under the JAX names (`in_layers_{i}`); the call then returns
`(out, new_stream)`. A stream passed in is consumed."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from facodec_tpu_torch.nn.basic import dropout
from facodec_tpu_torch.nn.conv import SConv1d


class WN(nn.Module):
    """n_layers of dilated conv -> gate -> 1x1 residual/skip split. The last
    layer's res_skip conv has only the H skip channels. With gin_channels > 0
    a weight-normed 1x1 `cond_layer` maps g (B, 1, gin) to 2H channels per
    layer, added before each layer's gate."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, causal: bool = False,
                 p_dropout: float = 0.0):
        super().__init__()
        H = self.hidden_channels = hidden_channels
        self.p_dropout = p_dropout
        self.kernel_size, self.dilation_rate, self.n_layers = kernel_size, dilation_rate, n_layers
        if gin_channels:
            self.cond_layer = SConv1d(gin_channels, 2 * H * n_layers, 1)
        self.in_layers = nn.ModuleList([
            SConv1d(H, 2 * H, kernel_size, dilation=dilation_rate**i, causal=causal)
            for i in range(n_layers)
        ])
        self.res_skip_layers = nn.ModuleList([
            SConv1d(H, 2 * H if i < n_layers - 1 else H, 1, causal=causal)
            for i in range(n_layers)
        ])

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None, stream=None,
                first: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (B, T, H); g (B, 1, gin) or None."""
        H = self.hidden_channels
        output = torch.zeros_like(x)
        new_stream = {}
        if g is not None:
            g = self.cond_layer(g)
        for i in range(self.n_layers):
            if stream is not None:
                key = f"in_layers_{i}"
                x_in, new_stream[key] = self.in_layers[i](x, stream[key], first)
            else:
                x_in = self.in_layers[i](x)
            if g is not None:
                x_in = x_in + g[..., 2 * H * i : 2 * H * (i + 1)]
            acts = torch.tanh(x_in[..., :H]) * torch.sigmoid(x_in[..., H:])
            acts = dropout(acts, self.p_dropout, train, generator)
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = x + res_skip[..., :H]
                output = output + res_skip[..., H:]
            else:
                output = output + res_skip
        if stream is not None:
            return output, new_stream
        return output


def wn_stream_state(wn: WN, batch: int) -> dict:
    """Zero left-context carries for every in_layer (causal streaming)."""
    p = next(wn.parameters())
    return {
        f"in_layers_{i}": torch.zeros(batch, (wn.kernel_size - 1) * wn.dilation_rate**i,
                                      wn.hidden_channels, dtype=p.dtype, device=p.device)
        for i in range(wn.n_layers)
    }
