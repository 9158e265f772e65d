"""Skip-connected LSTM (port of facodec_tpu/nn/lstm.py `SLSTM`).

The JAX package writes the recurrence as a `lax.scan` with torch's gate
order and parameter names, so here `torch.nn.LSTM` (cuDNN on the card)
holds the same `weight_ih_l{k}` / `weight_hh_l{k}` / `bias_*` tensors in a
submodule named `lstm`. One-shot only: zero initial state.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class SLSTM(nn.Module):
    """y = LSTM(x) + x over NTC input."""

    def __init__(self, dimension: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dimension, dimension, num_layers, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x)
        return y + x
