"""Skip-connected LSTM (port of facodec_tpu/nn/lstm.py `SLSTM`).

The JAX package writes the recurrence as a `lax.scan` with torch's gate
order and parameter names, so here `torch.nn.LSTM` (cuDNN on the card)
holds the same `weight_ih_l{k}` / `weight_hh_l{k}` / `bias_*` tensors in a
submodule named `lstm`. The one-shot call starts from a zero state; a
stream passes `(h, c)`, each (layers, B, H) as in the JAX package, and
gets the final state back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

LSTMState = Tuple[torch.Tensor, torch.Tensor]


class SLSTM(nn.Module):
    """y = LSTM(x) + x over NTC input."""

    def __init__(self, dimension: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dimension, dimension, num_layers, batch_first=True)

    def forward(self, x: torch.Tensor, state: Optional[LSTMState] = None,
                return_state: bool = False):
        y, new_state = self.lstm(x, state)
        y = y + x
        return (y, new_state) if return_state else y
