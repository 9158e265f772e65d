"""Skip-connected LSTM (port of facodec_tpu/nn/lstm.py `SLSTM`).

The JAX package writes the recurrence as a `lax.scan` with torch's gate
order and parameter names, so here `torch.nn.LSTM` (cuDNN on the card)
holds the same `weight_ih_l{k}` / `weight_hh_l{k}` / `bias_*` tensors in a
submodule named `lstm`. The one-shot call starts from a zero state; a
stream passes `(h, c)`, each (layers, B, H) as in the JAX package, and
gets the final state back.

Under the `bfloat16_act` policy the JAX package rounds both matmuls'
operands to bf16 (the input, the weights and, at every step, h) and keeps
the (h, c) carries, the gates and the output in float32; the output plus
the bf16 skip is float32. cuDNN cannot round h at each step, and a Python
loop over the 800 steps of a 10 s decode is not a route on the card. So
the port runs the float32 LSTM on the bf16-rounded input and weights
(biases stay float32): every rounding but h's. The rounded weights are a
cached copy of `lstm`, made again whenever a parameter changes; in a
program being exported (utils/export.py) they are graph ops on every call,
run through `lstm` by `torch.func.functional_call`, which still lowers to
one `aten.lstm` (cuDNN on the card).
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn as nn

from facodec_tpu_torch.ops.precision import bf16_active, bf16_values

LSTMState = Tuple[torch.Tensor, torch.Tensor]


class SLSTM(nn.Module):
    """y = LSTM(x) + x over NTC input."""

    def __init__(self, dimension: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dimension, dimension, num_layers, batch_first=True)
        self._bf16_cache: dict = {}  # plain dict: not a submodule, not in the state dict

    def _bf16_lstm(self) -> nn.LSTM:
        """`lstm` with bf16-rounded weight matrices, cached per parameter
        storage and version."""
        key = tuple((p.data_ptr(), p._version) for p in self.lstm.parameters())
        lstm = self._bf16_cache.get(key)
        if lstm is None:
            lstm = copy.deepcopy(self.lstm)
            with torch.no_grad():
                for name, p in lstm.named_parameters():
                    if name.startswith("weight"):
                        p.copy_(bf16_values(p))
            lstm.flatten_parameters()
            self._bf16_cache.clear()
            self._bf16_cache[key] = lstm
        return lstm

    def forward(self, x: torch.Tensor, state: Optional[LSTMState] = None,
                return_state: bool = False):
        if bf16_active():
            if torch.compiler.is_exporting():
                rounded = {name: bf16_values(p) if name.startswith("weight") else p
                           for name, p in self.lstm.named_parameters()}
                y, new_state = torch.func.functional_call(self.lstm, rounded,
                                                          (bf16_values(x), state))
            else:
                y, new_state = self._bf16_lstm()(bf16_values(x), state)
            y = y + x.float()
        else:
            y, new_state = self.lstm(x, state)
            y = y + x
        return (y, new_state) if return_state else y
