"""Linear / Embedding / LayerNorm in torch parameter layout.

Port of facodec_tpu/nn/basic.py, whose flax modules reproduce torch's: here
torch's own modules are the counterparts, with the parameter names and shapes
the JAX tree mirrors (`weight` (out, in), `bias`; LayerNorm eps 1e-5, and
`elementwise_affine=False` for the timbre norm). `Linear` follows the
precision policy (ops/precision.py) as the JAX one does: under
`bfloat16_act` its operands are rounded to bf16 and it accumulates and
returns float32, with the bias added in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from facodec_tpu_torch.ops.precision import bf16_active, bf16_values

Embedding = nn.Embedding
LayerNorm = nn.LayerNorm


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not bf16_active():
            return super().forward(x)
        y = F.linear(bf16_values(x), bf16_values(self.weight))
        return y if self.bias is None else y + self.bias
