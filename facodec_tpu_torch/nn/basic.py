"""Linear / Embedding / LayerNorm in torch parameter layout.

Port of facodec_tpu/nn/basic.py, whose flax modules reproduce torch's: here
torch's own modules are the counterparts, with the parameter names and shapes
the JAX tree mirrors (`weight` (out, in), `bias`; LayerNorm eps 1e-5, and
`elementwise_affine=False` for the timbre norm). `Linear` follows the
precision policy (ops/precision.py) as the JAX one does: under
`bfloat16`, `bfloat16_act` and `int8` its operands are rounded to bf16 and
it accumulates and returns float32, with the bias added in float32.

`dropout` is flax's `nn.Dropout` in train mode, drawn from an explicit
torch.Generator on the tensor's device; inside a data-parallel step's row
shard (parallel/mesh.py) the mask is drawn at the global batch's shape and
cut to the rank's rows.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from facodec_tpu_torch.ops.precision import bf16_values, compute_dtype
from facodec_tpu_torch.parallel.mesh import rand_rows

from typing import Optional

Embedding = nn.Embedding
LayerNorm = nn.LayerNorm


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if compute_dtype() != torch.bfloat16:
            return super().forward(x)
        y = F.linear(bf16_values(x), bf16_values(self.weight))
        return y if self.bias is None else y + self.bias


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """x in eval or at p = 0; in train mode each element is kept with
    probability 1 - p and scaled by 1 / (1 - p), else zeroed."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws from a torch.Generator; pass one")
    keep = rand_rows(x.shape, generator, x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
