"""Linear / Embedding / LayerNorm in torch parameter layout.

Port of facodec_tpu/nn/basic.py, whose flax modules reproduce torch's: here
torch's own modules are the counterparts, with the parameter names and shapes
the JAX tree mirrors (`weight` (out, in), `bias`; LayerNorm eps 1e-5, and
`elementwise_affine=False` for the timbre norm).
"""

from __future__ import annotations

import torch.nn as nn

Linear = nn.Linear
Embedding = nn.Embedding
LayerNorm = nn.LayerNorm
