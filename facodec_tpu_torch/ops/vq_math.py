"""L2-normalised nearest-codebook search, the plain PyTorch version.

Port of facodec_tpu/ops/vq_math.py, the rule the JAX main path uses: both
the encodings and the codebook rows are L2-normalised, the distance is
`|e|^2 - 2 e.c + |c|^2`, the code is the first index of the least distance
(`torch.argmax` of `-dist` returns the first maximum), and the quantized
output gathers the un-normalised codebook row.
"""

from __future__ import annotations

from typing import Tuple

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps) over the last axis."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)


def code_distances(encodings: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(..., D), (N, D) -> (..., N) squared distances of the normalised rows."""
    e = l2_normalize(encodings.float())
    c = l2_normalize(codebook.float())
    e_sq = torch.sum(e * e, dim=-1, keepdim=True)
    c_sq = torch.sum(c * c, dim=-1)
    return e_sq - 2.0 * (e @ c.t()) + c_sq


def nearest_code(
    encodings: torch.Tensor, codebook: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (...,) int32, quantized (..., D)) of the nearest codes."""
    dist = code_distances(encodings, codebook)
    indices = torch.argmax(-dist, dim=-1).to(torch.int32)
    return indices, codebook[indices.long()]
