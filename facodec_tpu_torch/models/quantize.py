"""Factorized VQ and residual VQ, eval mode (NTC layout).

Port of facodec_tpu/models/quantize.py for serving: no losses, no quantizer
dropout. The code search goes through `ops.kernels.vq.nearest_code` (the
CUDA kernel on the card, the plain search on the CPU).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from facodec_tpu_torch.nn.basic import Embedding
from facodec_tpu_torch.nn.conv import Conv1d
from facodec_tpu_torch.ops.kernels.vq import nearest_code


class VectorQuantize(nn.Module):
    """1x1 in-proj to the code space, nearest-code search, 1x1 out-proj."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.in_proj = Conv1d(input_dim, codebook_dim, 1, weight_norm=True)
        self.out_proj = Conv1d(codebook_dim, input_dim, 1, weight_norm=True)
        self.codebook = Embedding(codebook_size, codebook_dim)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, D_in) -> (z_q (B, T, D_in), indices (B, T) int32)."""
        z_e = self.in_proj(z)
        indices, z_q = self.decode_latents(z_e)
        # the straight-through estimator's forward value, kept term for term
        # so that it rounds as the JAX package's does
        z_q = z_e + (z_q - z_e)
        return self.out_proj(z_q), indices

    def decode_code(self, embed_id: torch.Tensor) -> torch.Tensor:
        """(B, T) codes -> (B, T, codebook_dim) codebook rows."""
        return self.codebook(embed_id.long())

    def decode_latents(self, latents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return nearest_code(latents, self.codebook.weight)


class ResidualVectorQuantize(nn.Module):
    """Residual VQ; the residual is updated with each stage's output."""

    def __init__(self, input_dim: int = 512, n_codebooks: int = 9,
                 codebook_size: int = 1024, codebook_dim: int = 8):
        super().__init__()
        self.n_codebooks = n_codebooks
        self.quantizers = nn.ModuleList([
            VectorQuantize(input_dim, codebook_size, codebook_dim) for _ in range(n_codebooks)
        ])

    def forward(self, z: torch.Tensor, n_quantizers: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, D) -> (z_q (B, T, D), codes (B, n, T) int32), n the first
        `n_quantizers` stages."""
        n = min(int(n_quantizers), self.n_codebooks)
        z_q: Optional[torch.Tensor] = None
        residual = z
        codes: List[torch.Tensor] = []
        for quantizer in self.quantizers[:n]:
            z_q_i, indices = quantizer(residual)
            z_q = z_q_i if z_q is None else z_q + z_q_i
            residual = residual - z_q_i
            codes.append(indices)
        return z_q, torch.stack(codes, dim=1)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, n, T) codes -> z_q (B, T, D)."""
        z_q: Optional[torch.Tensor] = None
        for i in range(codes.shape[1]):
            part = self.quantizers[i].out_proj(self.quantizers[i].decode_code(codes[:, i]))
            z_q = part if z_q is None else z_q + part
        return z_q
