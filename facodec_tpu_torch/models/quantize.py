"""Factorized VQ and residual VQ (NTC layout).

Port of facodec_tpu/models/quantize.py. `forward` serves: the first
`n_quantizers` stages, codes and the summed output. `forward_train` is the
JAX module's train mode: every stage runs, each returns its per-sample
commitment and codebook losses, the output is straight-through, and the
first `int(B * quantizer_dropout)` rows keep only their first 1..N stages
(drawn from the caller's generator) while the residual is updated with each
stage's unmasked output. `forward_losses` is its eval call with the
losses (the legacy `forward_v1` reads them in eval too). The code search
goes through
`ops.kernels.vq.nearest_code` (the CUDA kernel on the card, the plain search
on the CPU); its gradient reaches the codebook rows it selected.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from facodec_tpu_torch.nn.basic import Embedding
from facodec_tpu_torch.nn.conv import Conv1d
from facodec_tpu_torch.ops.kernels.vq import nearest_code
from facodec_tpu_torch.parallel.mesh import global_rows


class VectorQuantize(nn.Module):
    """1x1 in-proj to the code space, nearest-code search, 1x1 out-proj."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        # exact: the projections stay float32 under every precision policy,
        # so the code search is a float32 island
        self.in_proj = Conv1d(input_dim, codebook_dim, 1, weight_norm=True, exact=True)
        self.out_proj = Conv1d(codebook_dim, input_dim, 1, weight_norm=True, exact=True)
        self.codebook = Embedding(codebook_size, codebook_dim)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, D_in) -> (z_q (B, T, D_in), indices (B, T) int32)."""
        z_e = self.in_proj(z)
        indices, z_q = self.decode_latents(z_e)
        # the straight-through estimator's forward value, kept term for term
        # so that it rounds as the JAX package's does
        z_q = z_e + (z_q - z_e)
        return self.out_proj(z_q), indices

    def forward_train(self, z: torch.Tensor):
        """(B, T, D_in) -> (z_q (B, T, D_in), commitment (B,), codebook (B,),
        indices (B, T)): the losses are per-sample means; z_q passes the
        gradient to z_e straight through, and the codebook loss reaches the
        codebook."""
        z_e = self.in_proj(z)
        indices, z_q = self.decode_latents(z_e)
        commitment = torch.mean(torch.square(z_e - z_q.detach()), dim=(1, 2))
        codebook = torch.mean(torch.square(z_q - z_e.detach()), dim=(1, 2))
        z_q = z_e + (z_q - z_e).detach()
        return self.out_proj(z_q), commitment, codebook, indices

    def decode_code(self, embed_id: torch.Tensor) -> torch.Tensor:
        """(B, T) codes -> (B, T, codebook_dim) codebook rows."""
        return self.codebook(embed_id.long())

    def decode_latents(self, latents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return nearest_code(latents, self.codebook.weight)


class ResidualVectorQuantize(nn.Module):
    """Residual VQ; the residual is updated with each stage's output."""

    def __init__(self, input_dim: int = 512, n_codebooks: int = 9,
                 codebook_size: int = 1024, codebook_dim: int = 8,
                 quantizer_dropout: float = 0.0):
        super().__init__()
        self.n_codebooks, self.quantizer_dropout = n_codebooks, quantizer_dropout
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

    def forward_train(self, z: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(B, T, D) -> (z_q, codes (B, N, T), commitment, codebook): all N
        stages; row b sums the stages i < nq[b], where nq is N + 1 except for
        the first int(B * quantizer_dropout) rows, which draw it from 1..N.
        The losses are the batch means of each stage's masked per-sample
        losses, summed over the stages."""
        B, N = z.shape[0], self.n_codebooks
        # the dropped rows are the global batch's first ones (a data-parallel
        # rank's share of them is cut from the global draw)
        total, offset = global_rows(B)
        nq = torch.full((total,), float(N + 1), device=z.device)
        n_dropout = int(total * self.quantizer_dropout)
        if n_dropout > 0:
            if generator is None:
                raise ValueError("quantizer dropout draws from a torch.Generator; pass one")
            nq[:n_dropout] = torch.randint(1, N + 1, (n_dropout,), generator=generator,
                                           device=z.device).float()
        return self._stages(z, nq[offset: offset + B], N)

    def forward_losses(self, z: torch.Tensor, n_quantizers: int):
        """The JAX module's eval call with its losses: (z_q, codes (B, n, T),
        commitment, codebook) of the first n = min(n_quantizers, N) stages,
        every row keeping all of them (no draw)."""
        n = min(int(n_quantizers), self.n_codebooks)
        return self._stages(z, torch.full((z.shape[0],), float(n_quantizers), device=z.device), n)

    def _stages(self, z: torch.Tensor, nq: torch.Tensor, n: int):
        """The first n stages, row b summing the stages i < nq[b]."""
        z_q = torch.zeros_like(z)
        residual = z
        commitment = codebook = 0.0
        codes: List[torch.Tensor] = []
        for i, quantizer in enumerate(self.quantizers[:n]):
            z_q_i, commit_i, cb_i, indices = quantizer.forward_train(residual)
            mask = (i < nq).to(z.dtype)
            z_q = z_q + z_q_i * mask[:, None, None]
            residual = residual - z_q_i
            commitment = commitment + torch.mean(commit_i * mask)
            codebook = codebook + torch.mean(cb_i * mask)
            codes.append(indices)
        return z_q, torch.stack(codes, dim=1), commitment, codebook

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, n, T) codes -> z_q (B, T, D)."""
        z_q: Optional[torch.Tensor] = None
        for i in range(codes.shape[1]):
            part = self.quantizers[i].out_proj(self.quantizers[i].decode_code(codes[:, i]))
            z_q = part if z_q is None else z_q + part
        return z_q
