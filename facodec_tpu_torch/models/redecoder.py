"""Redecoder: resynthesis from prosody codes, content codes and a timbre
vector; swapping the timbre vector converts the voice (zero-shot).

Port of facodec_tpu/models/redecoder.py `Redecoder` and
`redecoder_stream_state` (the 'wavenet' encoder of the reference). NTC
layout. With `train=True` the WN's gated activations go through dropout at
`p_dropout` (0.2, the JAX default), drawn from the caller's generator;
in eval, as `convert_voice` and streaming run it, there is no draw. Its output latent feeds a DAC `Decoder`
(models/dac.py), whose residual units run the fused residual-unit kernel on
the card.

Streaming (causal only): the code embeddings and conv_out are frame-local,
and `stream` carries the WN in_layers' conv left contexts; the call then
returns `(latent, new_stream)`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from facodec_tpu_torch.models.wavenet import WN, wn_stream_state
from facodec_tpu_torch.nn.basic import Embedding
from facodec_tpu_torch.nn.conv import Conv1d


class Redecoder(nn.Module):
    """Prosody and content code embeddings -> WN (k = 5, conditioned on the
    timbre) -> 1x1 conv to the latent the DAC decoder consumes."""

    def __init__(self, n_p_codebooks: int = 1, n_c_codebooks: int = 2,
                 codebook_size: int = 1024, embed_dim: int = 512, n_layers: int = 16,
                 causal: bool = False, gin_channels: int = 1024, out_dim: int = 1024,
                 p_dropout: float = 0.2):
        super().__init__()
        self.embed_dim, self.codebook_size, self.causal = embed_dim, codebook_size, causal
        self.encoder = WN(embed_dim, kernel_size=5, dilation_rate=1, n_layers=n_layers,
                          gin_channels=gin_channels, causal=causal, p_dropout=p_dropout)
        self.conv_out = Conv1d(embed_dim, out_dim, 1)
        self.prosody_embed = nn.ModuleList([
            Embedding(codebook_size, embed_dim) for _ in range(n_p_codebooks)])
        self.content_embed = nn.ModuleList([
            Embedding(codebook_size, embed_dim) for _ in range(n_c_codebooks)])

    def forward(self, p_code: torch.Tensor, c_code: torch.Tensor, timbre: torch.Tensor,
                use_p_code: bool = True, use_c_code: bool = True, n_c: int = 2,
                stream=None, first: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """p_code (B, n_p, T), c_code (B, n_c, T) integer codes; timbre (B, gin).
        Returns the latent (B, T, out_dim)."""
        B, _, T = p_code.shape
        x = torch.zeros(B, T, self.embed_dim, device=timbre.device, dtype=timbre.dtype)
        if use_p_code:
            for i, embed in enumerate(self.prosody_embed):
                x = x + embed(p_code[:, i].long())
        if use_c_code:
            for i in range(n_c):
                x = x + self.content_embed[i](c_code[:, i].long())
        if stream is not None:
            x, new_stream = self.encoder(x, g=timbre[:, None, :], stream=stream, first=first)
            return self.conv_out(x), new_stream
        x = self.encoder(x, g=timbre[:, None, :], train=train, generator=generator)
        return self.conv_out(x)


def redecoder_stream_state(red: Redecoder, batch: int) -> dict:
    """Zero left-context carries for the redecoder's WN (k=5, dilation 1)."""
    return wn_stream_state(red.encoder, batch)
