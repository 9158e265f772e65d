"""The factorized quantizer, timbre-norm variant, eval mode.

Port of facodec_tpu/models/fa_quantizer.py `FAquantizer` for serving:
`preprocess`, `_prosody_features`, `forward_v2` (eval, with codes),
`_timbre_condition`, `decode_streams_v2` (any non-empty subset of the
streams; all three is JAX's `decode_from_codes_v2`) and the frame-synchronous
`encode_streaming`. The legacy 4-stream
`forward_v1`, training-mode masking and the predictor heads are not ported.
Layout: latents (B, T, C), waves (B, Tw), mels (B, Tf, n_mels).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from facodec_tpu_torch.models.quantize import ResidualVectorQuantize
from facodec_tpu_torch.models.style_encoder import StyleEncoder
from facodec_tpu_torch.models.wavenet import WN
from facodec_tpu_torch.nn.basic import LayerNorm, Linear
from facodec_tpu_torch.nn.conv import SConv1d
from facodec_tpu_torch.ops.spectral import LogMelSpectrogram


class FAquantizer(nn.Module):
    """Prosody / content / residual RVQ streams plus a global timbre vector
    injected as LayerNorm * gamma + beta."""

    def __init__(self, in_dim: int = 1024, n_p_codebooks: int = 1, n_c_codebooks: int = 2,
                 n_t_codebooks: int = 2, n_r_codebooks: int = 3, codebook_size: int = 1024,
                 codebook_dim: int = 8, quantizer_dropout: float = 0.5, causal: bool = False,
                 separate_prosody_encoder: bool = False, timbre_norm: bool = False,
                 sample_rate: int = 24000, hop_length: int = 300,
                 style_hidden_dim: int = 512, prosody_hidden_dim: int = 256):
        super().__init__()
        # n_t_codebooks and quantizer_dropout belong to forward_v1 and to
        # training; they are accepted so the JAX module's fields build this one
        if not (timbre_norm and separate_prosody_encoder):
            raise NotImplementedError(
                "only the timbre_norm model with a separate prosody encoder is ported")
        self.in_dim, self.sample_rate, self.hop_length = in_dim, sample_rate, hop_length
        self.codebook_size = codebook_size

        def rvq(n):
            return ResidualVectorQuantize(in_dim, n, codebook_size, codebook_dim)

        self.prosody_quantizer = rvq(n_p_codebooks)
        self.content_quantizer = rvq(n_c_codebooks)
        self.residual_quantizer = rvq(n_r_codebooks)
        self.timbre_encoder = StyleEncoder(in_dim=80, hidden_dim=style_hidden_dim, out_dim=in_dim)
        self.timbre_linear = Linear(in_dim, 2 * in_dim)
        self.timbre_norm = LayerNorm(in_dim, elementwise_affine=False)
        h = prosody_hidden_dim
        self.melspec_linear = SConv1d(20, h, 1, causal=causal, norm="none")
        self.melspec_encoder = WN(h, kernel_size=5, dilation_rate=1, n_layers=8, causal=causal)
        self.melspec_linear2 = SConv1d(h, in_dim, 1, causal=causal, norm="none")
        self.mel = LogMelSpectrogram(sample_rate=sample_rate, hop_length=hop_length)

    def preprocess(self, wave: torch.Tensor, n_bins: int = 80) -> torch.Tensor:
        """(B, Tw) -> (B, Tw // hop, n_bins) normalised log-mel. Fewer bins
        are the first bins of the 80-band mel, not a narrower filterbank."""
        n_frames = wave.shape[-1] // self.hop_length
        return self.mel(wave)[:, :n_frames, :n_bins]

    def _prosody_features(self, mel20: torch.Tensor) -> torch.Tensor:
        """20-bin mel -> 1x1 -> WN(8) -> 1x1 -> in_dim."""
        return self.melspec_linear2(self.melspec_encoder(self.melspec_linear(mel20)))

    def _timbre_condition(self, outs: torch.Tensor, timbre: torch.Tensor) -> torch.Tensor:
        gamma, beta = torch.chunk(self.timbre_linear(timbre), 2, dim=-1)
        return self.timbre_norm(outs) * gamma[:, None, :] + beta[:, None, :]

    def forward_v2(self, x: torch.Tensor, wave_segments: torch.Tensor, n_c: int = 1,
                   full_waves: Optional[torch.Tensor] = None,
                   wave_lens: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
        """x: encoder latent (B, T, in_dim); wave_segments (B, Tw).
        Returns (outs, [codes_p, codes_c, codes_r], timbre). Given
        `full_waves` (B, Tf) and their true lengths `wave_lens` (B,) in
        samples, the timbre pools the mel of `full_waves` over each row's
        first wave_lens // hop frames only: the masked timbre of a batch
        zero-padded to a length bucket."""
        mel = self.preprocess(wave_segments, n_bins=80)
        if full_waves is None:
            timbre = self.timbre_encoder(mel)
        else:
            mel_full = mel if full_waves is wave_segments else self.preprocess(full_waves)
            frames = torch.arange(mel_full.shape[1], device=mel_full.device)
            mask = frames[None, :] < (wave_lens.to(mel_full.device) // self.hop_length)[:, None]
            timbre = self.timbre_encoder(mel_full, mask[:, :, None].to(mel_full.dtype))

        f0_input = self._prosody_features(mel[..., :20])
        common_min_size = min(f0_input.shape[1], x.shape[1])
        f0_input = f0_input[:, :common_min_size]
        x = x[:, :common_min_size]

        z_p, codes_p = self.prosody_quantizer(f0_input, 1)
        z_c, codes_c = self.content_quantizer(x, n_c)
        z_r, codes_r = self.residual_quantizer(x - z_p - z_c, 3)
        outs = self._timbre_condition(z_p + z_c + z_r, timbre)
        return outs, [codes_p, codes_c, codes_r], timbre

    def encode_streaming(self, x: torch.Tensor, mel20: torch.Tensor, timbre: torch.Tensor,
                         wn_stream, n_c: int = 1, first: bool = False):
        """One chunk, frame-synchronous, with a fixed stream timbre. x: the
        encoder latent (B, T, in_dim); mel20 (B, T, 20) the aligned log-mel;
        timbre (B, in_dim); wn_stream the prosody WN's carries. Equals
        forward_v2 frame by frame. Returns (outs, [codes_p, codes_c,
        codes_r], new_wn_stream)."""
        f0_input, new_wn = self.melspec_encoder(self.melspec_linear(mel20), stream=wn_stream,
                                                first=first)
        f0_input = self.melspec_linear2(f0_input)
        z_p, codes_p = self.prosody_quantizer(f0_input, 1)
        z_c, codes_c = self.content_quantizer(x, n_c)
        z_r, codes_r = self.residual_quantizer(x - z_p - z_c, 3)
        outs = self._timbre_condition(z_p + z_c + z_r, timbre)
        return outs, [codes_p, codes_c, codes_r], new_wn

    def decode_streams_v2(self, codes_p: torch.Tensor, codes_c: torch.Tensor,
                          codes_r: Optional[torch.Tensor], timbre: torch.Tensor,
                          use_p: bool = True, use_c: bool = True, use_r: bool = True
                          ) -> torch.Tensor:
        """(B, n, T) code streams + timbre -> decoder-ready latent from the
        selected streams; codes_r=None drops the residual stream."""
        parts = []
        if use_p:
            parts.append(self.prosody_quantizer.from_codes(codes_p))
        if use_c:
            parts.append(self.content_quantizer.from_codes(codes_c))
        if use_r and codes_r is not None:
            parts.append(self.residual_quantizer.from_codes(codes_r))
        if not parts:
            raise ValueError("decode_streams_v2: at least one stream must be selected")
        outs = parts[0]
        for p in parts[1:]:
            outs = outs + p
        return self._timbre_condition(outs, timbre)
