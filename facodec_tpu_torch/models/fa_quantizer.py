"""The factorized quantizer and its predictor heads.

Port of facodec_tpu/models/fa_quantizer.py:
- `FAquantizer`: `preprocess`, `_prosody_features`, `forward_v2` (the
  timbre-norm model: eval with codes; with `train=True` the JAX module's
  train mode), `_timbre_condition`, `decode_streams_v2` (any non-empty
  subset of the streams; all three is JAX's `decode_from_codes_v2`), the
  frame-synchronous `encode_streaming`, and the legacy 4-stream model
  (`timbre_norm=False`): `forward_v1` (prosody, content, timbre and
  residual RVQs, with its noise flags), `encode` and `decode` of stacked
  [c, p, t0, t1] codes. `forward` dispatches on `timbre_norm`, as the JAX
  module's `__call__` does. Without a separate prosody encoder
  (`separate_prosody_encoder=False`) the prosody RVQ quantizes the latent
  itself, in both forwards.
- `ResidualUnitAF`, `CNNLSTM` and `FApredictors` (`forward_v2`, the
  timbre-norm heads, and `forward_v1`, the 4-stream heads with a global
  `CNNLSTM` timbre predictor; each with its gradient-reversal branches).

No entry point reaches the legacy model, as in the JAX package: its API
and its training step call `forward_v2` (`return_codes=`, `full_waves=`).

Train mode draws from the caller's torch.Generator: the dropouts of the
prosody WN (0.2) and of the style encoder (0.1), the RVQs' quantizer
dropout, and the residual stream's keep mask (kept with probability
1 - prob_random_mask_residual per row). Inside a data-parallel step's row
shard (parallel/mesh.py) each is drawn for the global batch and cut to the
rank's rows.
Layout: latents (B, T, C), waves (B, Tw), mels (B, Tf, n_mels).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from facodec_tpu_torch.models.quantize import ResidualVectorQuantize
from facodec_tpu_torch.models.style_encoder import StyleEncoder
from facodec_tpu_torch.models.wavenet import WN
from facodec_tpu_torch.nn.alias_free import Activation1d
from facodec_tpu_torch.nn.basic import LayerNorm, Linear
from facodec_tpu_torch.nn.conv import Conv1d, SConv1d
from facodec_tpu_torch.ops.gradrev import GradientReversal
from facodec_tpu_torch.ops.spectral import LogMelSpectrogram
from facodec_tpu_torch.parallel.mesh import rand_rows


class FAquantizer(nn.Module):
    """Prosody / content / residual RVQ streams plus a global timbre vector
    injected as LayerNorm * gamma + beta (`timbre_norm=True`), or prosody /
    content / timbre / residual RVQ streams (`timbre_norm=False`)."""

    def __init__(self, in_dim: int = 1024, n_p_codebooks: int = 1, n_c_codebooks: int = 2,
                 n_t_codebooks: int = 2, n_r_codebooks: int = 3, codebook_size: int = 1024,
                 codebook_dim: int = 8, quantizer_dropout: float = 0.5, causal: bool = False,
                 separate_prosody_encoder: bool = False, timbre_norm: bool = False,
                 sample_rate: int = 24000, hop_length: int = 300,
                 style_hidden_dim: int = 512, prosody_hidden_dim: int = 256,
                 prob_random_mask_residual: float = 0.75):
        super().__init__()
        self.in_dim, self.sample_rate, self.hop_length = in_dim, sample_rate, hop_length
        self.codebook_size = codebook_size
        self.prob_random_mask_residual = prob_random_mask_residual
        # `timbre_norm` names the LayerNorm submodule (the torch key), so the
        # flags are kept under these names
        self.v2, self.separate_prosody = timbre_norm, separate_prosody_encoder

        def rvq(n):
            return ResidualVectorQuantize(in_dim, n, codebook_size, codebook_dim,
                                          quantizer_dropout)

        self.prosody_quantizer = rvq(n_p_codebooks)
        self.content_quantizer = rvq(n_c_codebooks)
        self.residual_quantizer = rvq(n_r_codebooks)
        if timbre_norm:
            self.timbre_encoder = StyleEncoder(in_dim=80, hidden_dim=style_hidden_dim,
                                               out_dim=in_dim)
            self.timbre_linear = Linear(in_dim, 2 * in_dim)
            self.timbre_norm = LayerNorm(in_dim, elementwise_affine=False)
        else:
            self.timbre_quantizer = rvq(n_t_codebooks)
        if separate_prosody_encoder:
            h = prosody_hidden_dim
            self.melspec_linear = SConv1d(20, h, 1, causal=causal, norm="none")
            self.melspec_encoder = WN(h, kernel_size=5, dilation_rate=1, n_layers=8,
                                      causal=causal, p_dropout=0.2)
            self.melspec_linear2 = SConv1d(h, in_dim, 1, causal=causal, norm="none")
        self.mel = LogMelSpectrogram(sample_rate=sample_rate, hop_length=hop_length)

    def preprocess(self, wave: torch.Tensor, n_bins: int = 80) -> torch.Tensor:
        """(B, Tw) -> (B, Tw // hop, n_bins) normalised log-mel. Fewer bins
        are the first bins of the 80-band mel, not a narrower filterbank."""
        n_frames = wave.shape[-1] // self.hop_length
        return self.mel(wave)[:, :n_frames, :n_bins]

    def _prosody_features(self, mel20: torch.Tensor, train: bool = False,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """20-bin mel -> 1x1 -> WN(8) -> 1x1 -> in_dim."""
        h = self.melspec_encoder(self.melspec_linear(mel20), train=train, generator=generator)
        return self.melspec_linear2(h)

    def _prosody_input(self, x: torch.Tensor, wave_segments: torch.Tensor, train: bool,
                       generator: Optional[torch.Generator], mel: Optional[torch.Tensor] = None):
        """(prosody RVQ input, x): the separate prosody encoder's features on
        the segments' 20-bin mel, with both cut to their common length, or
        the latent itself without a separate encoder."""
        if not self.separate_prosody:
            return x, x
        if mel is None:
            mel = self.preprocess(wave_segments, n_bins=20)
        f0_input = self._prosody_features(mel[..., :20], train, generator)
        common_min_size = min(f0_input.shape[1], x.shape[1])
        return f0_input[:, :common_min_size], x[:, :common_min_size]

    def _need_v2(self, who: str) -> None:
        if not self.v2:
            raise ValueError(f"FAquantizer.{who} runs the timbre-norm model; this one has "
                             "timbre_norm=False (forward_v1, encode, decode)")

    def forward(self, x: torch.Tensor, wave_segments: torch.Tensor, **kwargs):
        """`forward_v2` for the timbre-norm model, `forward_v1` otherwise."""
        if self.v2:
            return self.forward_v2(x, wave_segments, **kwargs)
        return self.forward_v1(x, wave_segments, **kwargs)

    def _timbre_condition(self, outs: torch.Tensor, timbre: torch.Tensor) -> torch.Tensor:
        gamma, beta = torch.chunk(self.timbre_linear(timbre), 2, dim=-1)
        return self.timbre_norm(outs) * gamma[:, None, :] + beta[:, None, :]

    def forward_v2(self, x: torch.Tensor, wave_segments: torch.Tensor, n_c: int = 1,
                   full_waves: Optional[torch.Tensor] = None,
                   wave_lens: Optional[torch.Tensor] = None, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   return_quantized: bool = False):
        """x: encoder latent (B, T, in_dim); wave_segments (B, Tw).
        Returns (outs, [codes_p, codes_c, codes_r], timbre), and in eval
        with `return_quantized` the streams [z_p, z_c, z_r] fourth. Given
        `full_waves` (B, Tf) and their true lengths `wave_lens` (B,) in
        samples, the timbre pools the mel of `full_waves` over each row's
        first wave_lens // hop frames only: the masked timbre of a batch
        zero-padded to a length bucket.

        With `train=True` (draws from `generator`) every stage of every RVQ
        runs and it returns (outs, [z_p, z_c, z_r], commitment, codebook,
        timbre) as the JAX module does: `outs` carries z_p and z_c without
        their gradient and z_r under the residual keep mask, the residual
        stream quantizes x less the detached z_p and z_c, and the streams
        come back with their gradients for the predictor heads."""
        self._need_v2("forward_v2")
        mel = self.preprocess(wave_segments, n_bins=80)
        if full_waves is None:
            timbre = self.timbre_encoder(mel, train=train, generator=generator)
        else:
            mel_full = mel if full_waves is wave_segments else self.preprocess(full_waves)
            frames = torch.arange(mel_full.shape[1], device=mel_full.device)
            mask = frames[None, :] < (wave_lens.to(mel_full.device) // self.hop_length)[:, None]
            timbre = self.timbre_encoder(mel_full, mask[:, :, None].to(mel_full.dtype),
                                         train=train, generator=generator)

        f0_input, x = self._prosody_input(x, wave_segments, train, generator, mel)

        if not train:
            z_p, codes_p = self.prosody_quantizer(f0_input, 1)
            z_c, codes_c = self.content_quantizer(x, n_c)
            z_r, codes_r = self.residual_quantizer(x - z_p - z_c, 3)
            outs = self._timbre_condition(z_p + z_c + z_r, timbre)
            if return_quantized:
                return outs, [codes_p, codes_c, codes_r], timbre, [z_p, z_c, z_r]
            return outs, [codes_p, codes_c, codes_r], timbre

        z_p, _, commit_p, cb_p = self.prosody_quantizer.forward_train(f0_input, generator)
        z_c, _, commit_c, cb_c = self.content_quantizer.forward_train(x, generator)
        z_p_sg, z_c_sg = z_p.detach(), z_c.detach()
        z_r, _, commit_r, cb_r = self.residual_quantizer.forward_train(x - z_p_sg - z_c_sg,
                                                                       generator)
        keep = self._residual_keep(x, z_r.dtype, generator)
        outs = self._timbre_condition(z_p_sg + z_c_sg + z_r * keep, timbre)
        return (outs, [z_p, z_c, z_r], commit_p + commit_c + commit_r, cb_p + cb_c + cb_r,
                timbre)

    def _residual_keep(self, x: torch.Tensor, dtype: torch.dtype,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """The residual stream's train-mode keep mask (B, 1, 1): kept with
        probability 1 - prob_random_mask_residual per row."""
        p = self.prob_random_mask_residual
        keep = torch.ones(x.shape[0], 1, 1, device=x.device)
        if p > 0.0:
            if generator is None:
                raise ValueError("the residual mask draws from a torch.Generator; pass one")
            keep = (rand_rows(keep.shape, generator, x.device) < 1.0 - p).to(dtype)
        return keep

    def forward_v1(self, x: torch.Tensor, wave_segments: torch.Tensor,
                   noise_added_flags: Optional[torch.Tensor] = None,
                   recon_noisy_flags: Optional[torch.Tensor] = None, n_c: int = 2,
                   n_t: int = 2, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """The legacy 4-stream model: x the encoder latent (B, T, in_dim),
        wave_segments (B, Tw). Returns (outs, [z_p, z_c, z_t, z_r],
        commitment, codebook), in eval too (the first 1, n_c, n_t and 3
        stages) as in train mode (every stage, the quantizer dropout and the
        residual keep mask drawn from `generator`). `outs` carries z_p and
        z_c without their gradient and z_t with it; the timbre RVQ quantizes
        x less the detached z_p and z_c, the residual RVQ what z_t leaves.
        Given both (B,) bool flags, a row with noise added keeps its residual
        stream where `recon_noisy_flags` is set and drops it where not,
        whatever the mask drew."""
        f0_input, x = self._prosody_input(x, wave_segments, train, generator)

        def rvq(quantizer, z, n):
            if train:
                return quantizer.forward_train(z, generator)
            return quantizer.forward_losses(z, n)

        z_p, _, commit_p, cb_p = rvq(self.prosody_quantizer, f0_input, 1)
        z_c, _, commit_c, cb_c = rvq(self.content_quantizer, x, n_c)
        z_p_sg, z_c_sg = z_p.detach(), z_c.detach()
        timbre_residual = x - z_p_sg - z_c_sg
        z_t, _, commit_t, cb_t = rvq(self.timbre_quantizer, timbre_residual, n_t)
        z_r, _, commit_r, cb_r = rvq(self.residual_quantizer, timbre_residual - z_t, 3)
        if train:
            keep = self._residual_keep(x, z_r.dtype, generator)
        else:
            keep = torch.ones(x.shape[0], 1, 1, dtype=z_r.dtype, device=x.device)
        if noise_added_flags is not None and recon_noisy_flags is not None:
            noisy = noise_added_flags.to(torch.bool)
            recon = recon_noisy_flags.to(torch.bool)
            keep = torch.where((noisy & recon)[:, None, None], 1.0, keep)
            keep = torch.where((noisy & ~recon)[:, None, None], 0.0, keep)
        outs = z_p_sg + z_c_sg + z_t + z_r * keep
        return (outs, [z_p, z_c, z_t, z_r], commit_p + commit_c + commit_t + commit_r,
                cb_p + cb_c + cb_t + cb_r)

    def encode(self, x: torch.Tensor, wave_segments: torch.Tensor, n_c: int = 1):
        """The 4-stream model's inference encode: ([codes_c, codes_p,
        codes_t, codes_r], [z_c, z_p, z_t, z_r]), each code stream (B, n, T)
        int32 (n = n_c, 1, 2, 3)."""
        f0_input, x = self._prosody_input(x, wave_segments, False, None)
        z_p, codes_p = self.prosody_quantizer(f0_input, 1)
        z_c, codes_c = self.content_quantizer(x, n_c)
        timbre_residual = x - z_p - z_c
        z_t, codes_t = self.timbre_quantizer(timbre_residual, 2)
        z_r, codes_r = self.residual_quantizer(timbre_residual - z_t, 3)
        return [codes_c, codes_p, codes_t, codes_r], [z_c, z_p, z_t, z_r]

    def decode(self, codes: torch.Tensor):
        """(B, 4, T) stacked [c, p, t0, t1] codes -> (z_c + z_p + z_t,
        [z_c, z_p, z_t])."""
        z_c = self.content_quantizer.from_codes(codes[:, 0:1])
        z_p = self.prosody_quantizer.from_codes(codes[:, 1:2])
        z_t = self.timbre_quantizer.from_codes(codes[:, 2:4])
        return z_c + z_p + z_t, [z_c, z_p, z_t]

    def encode_streaming(self, x: torch.Tensor, mel20: torch.Tensor, timbre: torch.Tensor,
                         wn_stream, n_c: int = 1, first: bool = False):
        """One chunk, frame-synchronous, with a fixed stream timbre. x: the
        encoder latent (B, T, in_dim); mel20 (B, T, 20) the aligned log-mel;
        timbre (B, in_dim); wn_stream the prosody WN's carries. Equals
        forward_v2 frame by frame. Returns (outs, [codes_p, codes_c,
        codes_r], new_wn_stream)."""
        self._need_v2("encode_streaming")
        if not self.separate_prosody:
            raise ValueError("FAquantizer.encode_streaming needs the separate prosody encoder")
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
        self._need_v2("decode_streams_v2")
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


class ResidualUnitAF(nn.Module):
    """Alias-free residual unit of the predictor heads: Activation1d(SnakeBeta)
    -> dilated 7-tap weight-norm conv -> Activation1d(SnakeBeta) -> 1x1
    weight-norm conv, residual add."""

    def __init__(self, dim: int = 16, dilation: int = 1):
        super().__init__()
        self.block = nn.ModuleList([
            Activation1d(dim),
            Conv1d(dim, dim, 7, padding=(6 * dilation) // 2, weight_norm=True,
                   dilation=dilation),
            Activation1d(dim),
            Conv1d(dim, dim, 1, weight_norm=True),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for layer in self.block:
            y = layer(y)
        return x + y


class CNNLSTM(nn.Module):
    """Conv head with `head` linear outputs (no LSTM despite the name: three
    alias-free residual units and an alias-free activation). Input
    (B, T, C); each output (B, T, outdim), or (B, outdim) if global."""

    def __init__(self, indim: int, outdim: int, head: int, global_pred: bool = False):
        super().__init__()
        self.global_pred = global_pred
        self.model = nn.ModuleList([
            ResidualUnitAF(indim, dilation=1), ResidualUnitAF(indim, dilation=2),
            ResidualUnitAF(indim, dilation=3), Activation1d(indim),
        ])
        self.heads = nn.ModuleList([Linear(indim, outdim) for _ in range(head)])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        for layer in self.model:
            x = layer(x)
        if self.global_pred:
            x = torch.mean(x, dim=1)
        return [head(x) for head in self.heads]


class FApredictors(nn.Module):
    """Supervision heads and their gradient-reversal adversaries over the
    quantized streams: the timbre-norm variant (`forward_v2`, a linear
    speaker head on the timbre vector) and the 4-stream one (`forward_v1`, a
    global-pooled `CNNLSTM` speaker head on the timbre stream). The
    adversaries sit at index 1 of `nn.Sequential(GradientReversal(), head)`,
    as in the torch reference, so their keys are `rev_*_predictor.1.*`. The
    flags and class counts are the JAX module's fields. The global-F0 heads
    (`global_f0_predictor`, `rev_global_f0_predictor`) are declared by the
    JAX module but never called by either forward, so its parameter tree has
    none: their flag is accepted so that those fields build this module, and
    the heads are left out."""

    def __init__(self, in_dim: int = 1024, use_gr_content_f0: bool = False,
                 use_gr_prosody_phone: bool = False, use_gr_residual_f0: bool = False,
                 use_gr_residual_phone: bool = False, use_gr_timbre_content: bool = True,
                 use_gr_timbre_prosody: bool = True, use_gr_x_timbre: bool = False,
                 norm_f0: bool = True, timbre_norm: bool = False,
                 use_gr_content_global_f0: bool = False, n_phone_classes: int = 1024,
                 n_speakers: int = 20000):
        super().__init__()
        self.use_gr_content_f0, self.use_gr_prosody_phone = use_gr_content_f0, use_gr_prosody_phone
        self.use_gr_residual_f0, self.use_gr_residual_phone = (use_gr_residual_f0,
                                                               use_gr_residual_phone)
        self.use_gr_timbre_content, self.use_gr_timbre_prosody = (use_gr_timbre_content,
                                                                  use_gr_timbre_prosody)
        self.use_gr_x_timbre, self.norm_f0, self.timbre_norm = (use_gr_x_timbre, norm_f0,
                                                                timbre_norm)
        self.f0_predictor = CNNLSTM(in_dim, 1, 2)
        self.phone_predictor = CNNLSTM(in_dim, n_phone_classes, 1)
        self.timbre_predictor = (Linear(in_dim, n_speakers) if timbre_norm
                                 else CNNLSTM(in_dim, n_speakers, 1, global_pred=True))
        self.rev_f0_predictor = nn.Sequential(GradientReversal(), CNNLSTM(in_dim, 1, 2))
        self.rev_content_predictor = nn.Sequential(GradientReversal(),
                                                   CNNLSTM(in_dim, n_phone_classes, 1))
        self.rev_timbre_predictor = nn.Sequential(
            GradientReversal(), CNNLSTM(in_dim, n_speakers, 1, global_pred=True))

    def forward(self, quantized: List[torch.Tensor], timbre: Optional[torch.Tensor] = None):
        """`forward_v2` for the timbre-norm heads, `forward_v1` otherwise."""
        if self.timbre_norm:
            return self.forward_v2(quantized, timbre)
        return self.forward_v1(quantized)

    def forward_v2(self, quantized: List[torch.Tensor], timbre: torch.Tensor):
        """quantized = [z_p, z_c, z_r] (B, T, C), timbre (B, C) ->
        (preds, rev_preds): {f0, uv, content, timbre} and {rev_f0, rev_uv,
        rev_content, x_timbre} (x_timbre None without use_gr_x_timbre)."""
        prosody, content, residual = quantized
        content_pred = self.phone_predictor(content)[0]
        spk_pred = self.timbre_predictor(timbre)
        f0_pred, uv_pred = self.f0_predictor(prosody)

        prosody_rev = torch.zeros_like(prosody)
        if self.use_gr_content_f0:
            prosody_rev = prosody_rev + content
        if self.use_gr_residual_f0:
            prosody_rev = prosody_rev + residual
        rev_f0_pred, rev_uv_pred = self.rev_f0_predictor(prosody_rev)

        content_rev = torch.zeros_like(content)
        if self.use_gr_prosody_phone:
            content_rev = content_rev + prosody
        if self.use_gr_residual_phone:
            content_rev = content_rev + residual
        rev_content_pred = self.rev_content_predictor(content_rev)[0]

        x_spk_pred = None
        if self.use_gr_x_timbre:
            x_spk_pred = self.rev_timbre_predictor(prosody + content + residual)[0]
        preds = {"f0": f0_pred, "uv": uv_pred, "content": content_pred, "timbre": spk_pred}
        rev_preds = {"rev_f0": rev_f0_pred, "rev_uv": rev_uv_pred,
                     "rev_content": rev_content_pred, "x_timbre": x_spk_pred}
        return preds, rev_preds

    def forward_v1(self, quantized: List[torch.Tensor]):
        """quantized = [z_p, z_c, z_t, z_r] (B, T, C) -> (preds, rev_preds)
        as `forward_v2` returns them; `norm_f0` False predicts the speaker
        from timbre + prosody and F0 from prosody + timbre, and leaves the
        prosody out of the x-timbre adversary's input."""
        prosody, content, timbre, residual = quantized
        content_pred = self.phone_predictor(content)[0]
        if self.norm_f0:
            spk_pred = self.timbre_predictor(timbre)[0]
            f0_pred, uv_pred = self.f0_predictor(prosody)
        else:
            spk_pred = self.timbre_predictor(timbre + prosody)[0]
            f0_pred, uv_pred = self.f0_predictor(prosody + timbre)

        prosody_rev = torch.zeros_like(prosody)
        if self.use_gr_content_f0:
            prosody_rev = prosody_rev + content
        if self.use_gr_timbre_prosody:
            prosody_rev = prosody_rev + timbre
        if self.use_gr_residual_f0:
            prosody_rev = prosody_rev + residual
        rev_f0_pred, rev_uv_pred = self.rev_f0_predictor(prosody_rev)

        content_rev = torch.zeros_like(content)
        if self.use_gr_prosody_phone:
            content_rev = content_rev + prosody
        if self.use_gr_timbre_content:
            content_rev = content_rev + timbre
        if self.use_gr_residual_phone:
            content_rev = content_rev + residual
        rev_content_pred = self.rev_content_predictor(content_rev)[0]

        x_spk_pred = None
        if self.use_gr_x_timbre:
            timbre_rev = (prosody + content + residual if self.norm_f0
                          else content + residual)
            x_spk_pred = self.rev_timbre_predictor(timbre_rev)[0]
        preds = {"f0": f0_pred, "uv": uv_pred, "content": content_pred, "timbre": spk_pred}
        rev_preds = {"rev_f0": rev_f0_pred, "rev_uv": rev_uv_pred,
                     "rev_content": rev_content_pred, "x_timbre": x_spk_pred}
        return preds, rev_preds
