"""Chunked real-time streaming sessions: the codec and the redecoder.

Port of facodec_tpu/models/streaming.py. Wave chunks go in; factorized
codes and resynthesized wave chunks come out, equal to the one-shot forward
(the flush supplies the end-reflect frame).

Mechanics:
  * Encoder and decoder carry conv left contexts, transpose-conv
    overlap-add tails, the LSTMs' (h, c) and each residual unit's halo
    (models/dac.py); the residual units run the kernel's halo entry on the
    card (ops/kernels/resunit.py).
  * The prosody mel (n_fft 2048, win 1200, hop 300, centred) reaches
    +-600 samples around each frame, so the stream carries a 900-sample
    wave tail and holds one frame back (`ops.spectral.mel_frames`).
  * The prosody WN carries its conv contexts (models/wavenet.py); the RVQs
    are frame-local.
  * Timbre is one fixed vector per stream, from a reference utterance or
    an estimate.

Priming: the first step must reproduce the one-shot forward's left reflect
pads, which span up to 10 latent frames at the flagship strides. Chunks
accumulate on the host until `prime_frames` (the smallest chunk multiple
that covers every reflect span) have arrived, and the first step runs once
over all of them. Later chunks can be as short as one frame (12.5 ms).

Every step is an eager call under `torch.no_grad()` and `float32_exact()`.
State is threaded linearly: a state passed to a step is consumed, and the
caller passes the next step the state it got back (the JAX package donates
it to the same end).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from facodec_tpu_torch.api import float32_exact
from facodec_tpu_torch.models.dac import (
    decoder_stream_state, encoder_stream_state, min_first_chunk_frames,
)
from facodec_tpu_torch.models.redecoder import redecoder_stream_state
from facodec_tpu_torch.models.wavenet import wn_stream_state
from facodec_tpu_torch.ops.spectral import mel_frames, reflect_back, reflect_front

HOP = 300
WIN = 1200
NFFT = 2048
CTX = WIN // 2  # 600: one-sided reach of the mel window
TAIL = WIN - HOP  # 900: carried wave samples


def min_prime_frames_encoder(strides: Sequence[int]) -> int:
    """Smallest first-step length (latent frames) for exact encoder-side
    streaming: every reflect pad (conv left pads at their stage's rate, the
    mel's front context of CTX + 1 samples) must lie in the first chunk."""
    hop = math.prod(strides)
    return max(min_first_chunk_frames(strides), math.ceil((CTX + 1) / hop))


def min_first_frames_decoder(rates: Sequence[int]) -> int:
    """Smallest first decoder input (latent frames) covering its reflect
    spans: model_0's k=7 at frame rate, the dilation-9 residual units after
    each upsampling stage."""
    worst = 7
    rate = 1
    for r in rates:
        rate *= r
        worst = max(worst, math.ceil(55 / rate))
    return worst


def prime_frames_for(strides: Sequence[int], rates: Sequence[int], chunk_frames: int) -> int:
    """Latent frames a `StreamingFACodec` session buffers before its first
    emission: the smallest chunk multiple covering every reflect span
    (encoder convs and mel front context, the decoder's deepest span + 1,
    the prosody WN's k=5 span). Shared with `models.latency.codec_latency`."""
    need = max(min_prime_frames_encoder(strides), min_first_frames_decoder(rates) + 1, 5 + 1)
    return math.ceil(need / chunk_frames) * chunk_frames


@dataclass(frozen=True)
class EncodeState:
    """Encode state of a session: the carries (encoder, prosody WN, wave
    tail, latent held back one frame) and the host-side priming buffer."""

    core: Tuple
    pending: Tuple[torch.Tensor, ...] = ()
    n_pending: int = 0
    primed: bool = False


class StreamingFACodec:
    """Streaming session over the port's causal codec modules.

    `chunk_frames` is the steady-state chunk in latent frames (300 samples,
    12.5 ms each), any size >= 1; small chunks are primed (module docstring).
    Waves, timbres and codes are tensors on the modules' device."""

    def __init__(self, encoder: nn.Module, quantizer: nn.Module, decoder: nn.Module,
                 chunk_frames: int = 16, n_c: int = 1):
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        self.encoder, self.quantizer, self.decoder = encoder, quantizer, decoder
        self.chunk_frames, self.n_c = chunk_frames, n_c
        # the first emission is prime_frames - 1 frames; it must cover the
        # decoder's deepest reflect span and the prosody WN's k=5 span
        self.prime_frames = prime_frames_for(encoder.strides, decoder.rates, chunk_frames)

    # ------------------------------------------------------------- steps
    def _encode_step(self, wave_chunk, timbre, core, first: bool):
        enc_s, wn_s, tail, lat_buf = core
        latent, enc_s = self.encoder(wave_chunk[:, :, None], enc_s, first)
        n_in = wave_chunk.shape[1] // HOP
        if first:
            ctx = torch.cat([reflect_front(wave_chunk, CTX), wave_chunk], dim=1)
            n_out = n_in - 1
            lat_cat = latent
        else:
            ctx = torch.cat([tail, wave_chunk], dim=1)
            n_out = n_in
            lat_cat = torch.cat([lat_buf, latent], dim=1)
        lat, lat_buf = lat_cat[:, :n_out], lat_cat[:, n_out:]
        mel = mel_frames(ctx, n_out, HOP, self.quantizer.sample_rate)[:, :, :20]
        outs, codes, wn_s = self.quantizer.encode_streaming(lat, mel, timbre, wn_s,
                                                            n_c=self.n_c, first=first)
        return outs, codes, (enc_s, wn_s, ctx[:, ctx.shape[1] - TAIL:], lat_buf)

    def _flush_step(self, timbre, core):
        _, wn_s, tail, lat_buf = core
        ctx = torch.cat([tail, reflect_back(tail, HOP)], dim=1)
        mel = mel_frames(ctx, 1, HOP, self.quantizer.sample_rate)[:, :, :20]
        outs, codes, _ = self.quantizer.encode_streaming(lat_buf, mel, timbre, wn_s,
                                                         n_c=self.n_c, first=False)
        return outs, codes

    def _decode_step(self, outs, core, first: bool):
        wave, core = self.decoder(outs, core, first)
        return wave[:, :, 0], core

    # ------------------------------------------------------------- encode
    def init_encode_state(self, batch: int) -> EncodeState:
        enc_s = encoder_stream_state(self.encoder, batch)
        wn_s = wn_stream_state(self.quantizer.melspec_encoder, batch)
        p = next(self.encoder.parameters())
        tail = torch.zeros(batch, TAIL, dtype=p.dtype, device=p.device)
        lat_buf = torch.zeros(batch, 1, self.quantizer.in_dim, dtype=p.dtype, device=p.device)
        return EncodeState(core=(enc_s, wn_s, tail, lat_buf))

    def _prime(self, state: EncodeState, wave_chunk: torch.Tensor):
        """(state, None) while the priming buffer fills, else (None, the
        buffered wave for the first step)."""
        pending = state.pending + (wave_chunk,)
        n = state.n_pending + wave_chunk.shape[1] // HOP
        if n < self.prime_frames:
            return replace(state, pending=pending, n_pending=n), None
        return None, pending[0] if len(pending) == 1 else torch.cat(pending, dim=1)

    @torch.no_grad()
    def encode_chunk(self, state: EncodeState, wave_chunk: torch.Tensor,
                     timbre: torch.Tensor):
        """wave_chunk (B, chunk_frames * 300). Returns (state, outs, codes);
        outs and codes are None while priming. The priming step emits
        prime_frames - 1 frames, later calls chunk_frames."""
        first = not state.primed
        if first:
            buffered, wave_chunk = self._prime(state, wave_chunk)
            if buffered is not None:
                return buffered, None, None
        with float32_exact():
            outs, codes, core = self._encode_step(wave_chunk, timbre, state.core, first)
        return EncodeState(core=core, primed=True), outs, codes

    @torch.no_grad()
    def flush_encode(self, state: EncodeState, timbre: torch.Tensor):
        """Emit the final (end-reflect) frame: (outs, codes)."""
        if not state.primed:
            raise ValueError(
                f"stream shorter than prime_frames={self.prime_frames} frames "
                f"({self.prime_frames * HOP} samples); use the one-shot forward")
        with float32_exact():
            return self._flush_step(timbre, state.core)

    # ------------------------------------------------------------- decode
    def init_decode_state(self, batch: int) -> Tuple:
        return (decoder_stream_state(self.decoder, batch), True)

    @torch.no_grad()
    def decode_chunk(self, state, outs: Optional[torch.Tensor]):
        """Returns (state, wave (B, frames * 300)); outs=None (the encoder
        still priming) is a no-op."""
        if outs is None:
            return state, None
        core, first = state
        with float32_exact():
            wave, core = self._decode_step(outs, core, first)
        return (core, False), wave

    # -------------------------------------------------------- fused chunk
    @torch.no_grad()
    def roundtrip_chunk(self, est: EncodeState, dst, wave_chunk: torch.Tensor,
                        timbre: torch.Tensor):
        """Encode and decode one chunk in one call, for live reconstruction.
        Same priming as encode_chunk; returns (est, dst, wave or None, codes
        or None), equal to encode_chunk followed by decode_chunk."""
        dcore, dfirst = dst
        first = not est.primed
        if first:
            buffered, wave_chunk = self._prime(est, wave_chunk)
            if buffered is not None:
                return buffered, dst, None, None
        elif dfirst:
            raise ValueError("encoder primed but decoder not: prime both through "
                             "roundtrip_chunk (or decode the priming outs first)")
        with float32_exact():
            outs, codes, ecore = self._encode_step(wave_chunk, timbre, est.core, first)
            wave, dcore = self._decode_step(outs, dcore, first)
        return EncodeState(core=ecore, primed=True), (dcore, False), wave, codes

    # ---------------------------------------------------------- whole wave
    @torch.no_grad()
    def run_scan(self, wave: torch.Tensor, timbre: torch.Tensor, flush: bool = True):
        """Run a whole (B, n_chunks * chunk_frames * 300) wave through the
        chunked encode + decode, the priming chunks in one first step and
        then chunk by chunk (the JAX package's `lax.scan`, as a loop).

        With flush=True the end-reflect frame is emitted too, so the wave
        out has the input's length and equals the one-shot forward.
        Returns (recon (B, T), codes [p, c, r] each (B, n_cb, T // 300))."""
        B, T = wave.shape
        C = self.chunk_frames
        step = C * HOP
        if T % step:
            raise ValueError(f"wave length {T} is not a multiple of the chunk ({step})")
        n_chunks = T // step
        prime_chunks = self.prime_frames // C
        if n_chunks < prime_chunks:
            raise ValueError(f"need >= {prime_chunks} chunks ({self.prime_frames} frames) "
                             f"to prime")
        est = self.init_encode_state(B).core
        dst = self.init_decode_state(B)[0]
        parts: List[torch.Tensor] = []
        code_parts: List[List[torch.Tensor]] = []
        with float32_exact():
            for i in range(prime_chunks - 1, n_chunks):
                first = i == prime_chunks - 1
                chunk = wave[:, : (i + 1) * step] if first else wave[:, i * step : (i + 1) * step]
                outs, codes, est = self._encode_step(chunk, timbre, est, first)
                w, dst = self._decode_step(outs, dst, first)
                parts.append(w)
                code_parts.append(codes)
            if flush:
                outs, codes = self._flush_step(timbre, est)
                w, dst = self._decode_step(outs, dst, False)
                parts.append(w)
                code_parts.append(codes)
        recon = torch.cat(parts, dim=1)
        codes = [torch.cat([cp[j] for cp in code_parts], dim=-1) for j in range(3)]
        return recon, codes


@dataclass(frozen=True)
class RedecoderState:
    """Streaming-VC session state: (WN carries, decoder carries) and the
    priming buffer."""

    core: Tuple
    pending: Tuple = ()
    n_pending: int = 0
    primed: bool = False


class StreamingRedecoder:
    """Chunked real-time voice conversion through the redecoder: source
    codes -> Redecoder WN conditioned on the target timbre -> DAC decoder,
    streamed exactly (equal to `FARedecoder.resynthesize`).

    Causal models only: a non-causal redecoder or decoder needs future
    context, and is refused. The first chunk must cover the WN's k=5 span
    and the decoder's deepest reflect span (`min_first_frames_decoder`);
    smaller steady-state chunks are primed on the host, as in
    `StreamingFACodec`."""

    def __init__(self, redecoder: nn.Module, decoder: nn.Module, chunk_frames: int = 16,
                 use_p_code: bool = False, n_c: int = 1):
        if not (redecoder.causal and decoder.causal):
            raise ValueError("streaming VC requires the causal redecoder config "
                             "(decoder_causal: True); non-causal models need future context")
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        self.redecoder, self.decoder = redecoder, decoder
        self.chunk_frames, self.use_p_code, self.n_c = chunk_frames, use_p_code, n_c
        need = max(5, min_first_frames_decoder(decoder.rates))
        self.prime_frames = math.ceil(need / chunk_frames) * chunk_frames

    def _step(self, p_code, c_code, timbre, core, first: bool):
        wn_s, dec_s = core
        z, wn_s = self.redecoder(p_code, c_code, timbre, use_p_code=self.use_p_code,
                                 n_c=self.n_c, stream=wn_s, first=first)
        wave, dec_s = self.decoder(z, dec_s, first)
        return wave[:, :, 0], (wn_s, dec_s)

    def init_state(self, batch: int) -> RedecoderState:
        return RedecoderState(core=(redecoder_stream_state(self.redecoder, batch),
                                    decoder_stream_state(self.decoder, batch)))

    @torch.no_grad()
    def vc_chunk(self, state: RedecoderState, p_code: torch.Tensor, c_code: torch.Tensor,
                 timbre: torch.Tensor):
        """p_code (B, n_p, chunk_frames), c_code (B, n_c, chunk_frames)
        integer codes; timbre (B, d), the target speaker's. Returns (state,
        wave chunk (B, chunk_frames * 300), or None while priming)."""
        first = not state.primed
        if first:
            pending = state.pending + ((p_code, c_code),)
            n = state.n_pending + p_code.shape[-1]
            if n < self.prime_frames:
                return replace(state, pending=pending, n_pending=n), None
            p_code = torch.cat([p for p, _ in pending], dim=-1)
            c_code = torch.cat([c for _, c in pending], dim=-1)
        with float32_exact():
            wave, core = self._step(p_code, c_code, timbre, state.core, first)
        return RedecoderState(core=core, primed=True), wave
