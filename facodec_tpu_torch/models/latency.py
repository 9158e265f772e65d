"""Analytic delay / receptive-field / latency metadata for the codec.

Port of facodec_tpu/models/latency.py (pure Python, copied; the streaming
figures come from the port's `models.streaming`).

The reference exposes `get_delay` / `get_output_length` on `CodecMixin`
(the reference's dac/model/base.py:82-123): per-layer conv length arithmetic
composed over the model, used to size the chunked-window streaming path. Our
exact stateful streaming (models/streaming.py) supersedes the windowed
recompute, but a real-time integrator still needs the numbers themselves —
how many samples of algorithmic latency a given config imposes, and how much
audio must arrive before the first emission. This module derives them from
the architecture alone (no traced model), mirroring the reference math.

Semantics:
  * causal configs (the flagship: config.yml:29 causal=True) have ZERO
    lookahead — every conv left-pads, so latent frame t depends only on
    wave[: (t+1)*hop]. The algorithmic latency is one frame (hop samples):
    a code cannot exist until its frame's samples have arrived, and the
    causal decoder emits that frame's hop output samples immediately.
  * non-causal configs pad symmetrically; the lookahead is the reference's
    `get_delay` — (l_in - l_out)//2 of the padding-less conv chain
    (base.py:82-106).
  * the conv receptive field (how far BACK one latent frame sees) is the
    padding-less l_in for l_out=1 over the encoder chain. The mid-stack
    LSTM makes the true history unbounded (recurrent state); the reported
    figure covers the conv stack only, as in the reference smoke test
    (dac/model/dac.py:369-386 measures exactly this with its gradient
    probe — their released model also carries the LSTM).
  * streaming figures (chunk buffering, priming / first emission) come from
    the exact-streaming session arithmetic (models/streaming.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, asdict
from typing import List, Optional, Tuple

# One conv layer: (transposed?, kernel, stride, dilation)
ConvSpec = Tuple[bool, int, int, int]


def encoder_conv_chain(strides: Tuple[int, ...]) -> List[ConvSpec]:
    """Forward-order conv specs of `models.dac.Encoder` (reference
    dac/model/dac.py:69-104): in-conv k=7, per stage 3 residual units
    (k=7 dilated + k=1) and a k=2s stride-s down-conv, final k=3 conv.
    The LSTM changes no lengths and is omitted."""
    chain: List[ConvSpec] = [(False, 7, 1, 1)]
    for st in strides:
        for dil in (1, 3, 9):
            chain += [(False, 7, 1, dil), (False, 1, 1, 1)]
        chain.append((False, 2 * st, st, 1))
    chain.append((False, 3, 1, 1))
    return chain


def decoder_conv_chain(rates: Tuple[int, ...]) -> List[ConvSpec]:
    """Forward-order conv specs of `models.dac.Decoder` (reference
    dac/model/dac.py:131-165): in-conv k=7, per stage a k=2r stride-r
    transpose up-conv + 3 residual units, final k=7 conv."""
    chain: List[ConvSpec] = [(False, 7, 1, 1)]
    for r in rates:
        chain.append((True, 2 * r, r, 1))
        for dil in (1, 3, 9):
            chain += [(False, 7, 1, dil), (False, 1, 1, 1)]
    chain.append((False, 7, 1, 1))
    return chain


def output_length(chain: List[ConvSpec], input_length: int) -> int:
    """Padding-less output length of the chain (reference
    dac/model/base.py:108-123)."""
    L = float(input_length)
    for transposed, k, s, d in chain:
        if transposed:
            L = (L - 1) * s + d * (k - 1) + 1
        else:
            L = (L - d * (k - 1) - 1) / s + 1
        L = math.floor(L)
    return int(L)


def input_length(chain: List[ConvSpec], output_length_: int) -> int:
    """Minimum padding-less input length producing `output_length_` outputs:
    the chain inverted layer by layer (reference dac/model/base.py:93-106)."""
    L = float(output_length_)
    for transposed, k, s, d in reversed(chain):
        if transposed:
            L = (L - d * (k - 1) - 1) / s + 1
        else:
            L = (L - 1) * s + d * (k - 1) + 1
        L = math.ceil(L)
    return int(L)


def receptive_span(chain: List[ConvSpec]) -> int:
    """EXACT worst-phase receptive span of one output sample, in input
    samples of the chain. Unlike `input_length` (which mirrors the
    reference's layer-inversion formula, loose for transposed convs —
    base.py:93-106), this walks the chain backward with interval
    arithmetic: a length-L output interval of a stride-s transposed conv
    with effective kernel k_eff = d(k-1)+1 draws from at most
    floor((L-1+k_eff-1)/s)+1 input frames (worst phase)."""
    span = 1
    for transposed, k, s, d in reversed(chain):
        k_eff = d * (k - 1) + 1
        if transposed:
            span = (span - 1 + k_eff - 1) // s + 1
        else:
            span = (span - 1) * s + k_eff
    return span


def analytic_delay(chain: List[ConvSpec]) -> int:
    """Symmetric-padding delay of the chain in input samples — the
    reference's `get_delay` (dac/model/base.py:82-106): half the surplus of
    the receptive span over the emitted span. Zero lookahead for causal
    configs is handled by the caller (causal pads are all-left)."""
    l_out = output_length(chain, 0)
    l_in = input_length(chain, l_out)
    return (l_in - l_out) // 2


@dataclass(frozen=True)
class LatencyReport:
    """Per-config latency/delay figures, all in samples at `sample_rate`
    (use `.ms()` to convert)."""

    sample_rate: int
    hop: int                      # samples per latent frame = prod(strides)
    causal: bool
    lookahead: int                # future samples one output depends on (0 causal)
    algorithmic_latency: int      # hop + lookahead: earliest in->out offset
    encoder_receptive_field: int  # conv-stack history of ONE latent frame
    codec_receptive_field: int    # conv-stack history of one OUTPUT sample
    # streaming-session figures (models/streaming.py); None without a session
    chunk_frames: Optional[int] = None
    chunk_latency: Optional[int] = None    # steady-state buffering per chunk
    first_emission: Optional[int] = None   # samples needed before any output

    def ms(self, samples: Optional[int]) -> Optional[float]:
        return None if samples is None else samples * 1000.0 / self.sample_rate

    def as_dict(self) -> dict:
        d = asdict(self)
        d.update({
            f"{k}_ms": self.ms(d[k])
            for k in ("lookahead", "algorithmic_latency", "chunk_latency",
                      "first_emission")
        })
        return d

    def __str__(self) -> str:
        rows = [
            ("algorithmic latency", self.algorithmic_latency),
            ("  lookahead", self.lookahead),
            ("  frame buffering (hop)", self.hop),
            ("encoder receptive field (conv)", self.encoder_receptive_field),
            ("codec receptive field (conv)", self.codec_receptive_field),
        ]
        if self.chunk_frames is not None:
            rows += [
                (f"chunk buffering ({self.chunk_frames} frames)", self.chunk_latency),
                ("first emission (priming)", self.first_emission),
            ]
        w = max(len(r[0]) for r in rows)
        lines = [f"latency @ {self.sample_rate} Hz ({'causal' if self.causal else 'non-causal'})"]
        lines += [f"  {n:<{w}}  {v:>7d} smp  {self.ms(v):8.2f} ms" for n, v in rows]
        return "\n".join(lines)


def codec_latency(
    strides: Tuple[int, ...],
    rates: Tuple[int, ...],
    causal: bool,
    sample_rate: int = 24000,
    chunk_frames: Optional[int] = None,
) -> LatencyReport:
    """Build the report from the architecture config. `chunk_frames` adds
    the exact-streaming session figures (chunk buffering + priming)."""
    hop = math.prod(strides)
    enc = encoder_conv_chain(strides)
    dec = decoder_conv_chain(rates)
    lookahead = 0 if causal else analytic_delay(enc + dec)
    enc_rf = receptive_span(enc)
    # one output sample needs dec_rf_frames of latent context, each of which
    # needs enc_rf wave samples ending at that frame
    dec_rf_frames = receptive_span(dec)
    codec_rf = (dec_rf_frames - 1) * hop + enc_rf
    chunk_latency = first_emission = None
    if chunk_frames is not None:
        from facodec_tpu_torch.models.streaming import prime_frames_for

        chunk_latency = chunk_frames * hop
        first_emission = prime_frames_for(strides, rates, chunk_frames) * hop
    return LatencyReport(
        sample_rate=sample_rate, hop=hop, causal=causal, lookahead=lookahead,
        algorithmic_latency=hop + lookahead, encoder_receptive_field=enc_rf,
        codec_receptive_field=codec_rf, chunk_frames=chunk_frames,
        chunk_latency=chunk_latency, first_emission=first_emission,
    )
