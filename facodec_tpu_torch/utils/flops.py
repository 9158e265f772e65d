"""Model FLOPs of one codec round trip, from the modules' shapes.

The JAX package's `bench.py` takes the round trip's FLOPs from XLA's
`cost_analysis` of the compiled program; the port has no compiled program
to ask, so `round_trip_flops` walks the modules of `FACodec.reconstruct_tensor`
(encode -> quantize -> decode of the quantized latent) and counts, from
their weights' shapes and the lengths the wave takes through them:

  * convolutions: 2 C_in C_out K / groups per output sample, and a
    transposed convolution the same per input sample (each input sample
    scatters K taps); a 1x1 conv, a Linear, a mel projection and an
    attention product as the matrix products they are (2 M K N);
  * the residual units: their conv7 and 1x1, 16 C^2 per row;
  * the VQ search: its distance product, 2 D N per latent row for a
    codebook of N codes of D dimensions;
  * the LSTMs: 2 * 4H (I + H) per step per layer.

FFTs, normalisations and elementwise work are not counted, as neither
`torch.utils.flop_counter.FlopCounterMode` nor XLA's matmul count does;
the count equals `FlopCounterMode` over the plain CPU round trip plus the
LSTM term, which that mode does not count (tests/test_torch_bench.py).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch.nn as nn

from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.nn.activations import Snake1d
from facodec_tpu_torch.nn.conv import SConv1d, SConvTranspose1d
from facodec_tpu_torch.nn.lstm import SLSTM
from facodec_tpu_torch.ops.padding import get_extra_padding_for_conv1d
from facodec_tpu_torch.ops.spectral import N_FFT


def _weight_shape(conv: nn.Module) -> Tuple[int, ...]:
    w = conv.weight_v if conv.weight_norm else conv.weight
    return tuple(w.shape)


def conv_flops(conv: nn.Module, B: int, T_out: int) -> int:
    """A conv with an (O, I / groups, K) weight over T_out output samples."""
    O, I, K = _weight_shape(conv)
    return 2 * B * T_out * O * I * K


def sconv(conv: SConv1d, B: int, T: int) -> Tuple[int, int]:
    """(FLOPs, output length) of an SConv1d on T samples, padded as its
    forward pads them."""
    k_eff = (conv.kernel_size - 1) * conv.dilation + 1
    padding_total = k_eff - conv.stride
    extra = get_extra_padding_for_conv1d(T, k_eff, conv.stride, padding_total)
    T_out = (T + padding_total + extra - k_eff) // conv.stride + 1
    return conv_flops(conv, B, T_out), T_out


def sconv_transpose(conv: SConvTranspose1d, B: int, T: int) -> Tuple[int, int]:
    I, O, K = _weight_shape(conv)
    return 2 * B * T * I * O * K, T * conv.stride


def lstm_flops(m: SLSTM, B: int, T: int) -> int:
    lstm = m.lstm
    H, flops, I = lstm.hidden_size, 0, lstm.input_size
    for _ in range(lstm.num_layers):
        flops += 2 * B * T * 4 * H * (I + H)
        I = H
    return flops


def layers_flops(layers, B: int, T: int) -> Tuple[int, int]:
    """(FLOPs, output length) of the DAC encoder's or decoder's layers."""
    flops = 0
    for layer in layers:
        if isinstance(layer, (Snake1d, nn.Identity)):
            continue
        if isinstance(layer, SConv1d):
            f, T = sconv(layer, B, T)
        elif isinstance(layer, SConvTranspose1d):
            f, T = sconv_transpose(layer, B, T)
        elif isinstance(layer, ResidualUnit):
            f = sconv(layer.block[1], B, T)[0] + sconv(layer.block[3], B, T)[0]
        elif isinstance(layer, SLSTM):
            f = lstm_flops(layer, B, T)
        elif hasattr(layer, "block"):  # an encoder or decoder block
            f, T = layers_flops(layer.block, B, T)
        else:
            raise TypeError(f"round_trip_flops: no count for {type(layer).__name__}")
        flops += f
    return flops, T


def _pointwise(conv: nn.Module, B: int, T: int) -> int:
    O, I, K = _weight_shape(conv)
    if K != 1:
        raise ValueError(f"{type(conv).__name__}: expected a 1x1 conv, got K = {K}")
    return 2 * B * T * O * I


def style_encoder_flops(enc: nn.Module, B: int, T: int) -> int:
    """StyleEncoder on T mel frames: two 1x1s, two GLU convs (zero padding
    keeps T), self-attention (four 1x1s and the two T x T products)."""
    h = _weight_shape(enc.spectral[0])[0]
    flops = _pointwise(enc.spectral[0], B, T) + _pointwise(enc.spectral[3], B, T)
    for glu in enc.temporal:
        flops += conv_flops(glu.conv1, B, T)
    attn = enc.slf_attn
    flops += sum(_pointwise(c, B, T) for c in (attn.conv_q, attn.conv_k, attn.conv_v,
                                                attn.conv_o))
    flops += 2 * (2 * B * T * T * h)  # q k^T and p v, over every head
    return flops + _pointwise(enc.fc, B, T)


def wn_flops(wn: nn.Module, B: int, T: int) -> int:
    flops = 0
    for conv in (*wn.in_layers, *wn.res_skip_layers):
        flops += sconv(conv, B, T)[0]
    return flops


def rvq_flops(rvq: nn.Module, n: int, B: int, T: int) -> int:
    """The first n stages: in-proj, the search's distance product, out-proj."""
    flops = 0
    for vq in rvq.quantizers[:n]:
        N, D = vq.codebook.weight.shape
        flops += (_pointwise(vq.in_proj, B, T) + 2 * B * T * D * N
                  + _pointwise(vq.out_proj, B, T))
    return flops


def quantizer_flops(q: nn.Module, B: int, samples: int, T_latent: int, n_c: int
                    ) -> Tuple[int, int]:
    """(FLOPs, latent frames) of `FAquantizer.forward_v2` in eval: the
    80-bin mel (its filterbank product over the centred STFT's frames), the
    timbre, the prosody features, the three RVQs, the timbre condition."""
    n_freq = N_FFT // 2 + 1
    frames = samples // q.hop_length
    flops = 2 * B * (1 + frames) * n_freq * q.mel.fb.shape[1]
    flops += style_encoder_flops(q.timbre_encoder, B, frames)
    flops += (sconv(q.melspec_linear, B, frames)[0] + wn_flops(q.melspec_encoder, B, frames)
              + sconv(q.melspec_linear2, B, frames)[0])
    T = min(frames, T_latent)
    flops += (rvq_flops(q.prosody_quantizer, 1, B, T) + rvq_flops(q.content_quantizer, n_c, B, T)
              + rvq_flops(q.residual_quantizer, 3, B, T))
    flops += 2 * B * q.timbre_linear.in_features * q.timbre_linear.out_features
    return flops, T


def round_trip_flops(modules: Mapping[str, nn.Module], batch: int, samples: int,
                     n_c: int = 2) -> int:
    """FLOPs of one `FACodec.reconstruct_tensor` of a (batch, samples)
    wave through `modules` ({"encoder", "quantizer", "decoder"})."""
    enc_flops, T_latent = layers_flops(modules["encoder"].block, batch, samples)
    q_flops, T = quantizer_flops(modules["quantizer"], batch, samples, T_latent, n_c)
    dec_flops, _ = layers_flops(modules["decoder"].model, batch, T)
    return enc_flops + q_flops + dec_flops

