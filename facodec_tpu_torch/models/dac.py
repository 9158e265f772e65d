"""DAC-style causal convolutional encoder and decoder (NTC layout).

Port of facodec_tpu/models/dac.py. Submodules sit in `nn.ModuleList`s named
`block` (encoder side) and `model` (decoder), so that
`block.1.block.0.block.1.weight_v` maps onto the JAX path
('block_1', 'block_0', 'block_1', 'weight_v').

Every ResidualUnit goes through `ops.kernels.resunit`: the CUDA kernel for a
tensor on the card, the plain composition under the policy on the CPU. On
the card the policy, x's dtype and the unit's width pick the kernel form
(`resunit.unit_route`): the float32 entry, the bf16 entry (`bfloat16_act`,
and `int8`'s units that do not quantize, on a bf16 x), its float32-in/out
forms (`bfloat16`; `int8`'s units that do not quantize, on a float32 x) or
the int8 unit (`int8`, `is_int8(7 C)`). Outside the float32 entry (no
gradient, eval mode) a unit keeps its operands packed for its form and
repacks only when one of its parameters changes; in a program being
exported (utils/export.py) the packing is graph ops, on every device.

Streaming (causal models): every module takes `stream` and `first`. With a
stream, a dict of carries keyed by the JAX module names (`block_1`,
`model_2`, ...), it returns `(y, new_stream)`: conv left contexts,
transpose-conv overlap-add tails, the LSTM's (h, c), and for each residual
unit the halo of its conv7's snake1 input. Chunked output equals one-shot
output. `first=True` marks a stream's first chunk, which reflect-pads from
itself as the one-shot forward does and must cover every reflect span
(`min_first_chunk_frames`). A stream passed in is consumed: pass each call
the stream the previous call returned.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from facodec_tpu_torch.nn.activations import Snake1d
from facodec_tpu_torch.nn.conv import SConv1d, SConvTranspose1d
from facodec_tpu_torch.nn.lstm import SLSTM
from facodec_tpu_torch.ops.kernels.resunit import (fused_residual_unit,
                                                   fused_residual_unit_stream, make_pack,
                                                   run_packed, unit_route)

Stream = Optional[Dict[str, Any]]


class ResidualUnit(nn.Module):
    """Snake -> dilated 7-tap conv -> Snake -> 1x1 conv, residual add."""

    def __init__(self, dim: int = 16, dilation: int = 1, causal: bool = False):
        super().__init__()
        self.dilation, self.causal = dilation, causal
        self.block = nn.ModuleList([
            Snake1d(dim),
            SConv1d(dim, dim, 7, dilation=dilation, causal=causal),
            Snake1d(dim),
            SConv1d(dim, dim, 1, causal=causal),
        ])
        self._packs: Dict[str, Tuple[tuple, Any]] = {}  # route -> (key, pack)

    def _operands(self):
        snake1, conv7, snake2, conv1 = self.block
        return (conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
                snake1.alpha, snake2.alpha)

    def kept_pack(self, x: torch.Tensor, route: str):
        """The packed operands of kernel form `route` (resunit.unit_route)
        for x, or None where the unit does not run from a pack: the float32
        entry, gradients enabled, or training (the packed forms are forward
        only). A pack is kept per route (codecs of several policies may
        share the modules) and rebuilt when a parameter's version (an
        in-place update) or storage changes, or x's device does. In a
        program being exported it is made by graph ops on every call: the
        program keeps no state, and a traced tensor has no storage."""
        if route == "f32" or self.training or torch.is_grad_enabled():
            return None
        if torch.compiler.is_exporting():
            return make_pack(route, *self._operands())
        key = (x.device, *((p.data_ptr(), p._version) for p in self.parameters()))
        kept = self._packs.get(route)
        if kept is None or kept[0] != key:
            kept = self._packs[route] = key, make_pack(route, *self._operands())
        return kept[1]

    def forward(self, x: torch.Tensor, stream: Stream = None, first: bool = False):
        if stream is None and (x.is_cuda or torch.compiler.is_exporting()):
            route = unit_route(x.dtype, x.shape[-1])
            pack = self.kept_pack(x, route)
            if pack is not None:
                return run_packed(route, x.contiguous(), pack, self.dilation, self.causal)
        args = (*self._operands(), self.dilation)
        if stream is None:
            return fused_residual_unit(x.contiguous(), *args, self.causal)
        if not self.causal:
            raise ValueError("ResidualUnit: streaming requires causal mode")
        out, halo = fused_residual_unit_stream(
            x.contiguous(), None if first else stream["block_1"], *args)
        return out, {"block_1": halo, "block_3": stream["block_3"]}


class EncoderBlock(nn.Module):
    """3 dilated residual units + strided down-conv; channels double."""

    def __init__(self, dim: int = 16, stride: int = 1, causal: bool = False):
        super().__init__()
        h = dim // 2
        self.block = nn.ModuleList([
            ResidualUnit(h, dilation=1, causal=causal),
            ResidualUnit(h, dilation=3, causal=causal),
            ResidualUnit(h, dilation=9, causal=causal),
            Snake1d(h),
            SConv1d(h, dim, 2 * stride, stride=stride, causal=causal),
        ])

    def forward(self, x: torch.Tensor, stream: Stream = None, first: bool = False):
        if stream is None:
            for layer in self.block:
                x = layer(x)
            return x
        new = {}
        for i in range(3):
            x, new[f"block_{i}"] = self.block[i](x, stream[f"block_{i}"], first)
        x = self.block[3](x)
        x, new["block_4"] = self.block[4](x, stream["block_4"], first)
        return x, new


class Encoder(nn.Module):
    """Wave (B, T, 1) -> latent (B, T / hop, d_latent); hop = prod(strides)."""

    def __init__(self, d_model: int = 64, strides: Sequence[int] = (2, 4, 8, 8),
                 d_latent: int = 64, causal: bool = False, lstm: int = 2):
        super().__init__()
        self.d_model, self.strides, self.causal, self.lstm = d_model, tuple(strides), causal, lstm
        d = d_model
        layers = [SConv1d(1, d, 7, causal=causal)]
        for stride in strides:
            d *= 2
            layers.append(EncoderBlock(d, stride=stride, causal=causal))
        if lstm:
            layers.append(SLSTM(d, lstm))
        layers += [Snake1d(d), SConv1d(d, d_latent, 3, causal=causal)]
        self.block = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, stream: Stream = None, first: bool = False):
        if stream is None:
            for layer in self.block:
                x = layer(x)
            return x
        return _stream_layers(self.block, "block", x, stream, first)


class DecoderBlock(nn.Module):
    """Snake -> strided transpose up-conv -> 3 dilated residual units."""

    def __init__(self, input_dim: int = 16, output_dim: int = 8, stride: int = 1,
                 causal: bool = False):
        super().__init__()
        self.block = nn.ModuleList([
            Snake1d(input_dim),
            SConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride, causal=causal),
            ResidualUnit(output_dim, dilation=1, causal=causal),
            ResidualUnit(output_dim, dilation=3, causal=causal),
            ResidualUnit(output_dim, dilation=9, causal=causal),
        ])

    def forward(self, x: torch.Tensor, stream: Stream = None, first: bool = False):
        if stream is None:
            for layer in self.block:
                x = layer(x)
            return x
        new = {}
        x = self.block[0](x)
        x, new["block_1"] = self.block[1](x, stream["block_1"])
        for i in range(2, 5):
            x, new[f"block_{i}"] = self.block[i](x, stream[f"block_{i}"], first)
        return x, new


class Decoder(nn.Module):
    """Latent (B, T', C) -> wave (B, T, 1), ending in tanh."""

    def __init__(self, input_channel: int, channels: int, rates: Sequence[int],
                 causal: bool = False, lstm: int = 2):
        super().__init__()
        self.input_channel, self.channels, self.rates = input_channel, channels, tuple(rates)
        self.causal, self.lstm = causal, lstm
        layers = [SConv1d(input_channel, channels, 7, causal=causal)]
        if lstm:
            layers.append(SLSTM(channels, lstm))
        output_dim = channels
        for i, stride in enumerate(rates):
            input_dim = channels // 2**i
            output_dim = channels // 2 ** (i + 1)
            layers.append(DecoderBlock(input_dim, output_dim, stride, causal=causal))
        layers += [Snake1d(output_dim), SConv1d(output_dim, 1, 7, causal=causal)]
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, stream: Stream = None, first: bool = False):
        if stream is None:
            for layer in self.model:
                x = layer(x)
            return torch.tanh(x)
        x, new = _stream_layers(self.model, "model", x, stream, first)
        return torch.tanh(x), new


def _stream_layers(layers: nn.ModuleList, prefix: str, x: torch.Tensor, stream: Dict[str, Any],
                   first: bool):
    """Run an encoder's or decoder's layers on one chunk: a snake carries
    nothing, the LSTM its (h, c), every other layer its own stream."""
    new: Dict[str, Any] = {}
    for i, layer in enumerate(layers):
        key = f"{prefix}_{i}"
        if isinstance(layer, Snake1d):
            x = layer(x)
        elif isinstance(layer, SLSTM):
            x, new[key] = layer(x, stream[key], return_state=True)
        else:
            x, new[key] = layer(x, stream[key], first)
    return x, new


# --------------------------------------------------------- streaming states
# Zero carries, with the JAX package's tree structure and names, on the
# device of the module they are for.


def _zeros(module: nn.Module, *shape: int) -> torch.Tensor:
    p = next(module.parameters())
    return torch.zeros(*shape, dtype=p.dtype, device=p.device)


def _conv_state(m: nn.Module, batch: int, cin: int, k: int, s: int = 1, d: int = 1):
    return _zeros(m, batch, (k - 1) * d + 1 - s, cin)


def _residual_unit_state(m: nn.Module, batch: int, dim: int, dilation: int) -> Dict[str, Any]:
    return {"block_1": _conv_state(m, batch, dim, 7, 1, dilation),
            "block_3": _conv_state(m, batch, dim, 1, 1, 1)}


def encoder_stream_state(enc: Encoder, batch: int) -> Dict[str, Any]:
    d = enc.d_model
    state: Dict[str, Any] = {"block_0": _conv_state(enc, batch, 1, 7)}
    for i, stride in enumerate(enc.strides):
        d *= 2
        h = d // 2
        state[f"block_{i + 1}"] = {
            "block_0": _residual_unit_state(enc, batch, h, 1),
            "block_1": _residual_unit_state(enc, batch, h, 3),
            "block_2": _residual_unit_state(enc, batch, h, 9),
            "block_4": _conv_state(enc, batch, h, 2 * stride, stride),
        }
    n = len(enc.strides) + 1
    if enc.lstm:
        state[f"block_{n}"] = (_zeros(enc, enc.lstm, batch, d), _zeros(enc, enc.lstm, batch, d))
        n += 1
    state[f"block_{n + 1}"] = _conv_state(enc, batch, d, 3)
    return state


def decoder_stream_state(dec: Decoder, batch: int) -> Dict[str, Any]:
    state: Dict[str, Any] = {"model_0": _conv_state(dec, batch, dec.input_channel, 7)}
    n = 1
    if dec.lstm:
        state[f"model_{n}"] = (_zeros(dec, dec.lstm, batch, dec.channels),
                               _zeros(dec, dec.lstm, batch, dec.channels))
        n += 1
    output_dim = dec.channels
    for i, stride in enumerate(dec.rates):
        output_dim = dec.channels // 2 ** (i + 1)
        state[f"model_{n}"] = {
            # the transpose conv's overlap-add tail is at its output width
            "block_1": _zeros(dec, batch, 2 * stride - stride, output_dim),
            "block_2": _residual_unit_state(dec, batch, output_dim, 1),
            "block_3": _residual_unit_state(dec, batch, output_dim, 3),
            "block_4": _residual_unit_state(dec, batch, output_dim, 9),
        }
        n += 1
    state[f"model_{n + 1}"] = _conv_state(dec, batch, output_dim, 7)
    return state


def min_first_chunk_frames(strides: Sequence[int]) -> int:
    """Smallest first-chunk length (in latent frames) for exact streaming:
    the deepest dilated residual unit's reflect-pad span, ceil'd to frames.
    For the flagship strides (2,5,5,6) this is 10 frames (125 ms)."""
    hop = math.prod(strides)
    worst = 7  # first conv k=7 span
    rate = 1
    for st in strides:
        worst = max(worst, 55 * rate)  # k=7 d=9 -> k_eff 55 at this rate
        rate *= st
    worst = max(worst, 3 * hop)  # final conv k=3 at frame rate
    return math.ceil(worst / hop)
