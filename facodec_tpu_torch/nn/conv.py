"""Convolution layers in NTC layout with torch parameter layout.

Port of facodec_tpu/nn/conv.py with the options the codec uses: every conv
has a bias and one group. The causal `SConv1d` and `SConvTranspose1d` also
stream: given a carried `state` they return `(y, new_state)`, and chunked
output equals the one-shot output (see each class). Conv
weights are (O, I, K), transposed-conv weights (I, O, K); weight norm keeps
`weight_g` / `weight_v` as parameters and computes `v * (g / ||v||)` over
every dim but 0 on each call. Activations are NTC at every public function;
`F.conv1d` runs on the NCT transpose.

Under the `bfloat16_act` policy (ops/precision.py) a conv rounds its
operands to bf16, accumulates in float32, rounds the result to bf16 and
only then adds the bias in bf16, as the JAX package does. On the card that
is cuDNN's (or cuBLAS's) bf16 convolution; on the CPU a float32 convolution
of bf16-valued tensors, rounded after, which rounds at the same points.
`exact=True` keeps a conv in float32 under every policy (the VQ
projections).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from facodec_tpu_torch.ops.padding import get_extra_padding_for_conv1d, pad1d
from facodec_tpu_torch.ops.precision import bf16_active, bf16_values


def apply_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))
    return v * (g / norm)


def bf16_op(fn, x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """fn(x, w) with bf16 operands and float32 accumulation, rounded to
    bf16, then `+ bias` in bf16 (the module docstring)."""
    if x.device.type == "cuda":
        y = fn(x.to(torch.bfloat16), w.to(torch.bfloat16))
    else:
        y = fn(bf16_values(x), bf16_values(w)).to(torch.bfloat16)
    return y if bias is None else y + bias.to(torch.bfloat16)


def conv1d_ntc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               stride: int = 1, dilation: int = 1, padding: int = 0,
               exact: bool = False) -> torch.Tensor:
    """1-D conv over NTC input with a (O, I, K) weight, under the precision
    policy unless `exact`. A pointwise conv is a matmul over channels and
    runs as one, as in the JAX package."""
    pointwise = weight.shape[-1] == 1 and stride == 1 and padding == 0
    if not exact and bf16_active():
        if pointwise:
            return bf16_op(lambda a, w: F.linear(a, w[:, :, 0]), x, weight, bias)
        return bf16_op(lambda a, w: F.conv1d(a.transpose(1, 2), w, stride=stride,
                                             padding=padding, dilation=dilation).transpose(1, 2),
                       x, weight, bias)
    if exact:
        x = x.float()
    if pointwise:
        return F.linear(x, weight[:, :, 0], bias)
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding,
                 dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d_ntc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                         stride: int) -> torch.Tensor:
    """Transposed conv over NTC input with a (I, O, K) weight, untrimmed,
    under the precision policy."""
    def fn(a, w):
        return F.conv_transpose1d(a.transpose(1, 2), w, stride=stride).transpose(1, 2)

    if bf16_active():
        return bf16_op(fn, x, weight, bias)
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride=stride)
    return y.transpose(1, 2)


class _WeightNormConv(nn.Module):
    """Holds `weight_g`/`weight_v` (or a plain `weight`) and `bias`."""

    def _init_weight(self, shape: Tuple[int, int, int], weight_norm: bool, out_channels: int):
        if weight_norm:
            self.weight_v = nn.Parameter(torch.empty(shape))
            self.weight_g = nn.Parameter(torch.empty(shape[0], 1, 1))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.weight_norm = weight_norm

    def effective_weight(self) -> torch.Tensor:
        if self.weight_norm:
            return apply_weight_norm(self.weight_v, self.weight_g)
        return self.weight


class Conv1d(_WeightNormConv):
    """torch-style Conv1d with symmetric zero padding, NTC activations."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, weight_norm: bool = False, exact: bool = False):
        super().__init__()
        self.padding, self.exact = padding, exact
        self._init_weight((out_channels, in_channels, kernel_size), weight_norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_ntc(x, self.effective_weight(), self.bias, padding=self.padding,
                          exact=self.exact)


class SConv1d(_WeightNormConv):
    """Conv1d with the codec's automatic reflect padding: causal=True pads
    `(k_eff - stride, extra)`; causal=False splits `k_eff - stride` with the
    extra on the right.

    Streaming (causal only): pass `state` (B, k_eff - stride, C_in), the
    carried left context, and get `(y, new_state)`. With `first=True` the
    chunk is reflect-padded on the left from itself, as the one-shot forward
    pads; later chunks are the state and the chunk, run valid. A chunk must
    be a stride multiple. `init_state` / `state_len` build the carry.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, causal: bool = False,
                 norm: str = "weight_norm"):
        super().__init__()
        self.in_channels, self.kernel_size, self.stride, self.dilation, self.causal = (
            in_channels, kernel_size, stride, dilation, causal)
        self._init_weight((out_channels, in_channels, kernel_size), norm == "weight_norm",
                          out_channels)

    @property
    def state_len(self) -> int:
        return (self.kernel_size - 1) * self.dilation + 1 - self.stride

    def init_state(self, batch: int) -> torch.Tensor:
        return self.bias.new_zeros(batch, self.state_len, self.in_channels)

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor] = None,
                first: bool = False):
        if state is not None:
            return self._stream(x, state, first)
        k_eff = (self.kernel_size - 1) * self.dilation + 1
        padding_total = k_eff - self.stride
        extra = get_extra_padding_for_conv1d(x.shape[1], k_eff, self.stride, padding_total)
        if self.causal:
            pl, pr = padding_total, extra
        else:
            pl, pr = padding_total - padding_total // 2, padding_total // 2 + extra
        if pl or pr:
            x = pad1d(x, (pl, pr))
        return conv1d_ntc(x, self.effective_weight(), self.bias, stride=self.stride,
                          dilation=self.dilation)

    def _stream(self, x: torch.Tensor, state: torch.Tensor, first: bool):
        if not self.causal:
            raise ValueError("SConv1d: streaming state requires causal mode")
        if x.shape[1] % self.stride:
            raise ValueError(f"SConv1d: chunk of {x.shape[1]} is not a multiple of the "
                             f"stride {self.stride}")
        pad = self.state_len
        if first:
            x = pad1d(x, (pad, 0)) if pad else x
        else:
            x = torch.cat([state, x], dim=1)
        new_state = x[:, x.shape[1] - pad:]
        y = conv1d_ntc(x, self.effective_weight(), self.bias, stride=self.stride,
                       dilation=self.dilation)
        return y, new_state


class SConvTranspose1d(_WeightNormConv):
    """Weight-normed ConvTranspose1d (I, O, K) that trims `k - stride`
    samples: all on the right when causal, split otherwise.

    Streaming (causal only): pass `state` (B, k - stride, C_out), the part
    of the previous chunk's raw output that falls on this chunk's first
    samples, and get `(y, new_state)`: the state is added onto the head,
    the raw output past T * stride is carried, and the bias is added after
    the overlap-add so that each sample gets it once.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False):
        super().__init__()
        self.kernel_size, self.stride, self.causal = kernel_size, stride, causal
        self._init_weight((in_channels, out_channels, kernel_size), True, out_channels)

    @property
    def state_len(self) -> int:
        return self.kernel_size - self.stride

    def init_state(self, batch: int) -> torch.Tensor:
        return self.bias.new_zeros(batch, self.state_len, self.bias.shape[0])

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor] = None):
        if state is not None:
            return self._stream(x, state)
        y = conv_transpose1d_ntc(x, self.effective_weight(), self.bias, self.stride)
        padding_total = self.kernel_size - self.stride
        pr = padding_total if self.causal else padding_total // 2
        return y[:, padding_total - pr : y.shape[1] - pr]

    def _stream(self, x: torch.Tensor, state: torch.Tensor):
        if not self.causal:
            raise ValueError("SConvTranspose1d: streaming requires causal mode")
        y = conv_transpose1d_ntc(x, self.effective_weight(), None, self.stride)
        n = x.shape[1] * self.stride
        emit, new_state = y[:, :n], y[:, n:]
        if self.state_len:
            emit = torch.cat([emit[:, : self.state_len] + state, emit[:, self.state_len:]], 1)
        return emit + self.bias, new_state
