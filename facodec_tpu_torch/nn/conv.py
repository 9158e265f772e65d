"""Convolution layers in NTC layout with torch parameter layout.

Port of facodec_tpu/nn/conv.py with the options the codec and its
discriminators use: every conv has a bias; only `Conv1d` takes a stride
and groups (the multi-scale discriminator's). The causal `SConv1d` and
`SConvTranspose1d` also stream: given a carried `state` they return
`(y, new_state)`, and chunked output equals the one-shot output (see each
class). Conv weights are (O, I / groups, K), transposed-conv weights (I, O, K), `Conv2d`
weights (O, I, Kh, Kw); weight norm keeps
`weight_g` / `weight_v` as parameters and computes `v * (g / ||v||)` over
every dim but 0 on each call. Activations are NTC at every public function;
`F.conv1d` runs on the NCT transpose. `Conv2d` (the discriminators', float32
only) takes and returns NCHW.

Under the `bfloat16_act` policy (ops/precision.py) a conv rounds its
operands to bf16, accumulates in float32, rounds the result to bf16 and
only then adds the bias in bf16, as the JAX package does. On the card that
is cuDNN's (or cuBLAS's) bf16 convolution; on the CPU a float32 convolution
of bf16-valued tensors, rounded after, which rounds at the same points.
Under `bfloat16` the result is rounded to bf16 the same way and returned
widened to float32, plus the float32 bias. Under `int8` a conv whose fan-in
(C_in * K) reaches `INT8_MIN_FANIN` runs W8A8 (`w8a8_conv`): its input
quantized per batch row, its weight per output channel, the int8 products
summed exactly and returned in float32 as `sum * (sx * sw) + bias`; the
other convs round as under `bfloat16_act`. `exact=True` keeps a conv in
float32 under every policy (the VQ projections).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from facodec_tpu_torch.ops.padding import get_extra_padding_for_conv1d, pad1d
from facodec_tpu_torch.ops.precision import (bf16_values, compute_dtype, is_int8, out_dtype,
                                             quantize_dynamic)


def apply_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))
    return v * (g / norm)


def bf16_op(fn, x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """fn(x, w) with bf16 operands and float32 accumulation, rounded to
    bf16, then `+ bias` in the policy's output dtype: in bf16 under
    `bfloat16_act` and `int8`, widened to float32 under `bfloat16` (the
    module docstring)."""
    if x.device.type == "cuda":
        y = fn(x.to(torch.bfloat16), w.to(torch.bfloat16))
    else:
        y = fn(bf16_values(x), bf16_values(w)).to(torch.bfloat16)
    y = y.to(out_dtype())
    return y if bias is None else y + bias.to(y.dtype)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (N, K).T of int8 matrices, summed exactly: int32 on the
    card (`torch._int_mm`, cuBLASLt; K and N zero-padded to multiples of 8
    and M to more than 16 rows, as it asks), float64 on the CPU (every sum
    of int8 products here is an integer far below 2^53)."""
    if a.device.type != "cuda":
        return a.double() @ b.double().T
    M, K = a.shape
    N = b.shape[0]
    kp, np_, mp = -(-K // 8) * 8, -(-N // 8) * 8, max(M, 17)
    a = F.pad(a, (0, kp - K, 0, mp - M))
    b = F.pad(b, (0, kp - K, 0, np_ - N))
    return torch._int_mm(a, b.T)[:M, :N]


def int8_conv1d(xq: torch.Tensor, wq: torch.Tensor, stride: int, dilation: int, padding: int,
                 groups: int) -> torch.Tensor:
    """The exact sums of an int8 conv over NTC input with an (O, I / groups, K)
    weight: float64 conv on the CPU, im2col and `int8_matmul` on the card."""
    if xq.device.type != "cuda":
        y = F.conv1d(xq.double().transpose(1, 2), wq.double(), stride=stride, padding=padding,
                     dilation=dilation, groups=groups)
        return y.transpose(1, 2)
    if groups != 1:
        raise ValueError("a W8A8 conv on the card takes groups == 1")
    B = xq.shape[0]
    O, I, K = wq.shape
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding))
    cols = xq.unfold(1, dilation * (K - 1) + 1, stride)[..., ::dilation]  # (B, T', I, K)
    T = cols.shape[1]
    y = int8_matmul(cols.reshape(B * T, I * K), wq.reshape(O, I * K))
    return y.reshape(B, T, O)


def int8_conv_transpose1d(xq: torch.Tensor, wq: torch.Tensor, stride: int) -> torch.Tensor:
    """The exact sums of an int8 transposed conv over NTC input with an
    (I, O, K) weight, untrimmed: float64 on the CPU; on the card each input
    row times the weight (`int8_matmul`, (B T, K O)), then the K taps added
    onto their output rows in int32, `stride` taps at a time."""
    if xq.device.type != "cuda":
        y = F.conv_transpose1d(xq.double().transpose(1, 2), wq.double(), stride=stride)
        return y.transpose(1, 2)
    B, T, I = xq.shape
    O, K = wq.shape[1], wq.shape[2]
    n = -(-K // stride)
    cols = int8_matmul(xq.reshape(B * T, I), wq.permute(2, 1, 0).reshape(K * O, I))
    cols = F.pad(cols.reshape(B, T, K * O), (0, (n * stride - K) * O))
    cols = cols.reshape(B, T, n, stride * O)
    y = cols.new_zeros(B, T + n - 1, stride * O)
    for j in range(n):
        y[:, j:j + T] += cols[:, :, j]
    return y.reshape(B, (T + n - 1) * stride, O)[:, :(T - 1) * stride + K]


def w8a8_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              transpose: bool = False, stride: int = 1, dilation: int = 1, padding: int = 0,
              groups: int = 1) -> torch.Tensor:
    """The `int8` policy's conv: x quantized per batch row over (T, C), the
    weight per output channel over (in, tap) (`quantize_dynamic`), the int8
    products summed exactly, then `float32(sum) * (sx * sw) + bias`, as the
    JAX package computes it; `transpose` for an (I, O, K) transposed-conv
    weight."""
    xq, sx = quantize_dynamic(x, (1, 2))  # (B, 1, 1)
    if transpose:
        wq, sw = quantize_dynamic(weight, (0, 2))  # (1, O, 1)
        acc = int8_conv_transpose1d(xq, wq, stride)
    else:
        wq, sw = quantize_dynamic(weight, (1, 2))  # (O, 1, 1)
        acc = int8_conv1d(xq, wq, stride, dilation, padding, groups)
    y = acc.float() * (sx * sw.reshape(1, 1, -1))
    return y if bias is None else y + bias


def conv1d_ntc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               stride: int = 1, dilation: int = 1, padding: int = 0,
               exact: bool = False, groups: int = 1) -> torch.Tensor:
    """1-D conv over NTC input with a (O, I / groups, K) weight, under the
    precision policy unless `exact`. A pointwise conv is a matmul over
    channels and runs as one, as in the JAX package."""
    pointwise = weight.shape[-1] == 1 and stride == 1 and padding == 0 and groups == 1
    if not exact and is_int8(weight.shape[1] * weight.shape[2]):
        return w8a8_conv(x, weight, bias, stride=stride, dilation=dilation, padding=padding,
                         groups=groups)
    if not exact and compute_dtype() == torch.bfloat16:
        if pointwise:
            return bf16_op(lambda a, w: F.linear(a, w[:, :, 0]), x, weight, bias)
        return bf16_op(lambda a, w: F.conv1d(a.transpose(1, 2), w, stride=stride,
                                             padding=padding, dilation=dilation,
                                             groups=groups).transpose(1, 2),
                       x, weight, bias)
    if exact:
        x = x.float()
    if pointwise:
        return F.linear(x, weight[:, :, 0], bias)
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d_ntc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                         stride: int) -> torch.Tensor:
    """Transposed conv over NTC input with a (I, O, K) weight, untrimmed,
    under the precision policy."""
    def fn(a, w):
        return F.conv_transpose1d(a.transpose(1, 2), w, stride=stride).transpose(1, 2)

    if is_int8(weight.shape[0] * weight.shape[2]):
        return w8a8_conv(x, weight, bias, transpose=True, stride=stride)
    if compute_dtype() == torch.bfloat16:
        return bf16_op(fn, x, weight, bias)
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride=stride)
    return y.transpose(1, 2)


class _WeightNormConv(nn.Module):
    """Holds `weight_g`/`weight_v` (or a plain `weight`) and `bias`."""

    def _init_weight(self, shape: Tuple[int, ...], weight_norm: bool, out_channels: int):
        if weight_norm:
            self.weight_v = nn.Parameter(torch.empty(shape))
            self.weight_g = nn.Parameter(torch.empty(shape[0], *(1,) * (len(shape) - 1)))
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
                 padding: int = 0, weight_norm: bool = False, exact: bool = False,
                 dilation: int = 1, stride: int = 1, groups: int = 1):
        super().__init__()
        self.padding, self.exact, self.dilation = padding, exact, dilation
        self.stride, self.groups = stride, groups
        self._init_weight((out_channels, in_channels // groups, kernel_size), weight_norm,
                          out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_ntc(x, self.effective_weight(), self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation, exact=self.exact,
                          groups=self.groups)


class Conv2d(_WeightNormConv):
    """torch-style Conv2d with symmetric zero padding, NCHW activations."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0),
                 weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self._init_weight((out_channels, in_channels, *kernel_size), weight_norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.effective_weight(), self.bias, stride=self.stride,
                        padding=self.padding)


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
