"""Fused DAC residual unit: CUDA kernel wrapper and its plain PyTorch version.

Port of facodec_tpu/ops/pallas/resunit.py. Computes

    out = x + conv1x1(snake2(conv7_dilated(snake1(pad(x))))),

x NTC (B, T, C) float32, with the effective (weight-normed) torch-layout
weights w7 (C, C, 7) and w1 (C, C, 1) and alphas of shape (1, C, 1). The pad
is SConv1d's: reflect, (6d, 0) when causal, split otherwise.

`fused_residual_unit` runs `residual_unit_reference` for a tensor on the
CPU; for a CUDA tensor it launches csrc/resunit.cu (3xTF32 tensor cores,
with a scratch buffer for the block-local snake1 and y2 rows) or raises.
On the card the float32 entry is a `torch.autograd.Function`: its forward
is the kernel, and its backward is the JAX package's `_bwd`, the gradient
of the plain composition recomputed from the saved inputs, for x, w7, b7,
w1, b1 and both alphas (the weights are the effective weight-norm weights,
so the gradient flows on through the weight norm in autograd).

A bf16 x (the decoder under the `bfloat16_act` policy) goes to the
kernel's bf16 entry, with its own launch count
(`fused_residual_unit.bf16_launches`; `launches` counts the float32
entry): bf16 operands, float32 sums, rounded where the JAX package's
default path rounds (csrc/resunit.cu). Its plain version is
`residual_unit_reference` under that policy; the weights, biases and
alphas stay float32 parameters, and the policy rounds them. The bf16 entry
and the halo entry below are forward only (the hybrid decode and streams
serve): asked for a gradient, they raise.

`fused_residual_unit_stream` runs one chunk of a causal stream through the
kernel's halo entry (plain version `residual_unit_stream_reference`): the
left pad is the carried halo, the last 6d rows of the previous chunk's
padded snake1 input, (B, 6d, C), which is the JAX package's stream state of
the unit's conv7; on a stream's first chunk (halo None) it is the causal
reflect. It returns the output and the new halo.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from facodec_tpu_torch.nn.activations import snake
from facodec_tpu_torch.nn.conv import conv1d_ntc
from facodec_tpu_torch.ops.kernels import build
from facodec_tpu_torch.ops.padding import pad1d
from facodec_tpu_torch.ops.precision import policy


def _pads(dilation: int, causal: bool) -> Tuple[int, int]:
    halo = 6 * dilation
    return (halo, 0) if causal else (halo - halo // 2, halo // 2)


def residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                            causal: bool) -> torch.Tensor:
    """The plain composition (the JAX package's `_reference`); a bf16 x runs
    under the `bfloat16_act` policy, whose convs round as the kernel's bf16
    entry does."""
    C = x.shape[-1]
    with policy("bfloat16_act" if x.dtype == torch.bfloat16 else None):
        y = snake(x, alpha1.reshape(1, 1, C))
        y = pad1d(y, _pads(dilation, causal))
        y = conv1d_ntc(y, w7, b7, dilation=dilation)
        y = snake(y, alpha2.reshape(1, 1, C))
        return x + conv1d_ntc(y, w1, b1)


def bf16_error_scale(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                     causal: bool) -> torch.Tensor:
    """Per element of a bf16 unit's output, the magnitude whose bf16 ulp
    measures a difference between two evaluations of the unit: the largest
    term of its last sums, max(|x|, |out|, |b1|, |W1| . |s2|). Two summation
    orders can round a sum one ulp apart; such a step in s2 moves W1 . s2 by
    up to |W1| . ulp(s2), and reaches the output unchanged where the 1x1's
    products or x + y cancel. |W1| . |s2| bounds the 1x1's terms as a
    rounding-error analysis of a sum does."""
    C = x.shape[-1]
    with policy("bfloat16_act"):
        y = snake(x, alpha1.reshape(1, 1, C))
        y = conv1d_ntc(pad1d(y, _pads(dilation, causal)), w7, b7, dilation=dilation)
        s2 = snake(y, alpha2.reshape(1, 1, C))
        terms = conv1d_ntc(s2.float().abs(), w1.to(torch.bfloat16).float().abs(), None,
                           exact=True)
        out = residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
    parts = (x.float().abs(), out.float().abs(), terms, b1.abs().expand_as(terms))
    return torch.stack(parts).amax(dim=0)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """|got - want| in bf16 ulps (8 significand bits) at `scale`."""
    tiny = torch.finfo(torch.float32).tiny
    ulp = torch.exp2(torch.floor(torch.log2(scale.double().clamp_min(tiny))) - 7)
    return (got.double() - want.double()).abs() / ulp


def residual_unit_stream_reference(x, halo, w7, b7, w1, b1, alpha1, alpha2,
                                   dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain streamed unit (the JAX package's unfused streamed
    `ResidualUnit`): (out, new_halo)."""
    C, H = x.shape[-1], 6 * dilation
    y = snake(x, alpha1.reshape(1, 1, C))
    y = pad1d(y, (H, 0)) if halo is None else torch.cat([halo, y], dim=1)
    new_halo = y[:, y.shape[1] - H:].contiguous()
    y = conv1d_ntc(y, w7, b7, dilation=dilation)
    y = snake(y, alpha2.reshape(1, 1, C))
    return x + conv1d_ntc(y, w1, b1), new_halo


@functools.lru_cache(maxsize=None)
def _entry_points():
    """(one-shot entry, halo entry, bf16 entry, scratch size) from
    csrc/resunit.cu, typed once per process."""
    lib = build.library("resunit")
    size = lib.facodec_resunit_scratch_floats
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    fn = lib.facodec_resunit_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    halo_fn = lib.facodec_resunit_halo_f32
    halo_fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    halo_fn.restype = ctypes.c_int
    bf16_fn = lib.facodec_resunit_bf16
    bf16_fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bf16_fn.restype = ctypes.c_int
    return fn, halo_fn, bf16_fn, size


def _check(who: str, name: str, t: Optional[torch.Tensor], shape, device,
           dtypes=(torch.float32,)) -> None:
    if t is None:
        raise ValueError(f"{who}: {name} is required")
    if t.dtype not in dtypes:
        raise TypeError(f"{who}: {name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, x on {device}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_unit(who: str, x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                x_dtypes=(torch.float32,)) -> None:
    if x.ndim != 3:
        raise ValueError(f"{who}: x must be (B, T, C), got {tuple(x.shape)}")
    C = x.shape[-1]
    _check(who, "x", x, x.shape, x.device, x_dtypes)
    for name, t, shape in (("w7", w7, (C, C, 7)), ("b7", b7, (C,)),
                           ("w1", w1, (C, C, 1)), ("b1", b1, (C,)),
                           ("alpha1", alpha1, (1, C, 1)), ("alpha2", alpha2, (1, C, 1))):
        _check(who, name, t, shape, x.device)
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: x must be contiguous")
    if C % 32:
        raise ValueError(f"{who}: the kernel takes C % 32 == 0, got C={C}")
    if dilation < 1:
        raise ValueError(f"{who}: dilation must be >= 1, got {dilation}")


def _kernel_operands(x, w7, b7, w1, b1, alpha1, alpha2):
    """The operands as the kernel reads them: x and every weight in its torch
    layout, as given, with 16-byte loads; the snake reciprocals as `snake`
    takes them."""
    x, w7, w1 = (_aligned16(t.contiguous()) for t in (x, w7, w1))
    b7, b1, alpha1, alpha2 = (t.contiguous() for t in (b7, b1, alpha1, alpha2))
    recip1, recip2 = (1.0 / (a + 1e-9) for a in (alpha1, alpha2))
    return x, w7, b7, w1, b1, alpha1, recip1, alpha2, recip2


def _wants_grad(who: str, *tensors) -> None:
    """Raise where autograd would need a gradient of a forward-only entry."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{who}: this entry is forward only; run it under torch.no_grad() "
                           "(the float32 one-shot entry carries gradients)")


def fused_residual_unit(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                        causal: bool) -> torch.Tensor:
    """out = x + conv1x1(snake(conv7(snake(x)))) in one kernel on the card;
    x float32 (with gradients), or bf16 for the bf16 entry (forward only)."""
    _check_unit("fused_residual_unit", x, w7, b7, w1, b1, alpha1, alpha2, dilation,
                (torch.float32, torch.bfloat16))
    if x.device.type == "cpu":
        return residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
    if x.dtype == torch.bfloat16:
        _wants_grad("fused_residual_unit (bf16 entry)", x, w7, b7, w1, b1, alpha1, alpha2)
        pl, ext = _reflect_extent(x.shape[1], dilation, causal)
        return _launch_bf16(x, w7, b7, w1, b1, alpha1, alpha2, dilation, pl, ext)
    return _ResidualUnitFn.apply(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)


def _reflect_extent(T: int, dilation: int, causal: bool) -> Tuple[int, int]:
    """(left pad, rows the kernel reflects over): the kernel reflects x's
    rows itself, as `pad1d` pads, and a short input is zero-extended to one
    row more than the longer pad first."""
    pl, pr = _pads(dilation, causal)
    return pl, (T if T > max(pl, pr) else max(pl, pr) + 1)


class _ResidualUnitFn(torch.autograd.Function):
    """The float32 entry on the card: the kernel forward, the recomputed
    plain composition's gradient backward."""

    @staticmethod
    def forward(ctx, x, w7, b7, w1, b1, alpha1, alpha2, dilation: int, causal: bool):
        ctx.save_for_backward(x, w7, b7, w1, b1, alpha1, alpha2)
        ctx.dilation, ctx.causal = dilation, causal
        return _launch_f32(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = residual_unit_reference(*leaves, ctx.dilation, ctx.causal)
            wanted = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if n else None for n in needs), None, None)


def _launch_f32(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int, causal: bool) -> torch.Tensor:
    B, T, C = x.shape
    pl, ext = _reflect_extent(T, dilation, causal)
    ops = _kernel_operands(x, w7, b7, w1, b1, alpha1, alpha2)
    out = torch.empty_like(ops[0])
    fn, _, _, size = _entry_points()
    with torch.cuda.device(x.device):
        # per block: its snake1 rows and its y2 rows (csrc/resunit.cu)
        scratch = torch.empty(size(B, T, C, dilation), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in ops), out.data_ptr(), scratch.data_ptr(), B, T, C,
                 dilation, pl, ext, stream)
    if err != 0:
        raise RuntimeError(f"fused_residual_unit: kernel launch failed, cudaError {err}")
    fused_residual_unit.launches += 1
    return out


fused_residual_unit.launches = 0
fused_residual_unit.bf16_launches = 0


def _launch_bf16(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int, pad_left: int,
                 ext: int) -> torch.Tensor:
    """The bf16 entry: the weights and biases rounded to bf16 as the policy
    rounds them, w7 as (out, tap, in); the snake parameters float32."""
    B, T, C = x.shape
    bf16 = torch.bfloat16
    x = _aligned16(x)
    w7t = w7.permute(0, 2, 1).to(bf16).contiguous()
    w1b = w1[:, :, 0].to(bf16).contiguous()
    b7b, b1b = b7.to(bf16).contiguous(), b1.to(bf16).contiguous()
    alpha1, alpha2 = alpha1.contiguous(), alpha2.contiguous()
    recip1, recip2 = (1.0 / (a + 1e-9) for a in (alpha1, alpha2))
    out = torch.empty_like(x)
    _, _, fn, size = _entry_points()
    with torch.cuda.device(x.device):
        scratch = torch.empty(size(B, T, C, dilation), dtype=bf16, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (x, w7t, b7b, w1b, b1b, alpha1, recip1, alpha2, recip2,
                                          out, scratch)),
                 B, T, C, dilation, pad_left, ext, stream)
    if err != 0:
        raise RuntimeError(f"fused_residual_unit: bf16 kernel launch failed, cudaError {err}")
    fused_residual_unit.bf16_launches += 1
    return out


def fused_residual_unit_stream(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of a causal stream: (out, new_halo), both (B, ., C); halo is
    (B, 6d, C), or None on the stream's first chunk, which must be longer
    than 6d rows (the one-shot reflect, without its short-input extension)."""
    who = "fused_residual_unit_stream"
    _check_unit(who, x, w7, b7, w1, b1, alpha1, alpha2, dilation)
    if x.device.type == "cuda":
        _wants_grad(who, x, halo, w7, b7, w1, b1, alpha1, alpha2)
    B, T, C = x.shape
    H = 6 * dilation
    if halo is None:
        if T <= H:
            raise ValueError(f"{who}: a stream's first chunk needs T > 6d = {H}, got T={T}")
    else:
        _check(who, "halo", halo, (B, H, C), x.device)
    if x.device.type == "cpu":
        return residual_unit_stream_reference(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation)
    if halo is not None and not halo.is_contiguous():
        raise ValueError(f"{who}: halo must be contiguous")
    ops = _kernel_operands(x, w7, b7, w1, b1, alpha1, alpha2)
    halo = None if halo is None else _aligned16(halo)
    out = torch.empty_like(ops[0])
    new_halo = torch.empty(B, H, C, dtype=torch.float32, device=x.device)
    _, fn, _, size = _entry_points()
    with torch.cuda.device(x.device):
        scratch = torch.empty(size(B, T, C, dilation), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ops[0].data_ptr(), None if halo is None else halo.data_ptr(),
                 *(t.data_ptr() for t in ops[1:]), out.data_ptr(), new_halo.data_ptr(),
                 scratch.data_ptr(), B, T, C, dilation, stream)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed, cudaError {err}")
    fused_residual_unit_stream.launches += 1
    return out, new_halo


fused_residual_unit_stream.launches = 0
