"""Fused DAC residual unit: CUDA kernel wrapper and its plain PyTorch version.

Port of facodec_tpu/ops/pallas/resunit.py. Computes

    out = x + conv1x1(snake2(conv7_dilated(snake1(pad(x))))),

x NTC (B, T, C) float32, with the effective (weight-normed) torch-layout
weights w7 (C, C, 7) and w1 (C, C, 1) and alphas of shape (1, C, 1). The pad
is SConv1d's: reflect, (6d, 0) when causal, split otherwise.

`fused_residual_unit` runs `residual_unit_reference` for a tensor on the
CPU; for a CUDA tensor it launches csrc/resunit.cu (3xTF32 tensor cores,
with a scratch buffer for the block-local snake1 and y2 rows) or raises.
Forward only: the slice serves, and no autograd is attached.

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


def _pads(dilation: int, causal: bool) -> Tuple[int, int]:
    halo = 6 * dilation
    return (halo, 0) if causal else (halo - halo // 2, halo // 2)


def residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                            causal: bool) -> torch.Tensor:
    """The plain composition (the JAX package's `_reference`)."""
    C = x.shape[-1]
    y = snake(x, alpha1.reshape(1, 1, C))
    y = pad1d(y, _pads(dilation, causal))
    y = conv1d_ntc(y, w7, b7, dilation=dilation)
    y = snake(y, alpha2.reshape(1, 1, C))
    return x + conv1d_ntc(y, w1, b1)


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
    """(one-shot entry, halo entry, scratch size) from csrc/resunit.cu,
    typed once per process."""
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
    return fn, halo_fn, size


def _check(who: str, name: str, t: Optional[torch.Tensor], shape, device) -> None:
    if t is None:
        raise ValueError(f"{who}: {name} is required")
    if t.dtype != torch.float32:
        raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, x on {device}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_unit(who: str, x, w7, b7, w1, b1, alpha1, alpha2, dilation: int) -> None:
    if x.ndim != 3:
        raise ValueError(f"{who}: x must be (B, T, C), got {tuple(x.shape)}")
    C = x.shape[-1]
    for name, t, shape in (("x", x, x.shape), ("w7", w7, (C, C, 7)), ("b7", b7, (C,)),
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


def fused_residual_unit(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                        causal: bool) -> torch.Tensor:
    """out = x + conv1x1(snake(conv7(snake(x)))) in one kernel on the card."""
    _check_unit("fused_residual_unit", x, w7, b7, w1, b1, alpha1, alpha2, dilation)
    if x.device.type == "cpu":
        return residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
    B, T, C = x.shape
    pl, pr = _pads(dilation, causal)
    # the kernel reflects x's rows itself, as `pad1d` pads: a short input is
    # zero-extended to one row more than the longer pad first
    ext = T if T > max(pl, pr) else max(pl, pr) + 1
    ops = _kernel_operands(x, w7, b7, w1, b1, alpha1, alpha2)
    out = torch.empty_like(ops[0])
    fn, _, size = _entry_points()
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


def fused_residual_unit_stream(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of a causal stream: (out, new_halo), both (B, ., C); halo is
    (B, 6d, C), or None on the stream's first chunk, which must be longer
    than 6d rows (the one-shot reflect, without its short-input extension)."""
    who = "fused_residual_unit_stream"
    _check_unit(who, x, w7, b7, w1, b1, alpha1, alpha2, dilation)
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
    _, fn, size = _entry_points()
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
