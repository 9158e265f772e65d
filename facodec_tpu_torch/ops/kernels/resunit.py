"""Fused DAC residual unit: CUDA kernel wrapper and its plain PyTorch version.

Port of facodec_tpu/ops/pallas/resunit.py. Computes

    out = x + conv1x1(snake2(conv7_dilated(snake1(pad(x))))),

x NTC (B, T, C) float32, with the effective (weight-normed) torch-layout
weights w7 (C, C, 7) and w1 (C, C, 1) and alphas of shape (1, C, 1). The pad
is SConv1d's: reflect, (6d, 0) when causal, split otherwise.

`fused_residual_unit` runs `residual_unit_reference` for a tensor on the
CPU; for a CUDA tensor it launches csrc/resunit.cu or raises. Forward only:
the slice serves, and no autograd is attached.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from facodec_tpu_torch.nn.activations import snake
from facodec_tpu_torch.nn.conv import conv1d_ntc
from facodec_tpu_torch.ops.kernels import build
from facodec_tpu_torch.ops.padding import pad1d

MAX_CHANNELS = 1024  # y2 tile (32 rows x C floats) plus staging fits shared memory


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


def _check(name: str, t: Optional[torch.Tensor], shape, device) -> None:
    if t is None:
        raise ValueError(f"fused_residual_unit: {name} is required")
    if t.dtype != torch.float32:
        raise TypeError(f"fused_residual_unit: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_residual_unit: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fused_residual_unit: {name} is on {t.device}, x on {device}")


def fused_residual_unit(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                        causal: bool) -> torch.Tensor:
    """out = x + conv1x1(snake(conv7(snake(x)))) in one kernel on the card."""
    if x.ndim != 3:
        raise ValueError(f"fused_residual_unit: x must be (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    for name, t, shape in (("x", x, x.shape), ("w7", w7, (C, C, 7)), ("b7", b7, (C,)),
                           ("w1", w1, (C, C, 1)), ("b1", b1, (C,)),
                           ("alpha1", alpha1, (1, C, 1)), ("alpha2", alpha2, (1, C, 1))):
        _check(name, t, shape, x.device)
    if x.device.type == "cpu":
        return residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_unit: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_residual_unit: x must be contiguous")
    if C % 32 or C > MAX_CHANNELS:
        raise ValueError(f"fused_residual_unit: the kernel takes C % 32 == 0 and "
                         f"C <= {MAX_CHANNELS}, got C={C}")
    if dilation < 1:
        raise ValueError(f"fused_residual_unit: dilation must be >= 1, got {dilation}")

    pl, pr = _pads(dilation, causal)
    xp = pad1d(x, (pl, pr)).contiguous()
    # the kernel reads every weight in its torch layout, as given
    w7, b7, w1, b1, alpha1, alpha2 = (t.contiguous() for t in (w7, b7, w1, b1, alpha1, alpha2))
    recip1, recip2 = (1.0 / (a + 1e-9) for a in (alpha1, alpha2))  # as `snake` takes them
    out = torch.empty_like(x)

    lib = build.library("resunit")
    fn = lib.facodec_resunit_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w7.data_ptr(), b7.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 alpha1.data_ptr(), recip1.data_ptr(), alpha2.data_ptr(), recip2.data_ptr(),
                 out.data_ptr(), B, T, xp.shape[1], C, dilation, pl, stream)
    if err != 0:
        raise RuntimeError(f"fused_residual_unit: kernel launch failed, cudaError {err}")
    fused_residual_unit.launches += 1
    return out


fused_residual_unit.launches = 0
