"""VQ nearest-code search: CUDA kernel wrapper over the plain version.

Port of facodec_tpu/ops/pallas/vq.py `nearest_code_pallas`. `nearest_code`
runs `ops.vq_math.nearest_code` for tensors on the CPU; for CUDA tensors it
launches csrc/vq.cu or raises. Returns (indices int32, the gathered
un-normalised codebook rows). On the card it is a `torch.autograd.Function`
with the JAX package's VJP (`vq.py` `_bwd`): no gradient reaches the
latents through the search (their gradient is zero), and the rows'
cotangent is scatter-added into the codebook rows that were selected
(`index_add_`, the counterpart of `segment_sum`), as the plain gather's
gradient is on the CPU.

One call launches two kernels on the current stream. The first normalises
the codebook once into a scratch that this wrapper allocates: two float4
planes of the normalised rows and their squared norms, padded to a multiple
of 64 codes. The second, a programmatic dependent launch, scores 32 latent
rows per block of 8 warps; each warp stages its own 128-code span of every
1024-code chunk into shared memory and splits it over 8 code-lanes x 4
row-lanes, 8 rows a lane. The launch count goes up by one per call, not per
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.kernels import build

CODE_DIM = 8  # codebook_dim of every FAcodec quantizer; the kernel's row width


@functools.lru_cache(maxsize=None)
def _entry_points():
    """(search, scratch size) from csrc/vq.cu, typed once per process."""
    lib = build.library("vq")
    size = lib.facodec_vq_scratch_floats
    size.argtypes = [ctypes.c_int]
    size.restype = ctypes.c_longlong
    fn = lib.facodec_vq_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, size


def nearest_code(
    encodings: torch.Tensor, codebook: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """encodings (..., D), codebook (N, D) -> (indices (...,), quantized (..., D))."""
    if codebook.ndim != 2 or encodings.shape[-1] != codebook.shape[1]:
        raise ValueError(f"nearest_code: encodings {tuple(encodings.shape)} do not match "
                         f"codebook {tuple(codebook.shape)}")
    for name, t in (("encodings", encodings), ("codebook", codebook)):
        if t.dtype != torch.float32:
            raise TypeError(f"nearest_code: {name} must be float32, got {t.dtype}")
    if encodings.device != codebook.device:
        raise ValueError(f"nearest_code: encodings on {encodings.device}, "
                         f"codebook on {codebook.device}")
    if encodings.device.type == "cpu":
        return vq_math.nearest_code(encodings, codebook)
    if encodings.device.type != "cuda":
        raise ValueError(f"nearest_code: no kernel for device {encodings.device}")
    if codebook.shape[1] != CODE_DIM:
        raise ValueError(f"nearest_code: the kernel takes D={CODE_DIM}, got {codebook.shape[1]}")
    if not (encodings.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("nearest_code: encodings and codebook must be contiguous")
    return _NearestCodeFn.apply(encodings, codebook)


class _NearestCodeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, encodings: torch.Tensor, codebook: torch.Tensor):
        idx, zq = _launch(encodings, codebook)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(idx)
        ctx.shapes = encodings.shape, codebook.shape
        return idx, zq

    @staticmethod
    def backward(ctx, _g_idx, g_zq):
        (idx,) = ctx.saved_tensors
        enc_shape, cb_shape = ctx.shapes
        g_enc = g_cb = None
        if ctx.needs_input_grad[0]:
            g_enc = g_zq.new_zeros(enc_shape)
        if ctx.needs_input_grad[1]:
            g_cb = g_zq.new_zeros(cb_shape).index_add_(
                0, idx.reshape(-1).long(), g_zq.reshape(-1, cb_shape[1]))
        return g_enc, g_cb


def _launch(encodings: torch.Tensor, codebook: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    lead = encodings.shape[:-1]
    M, N = encodings.numel() // CODE_DIM, codebook.shape[0]
    idx = torch.empty(lead, dtype=torch.int32, device=encodings.device)
    zq = torch.empty_like(encodings)
    if M == 0:
        return idx, zq

    fn, size = _entry_points()
    with torch.cuda.device(encodings.device):
        scratch = torch.empty(size(N), dtype=torch.float32, device=encodings.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(encodings.data_ptr(), codebook.data_ptr(), M, N, idx.data_ptr(),
                 zq.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nearest_code: kernel launch failed, cudaError {err}")
    nearest_code.launches += 1
    return idx, zq


nearest_code.launches = 0
