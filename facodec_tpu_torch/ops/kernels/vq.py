"""VQ nearest-code search: CUDA kernel wrapper over the plain version.

Port of facodec_tpu/ops/pallas/vq.py `nearest_code_pallas`. `nearest_code`
runs `ops.vq_math.nearest_code` for tensors on the CPU; for CUDA tensors it
launches csrc/vq.cu or raises. Returns (indices int32, the gathered
un-normalised codebook rows). Forward only: the slice serves.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.kernels import build

CODE_DIM = 8  # codebook_dim of every FAcodec quantizer; the kernel's row width


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

    lead = encodings.shape[:-1]
    M, N = encodings.numel() // CODE_DIM, codebook.shape[0]
    idx = torch.empty(lead, dtype=torch.int32, device=encodings.device)
    zq = torch.empty_like(encodings)
    if M == 0:
        return idx, zq

    fn = build.library("vq").facodec_vq_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(encodings.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(encodings.data_ptr(), codebook.data_ptr(), M, N, idx.data_ptr(),
                 zq.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nearest_code: kernel launch failed, cudaError {err}")
    nearest_code.launches += 1
    return idx, zq


nearest_code.launches = 0
