"""VQ nearest-code search: CUDA kernel wrapper over the plain version.

Port of facodec_tpu/ops/pallas/vq.py `nearest_code_pallas`. `nearest_code`
checks its operands and calls the custom op `facodec::nearest_code`
(ops.py), which launches csrc/vq.cu (`launch`) for CUDA tensors, or raises.
For CPU tensors it runs `ops.vq_math.nearest_code` itself, through the op
(whose CPU implementation that is) only while a program is being exported. Returns
(indices int32, the gathered un-normalised codebook rows). The op carries
the JAX package's VJP (`vq.py` `_bwd`): no gradient reaches the latents
through the search (their gradient is zero), and the rows' cotangent is
scatter-added into the codebook rows that were selected (`index_add`, the
counterpart of `segment_sum`).

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
    if encodings.device.type == "cpu" and not torch.compiler.is_exporting():
        return vq_math.nearest_code(encodings, codebook)
    if encodings.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nearest_code: no kernel for device {encodings.device}")
    if encodings.device.type == "cuda":
        if codebook.shape[1] != CODE_DIM:
            raise ValueError(f"nearest_code: the kernel takes D={CODE_DIM}, "
                             f"got {codebook.shape[1]}")
        if not (encodings.is_contiguous() and codebook.is_contiguous()):
            raise ValueError("nearest_code: encodings and codebook must be contiguous")
    zq, idx = torch.ops.facodec.nearest_code(encodings, codebook)
    return idx, zq


def launch(encodings: torch.Tensor, codebook: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One search on CUDA tensors (the CUDA implementation of
    `facodec::nearest_code`)."""
    encodings, codebook = encodings.contiguous(), codebook.contiguous()
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
    build.count_launch(nearest_code)
    return idx, zq


nearest_code.launches = 0
