"""The CUDA kernels as `torch.library` custom ops (namespace `facodec`).

Each kernel entry is one op, so that PyTorch's tracers (`torch.export`)
see it as one node and never reach its `data_ptr()` calls:

  facodec::resunit_f32(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
      -> out                      csrc/resunit.cu, the float32 one-shot entry
  facodec::resunit_bf16(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2,
                        dilation, causal)
      -> out                      csrc/resunit_bf16.cu, on `pack_bf16`'s tensors
  facodec::nearest_code(encodings, codebook)
      -> (zq, indices int32)      csrc/vq.cu (zq first: `opcheck` sums the
                                  outputs into the first one's dtype)
  facodec::resunit_halo_f32(x, halo?, w7, b7, w1, b1, alpha1, alpha2, dilation)
      -> (out, new_halo)          csrc/resunit.cu, the halo entry

Every op has three implementations: a fake one (shapes and dtypes only,
for tracing), a CUDA one that launches its kernel (the launchers in
resunit.py and vq.py, which count the launches) or raises, and a CPU one
that is the plain PyTorch version. No other device has one, and nothing
catches a build or launch failure. Eagerly, the wrappers in resunit.py and
vq.py run the plain version of a CPU tensor themselves, without the op's
dispatch; a program exported on the CPU holds the ops.

The float32 entry and the VQ search carry gradients (`register_autograd`):
the residual unit's is the plain composition's, recomputed from the saved
inputs (the JAX package's `_bwd`); the search passes none to the latents
and scatter-adds the rows' cotangent into the codebook rows it selected
(`index_add`, the counterpart of `segment_sum`). The bf16 and halo entries
are forward only.

The bf16 entry takes the packed weights as tensors; its CUDA implementation
encodes the two TMA tensor maps itself (`resunit.tma_maps`, kept per
packed weights' address), so a pack made by graph ops in an exported
program serves the kernel as one kept by `models.dac.ResidualUnit` does.

Import this module (the `ops.kernels` package does) before loading an
exported program that holds these ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.kernels import resunit, vq


def _new_like(x: Tensor) -> Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# ------------------------------------------------- float32 one-shot entry
@torch.library.custom_op("facodec::resunit_f32", mutates_args=(), device_types="cpu")
def resunit_f32(x: Tensor, w7: Tensor, b7: Tensor, w1: Tensor, b1: Tensor, alpha1: Tensor,
                alpha2: Tensor, dilation: int, causal: bool) -> Tensor:
    return resunit.residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation,
                                           causal).contiguous()


@resunit_f32.register_kernel("cuda")
def _resunit_f32_cuda(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal):
    return resunit.launch_f32(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)


@resunit_f32.register_fake
def _resunit_f32_fake(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal):
    return _new_like(x)


def _resunit_f32_setup(ctx, inputs, output):
    *tensors, dilation, causal = inputs
    ctx.save_for_backward(*tensors)
    ctx.dilation, ctx.causal = dilation, causal


def _resunit_f32_backward(ctx, g):
    needs = ctx.needs_input_grad[:7]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        out = resunit.residual_unit_reference(*leaves, ctx.dilation, ctx.causal)
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, g))
    return (*(next(grads) if n else None for n in needs), None, None)


resunit_f32.register_autograd(_resunit_f32_backward, setup_context=_resunit_f32_setup)


# ------------------------------------------------------------ bf16 entry
@torch.library.custom_op("facodec::resunit_bf16", mutates_args=(), device_types="cpu")
def resunit_bf16(x: Tensor, w7: Tensor, w1: Tensor, b7: Tensor, b1: Tensor, alpha1: Tensor,
                 recip1: Tensor, alpha2: Tensor, recip2: Tensor, dilation: int,
                 causal: bool) -> Tensor:
    # the plain version on the packed operands: they are the bf16 roundings
    # the policy makes of the float32 weights, which it leaves as they are
    C = x.shape[-1]
    w7 = w7.reshape(C, 7, C).permute(0, 2, 1)
    return resunit.residual_unit_reference(x, w7, b7, w1[:, :, None], b1, alpha1.reshape(1, C, 1),
                                           alpha2.reshape(1, C, 1), dilation, causal).contiguous()


@resunit_bf16.register_kernel("cuda")
def _resunit_bf16_cuda(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2, dilation, causal):
    pl, ext = resunit.reflect_extent(x.shape[1], dilation, causal)
    pack = resunit.Bf16Pack(w7, w1, b7, b1, alpha1, recip1, alpha2, recip2)
    return resunit.launch_bf16(resunit.aligned16(x.contiguous()), pack, dilation, pl, ext)


@resunit_bf16.register_fake
def _resunit_bf16_fake(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2, dilation, causal):
    return _new_like(x)


# ------------------------------------------------------------- VQ search
@torch.library.custom_op("facodec::nearest_code", mutates_args=(), device_types="cpu")
def nearest_code(encodings: Tensor, codebook: Tensor) -> Tuple[Tensor, Tensor]:
    idx, zq = vq_math.nearest_code(encodings, codebook)
    return zq, idx


@nearest_code.register_kernel("cuda")
def _nearest_code_cuda(encodings, codebook):
    idx, zq = vq.launch(encodings, codebook)
    return zq, idx


@nearest_code.register_fake
def _nearest_code_fake(encodings, codebook):
    return (_new_like(encodings),
            encodings.new_empty(encodings.shape[:-1], dtype=torch.int32))


def _nearest_code_setup(ctx, inputs, output):
    encodings, codebook = inputs
    _, idx = output
    ctx.mark_non_differentiable(idx)
    ctx.save_for_backward(idx)
    ctx.shapes = encodings.shape, codebook.shape


def _nearest_code_backward(ctx, g_zq, _g_idx):
    (idx,) = ctx.saved_tensors
    enc_shape, cb_shape = ctx.shapes
    g_enc = g_cb = None
    if ctx.needs_input_grad[0]:
        g_enc = g_zq.new_zeros(enc_shape)
    if ctx.needs_input_grad[1]:
        g_cb = g_zq.new_zeros(cb_shape).index_add(0, idx.reshape(-1).long(),
                                                  g_zq.reshape(-1, cb_shape[1]))
    return g_enc, g_cb


nearest_code.register_autograd(_nearest_code_backward, setup_context=_nearest_code_setup)


# ------------------------------------------------------------ halo entry
@torch.library.custom_op("facodec::resunit_halo_f32", mutates_args=(), device_types="cpu")
def resunit_halo_f32(x: Tensor, halo: Optional[Tensor], w7: Tensor, b7: Tensor, w1: Tensor,
                     b1: Tensor, alpha1: Tensor, alpha2: Tensor,
                     dilation: int) -> Tuple[Tensor, Tensor]:
    out, new_halo = resunit.residual_unit_stream_reference(x, halo, w7, b7, w1, b1, alpha1,
                                                           alpha2, dilation)
    return out.contiguous(), new_halo.clone()


@resunit_halo_f32.register_kernel("cuda")
def _resunit_halo_f32_cuda(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation):
    return resunit.launch_halo(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation)


@resunit_halo_f32.register_fake
def _resunit_halo_f32_fake(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation):
    B, _, C = x.shape
    return _new_like(x), x.new_empty(B, 6 * dilation, C)
