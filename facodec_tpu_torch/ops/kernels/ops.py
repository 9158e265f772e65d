"""The CUDA kernels as `torch.library` custom ops (namespace `facodec`).

Each kernel entry is one op, so that PyTorch's tracers (`torch.export`)
see it as one node and never reach its `data_ptr()` calls:

  facodec::resunit_f32(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
      -> out                      csrc/resunit.cu, the float32 one-shot entry
  facodec::resunit_bf16(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2,
                        dilation, causal)
      -> out                      csrc/resunit_bf16.cu, on `pack_bf16`'s tensors
                                  (gradient by `register_autograd`)
  facodec::nearest_code(encodings, codebook)
      -> (zq, indices int32)      csrc/vq.cu (zq first: `opcheck` sums the
                                  outputs into the first one's dtype)
  facodec::resunit_halo_f32(x, halo?, w7, b7, w1, b1, alpha1, alpha2, dilation)
      -> (out, new_halo)          csrc/resunit.cu, the halo entry
  facodec::resunit_bf16_f32io(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2,
                              dilation, causal, act)
      -> out                      csrc/resunit_bf16.cu, float32 in and out
                                  (`bfloat16`'s rounding, or with `act` the
                                  bf16 entry's), on a pack with float32 biases
  facodec::resunit_int8_amax(x, alpha1, recip1)
      -> amax (B,)                csrc/resunit_int8.cu, max |snake1(x)| per row
  facodec::resunit_int8(x, amax, q7, sw, w1, b7, b1, alpha1, recip1, alpha2,
                        recip2, dilation, causal)
      -> out                      csrc/resunit_int8.cu, on `pack_int8`'s tensors
  facodec::lstm_int8(x_proj, w_q, w_scale, h0, c0)
      -> (y, hT, cT)              csrc/lstm_int8.cu, one LSTM layer's W8A8
                                  recurrence (lstm.py)

Every op has three implementations: a fake one (shapes and dtypes only,
for tracing), a CUDA one that launches its kernel (the launchers in
resunit.py, vq.py and lstm.py, which count the launches) or raises, and a
CPU one that is the plain PyTorch version. No other device has one, and
nothing catches a build or launch failure. Eagerly, the wrappers in
resunit.py, vq.py and lstm.py run the plain version of a CPU tensor
themselves, without the op's dispatch; a program exported on the CPU holds
the ops.

The float32 entry, the bf16 entry, its float32-in/out forms and the VQ
search carry gradients (`register_autograd`): a residual unit's is the
plain composition's under its form's policy (`resunit.ROUTE_POLICY`),
recomputed from the saved inputs (the JAX package's `_bwd`, whose VJP goes
through `_reference`); for the bf16 forms those inputs are the pack, whose
making is differentiable (`resunit.pack_bf16`), so the gradients reach the
float32 weights through the bf16 rounding, and the snake reciprocals get
none (the plain composition takes them from the alphas). The search passes
none to the latents and scatter-adds the rows' cotangent into the codebook
rows it selected (`index_add`, the counterpart of `segment_sum`). The halo
entry, the int8 unit and the LSTM recurrence are forward only.

The bf16 entries and the int8 unit take the packed weights as tensors;
their CUDA implementations encode the TMA tensor maps themselves
(`resunit.tma_maps`, kept per packed weights' address), so a pack made by
graph ops in an exported program serves the kernel as one kept by
`models.dac.ResidualUnit` does.

Import this module (the `ops.kernels` package does) before loading an
exported program that holds these ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.kernels import lstm, resunit, vq


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


def _recompute_grads(ctx, g, plain, n_static: int):
    """The gradients of `plain(*saved tensors)` (the op's plain version)
    for the tensor inputs that want one, and None for the `n_static`
    non-tensor arguments after them."""
    saved = ctx.saved_tensors  # once: a checkpoint's saved tensors unpack only once
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
    return (*(next(grads) if n else None for n in needs), *(None,) * n_static)


def _resunit_f32_backward(ctx, g):
    return _recompute_grads(ctx, g, lambda *t: resunit.residual_unit_reference(
        *t, ctx.dilation, ctx.causal), 2)


resunit_f32.register_autograd(_resunit_f32_backward, setup_context=_resunit_f32_setup)


# ------------------------------------------------------------ bf16 entry
@torch.library.custom_op("facodec::resunit_bf16", mutates_args=(), device_types="cpu")
def resunit_bf16(x: Tensor, w7: Tensor, w1: Tensor, b7: Tensor, b1: Tensor, alpha1: Tensor,
                 recip1: Tensor, alpha2: Tensor, recip2: Tensor, dilation: int,
                 causal: bool) -> Tensor:
    pack = resunit.Bf16Pack(w7, w1, b7, b1, alpha1, recip1, alpha2, recip2)
    return resunit.packed_reference(x, pack, dilation, causal, "bf16").contiguous()


@resunit_bf16.register_kernel("cuda")
def _resunit_bf16_cuda(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2, dilation, causal):
    pl, ext = resunit.reflect_extent(x.shape[1], dilation, causal)
    pack = resunit.Bf16Pack(w7, w1, b7, b1, alpha1, recip1, alpha2, recip2)
    return resunit.launch_bf16(resunit.aligned16(x.contiguous()), pack, dilation, pl, ext)


@resunit_bf16.register_fake
def _resunit_bf16_fake(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2, dilation, causal):
    return _new_like(x)


def _packed_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:9])
    ctx.static = inputs[9:]


def _resunit_bf16_backward(ctx, g):
    dilation, causal = ctx.static
    return _recompute_grads(ctx, g, lambda x, *pack: resunit.packed_reference(
        x, resunit.Bf16Pack(*pack), dilation, causal, "bf16"), 2)


resunit_bf16.register_autograd(_resunit_bf16_backward, setup_context=_packed_setup)


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


# ---------------------------------------------------- float32-in/out forms
@torch.library.custom_op("facodec::resunit_bf16_f32io", mutates_args=(), device_types="cpu")
def resunit_bf16_f32io(x: Tensor, w7: Tensor, w1: Tensor, b7: Tensor, b1: Tensor,
                       alpha1: Tensor, recip1: Tensor, alpha2: Tensor, recip2: Tensor,
                       dilation: int, causal: bool, act: bool) -> Tensor:
    pack = resunit.Bf16Pack(w7, w1, b7, b1, alpha1, recip1, alpha2, recip2)
    return resunit.packed_reference(x, pack, dilation, causal,
                                    "f32io_act" if act else "f32io").contiguous()


@resunit_bf16_f32io.register_kernel("cuda")
def _resunit_bf16_f32io_cuda(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2, dilation,
                             causal, act):
    pl, ext = resunit.reflect_extent(x.shape[1], dilation, causal)
    pack = resunit.Bf16Pack(w7, w1, b7, b1, alpha1, recip1, alpha2, recip2)
    return resunit.launch_f32io(resunit.aligned16(x.contiguous()), pack, dilation, pl, ext, act)


@resunit_bf16_f32io.register_fake
def _resunit_bf16_f32io_fake(x, w7, w1, b7, b1, alpha1, recip1, alpha2, recip2, dilation,
                             causal, act):
    return _new_like(x)


def _resunit_bf16_f32io_backward(ctx, g):
    dilation, causal, act = ctx.static
    return _recompute_grads(ctx, g, lambda x, *pack: resunit.packed_reference(
        x, resunit.Bf16Pack(*pack), dilation, causal, "f32io_act" if act else "f32io"), 3)


resunit_bf16_f32io.register_autograd(_resunit_bf16_f32io_backward, setup_context=_packed_setup)


# ------------------------------------------------------------ int8 unit
@torch.library.custom_op("facodec::resunit_int8_amax", mutates_args=(), device_types="cpu")
def resunit_int8_amax(x: Tensor, alpha1: Tensor, recip1: Tensor) -> Tensor:
    return resunit.int8_row_amax_reference(x, alpha1).contiguous()


@resunit_int8_amax.register_kernel("cuda")
def _resunit_int8_amax_cuda(x, alpha1, recip1):
    return resunit.launch_int8_amax(x, alpha1, recip1)


@resunit_int8_amax.register_fake
def _resunit_int8_amax_fake(x, alpha1, recip1):
    return x.new_empty(x.shape[0])


@torch.library.custom_op("facodec::resunit_int8", mutates_args=(), device_types="cpu")
def resunit_int8(x: Tensor, amax: Tensor, q7: Tensor, sw: Tensor, w1: Tensor, b7: Tensor,
                 b1: Tensor, alpha1: Tensor, recip1: Tensor, alpha2: Tensor, recip2: Tensor,
                 dilation: int, causal: bool) -> Tensor:
    pack = resunit.Int8Pack(q7, sw, w1, b7, b1, alpha1, recip1, alpha2, recip2)
    return resunit.int8_unit_parts(x, amax, pack, dilation, causal)["out"].contiguous()


@resunit_int8.register_kernel("cuda")
def _resunit_int8_cuda(x, amax, q7, sw, w1, b7, b1, alpha1, recip1, alpha2, recip2, dilation,
                       causal):
    pl, ext = resunit.reflect_extent(x.shape[1], dilation, causal)
    pack = resunit.Int8Pack(q7, sw, w1, b7, b1, alpha1, recip1, alpha2, recip2)
    return resunit.launch_int8(x, amax, pack, dilation, pl, ext)


@resunit_int8.register_fake
def _resunit_int8_fake(x, amax, q7, sw, w1, b7, b1, alpha1, recip1, alpha2, recip2, dilation,
                       causal):
    return _new_like(x)


# ------------------------------------------------------ W8A8 LSTM layer
@torch.library.custom_op("facodec::lstm_int8", mutates_args=(), device_types="cpu")
def lstm_int8(x_proj: Tensor, w_q: Tensor, w_scale: Tensor, h0: Tensor,
              c0: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return tuple(t.contiguous() for t in lstm.lstm_int8_reference(x_proj, w_q, w_scale, h0, c0))


@lstm_int8.register_kernel("cuda")
def _lstm_int8_cuda(x_proj, w_q, w_scale, h0, c0):
    return lstm.launch(x_proj, w_q, w_scale, h0, c0)


@lstm_int8.register_fake
def _lstm_int8_fake(x_proj, w_q, w_scale, h0, c0):
    B, T, G = x_proj.shape
    return x_proj.new_empty(B, T, G // 4), _new_like(h0), _new_like(c0)
