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

A bf16 x (the decoder under the `bfloat16_act` policy) goes to the bf16
entry, csrc/resunit_bf16.cu (wgmma, weights by TMA), with its own launch
count (`fused_residual_unit.bf16_launches`; `launches` counts the float32
entry): bf16 operands, float32 sums, rounded where the JAX package's
default path rounds. Its plain version is `residual_unit_reference` under
that policy; the weights, biases and alphas stay float32 parameters, and
the policy rounds them. The kernel takes them packed (`pack_bf16`: w7 as
the (out, 7C) K-major bf16 matrix, w1, the bf16 biases, the snake
reciprocals and the TMA tensor maps of both weights). `fused_residual_unit`
packs on every call; `fused_residual_unit_packed` (card only) takes a pack
that the caller keeps (`models.dac.ResidualUnit` keeps one per weight
version). The bf16 entry and the halo entry below are forward only (the
hybrid decode and streams serve): asked for a gradient, they raise.

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
from typing import NamedTuple, Optional, Tuple

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
    """(one-shot entry, halo entry, scratch size) from csrc/resunit.cu, typed
    once per process."""
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


@functools.lru_cache(maxsize=None)
def _bf16_entry_points():
    """(bf16 entry, tensor-map builder, map bytes, plan, scratch size) from
    csrc/resunit_bf16.cu, typed once per process."""
    lib = build.library("resunit_bf16")
    fn = lib.facodec_resunit_bf16
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    maps = lib.facodec_resunit_bf16_maps
    maps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    maps.restype = ctypes.c_int
    lib.facodec_resunit_bf16_maps_bytes.restype = ctypes.c_int
    plan = lib.facodec_resunit_bf16_plan
    plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    size = lib.facodec_resunit_bf16_scratch_bytes
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    return fn, maps, lib.facodec_resunit_bf16_maps_bytes(), plan, size


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


def _check_x(who: str, x, dilation: int, x_dtypes) -> None:
    if x.ndim != 3:
        raise ValueError(f"{who}: x must be (B, T, C), got {tuple(x.shape)}")
    _check(who, "x", x, x.shape, x.device, x_dtypes)
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: x must be contiguous")
    if x.shape[-1] % 32:
        raise ValueError(f"{who}: the kernel takes C % 32 == 0, got C={x.shape[-1]}")
    if dilation < 1:
        raise ValueError(f"{who}: dilation must be >= 1, got {dilation}")


def _check_unit(who: str, x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                x_dtypes=(torch.float32,)) -> None:
    _check_x(who, x, dilation, x_dtypes)
    C = x.shape[-1]
    for name, t, shape in (("w7", w7, (C, C, 7)), ("b7", b7, (C,)),
                           ("w1", w1, (C, C, 1)), ("b1", b1, (C,)),
                           ("alpha1", alpha1, (1, C, 1)), ("alpha2", alpha2, (1, C, 1))):
        _check(who, name, t, shape, x.device)


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
    x float32 (with gradients), or bf16 for the bf16 entry (forward only,
    the weights packed for this call)."""
    _check_unit("fused_residual_unit", x, w7, b7, w1, b1, alpha1, alpha2, dilation,
                (torch.float32, torch.bfloat16))
    if x.device.type == "cpu":
        return residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
    if x.dtype == torch.bfloat16:
        _wants_grad("fused_residual_unit (bf16 entry)", x, w7, b7, w1, b1, alpha1, alpha2)
        pl, ext = _reflect_extent(x.shape[1], dilation, causal)
        return launch_bf16(_aligned16(x), pack_bf16(w7, b7, w1, b1, alpha1, alpha2), dilation,
                           pl, ext)
    return _ResidualUnitFn.apply(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)


class Bf16Pack(NamedTuple):
    """The bf16 entry's operands, packed once per weight version: w7 (C, 7C)
    bf16 with K index tap * C + in, w1 (C, C), b7 and b1 (C) bf16 (as the
    policy rounds them), the alphas and their snake reciprocals
    1 / (alpha + 1e-9) (C) float32, and the TMA tensor maps of w7 and w1
    (card only: they hold the two weights' device addresses)."""
    w7: torch.Tensor
    w1: torch.Tensor
    b7: torch.Tensor
    b1: torch.Tensor
    alpha1: torch.Tensor
    recip1: torch.Tensor
    alpha2: torch.Tensor
    recip2: torch.Tensor
    maps: Optional[ctypes.Array]


def pack_bf16(w7, b7, w1, b1, alpha1, alpha2) -> Bf16Pack:
    """The bf16 entry's operands from the effective (weight-normed) float32
    weights in torch's layout; with the TMA maps where they lie on the card."""
    C = w7.shape[0]
    bf16 = torch.bfloat16
    with torch.no_grad():
        w7p = w7.to(bf16).permute(0, 2, 1).reshape(C, 7 * C).contiguous()
        w1p = w1[:, :, 0].to(bf16).contiguous()
        a1, a2 = (a.reshape(C).clone() for a in (alpha1, alpha2))
        recip1, recip2 = (1.0 / (a + 1e-9) for a in (a1, a2))
        maps = None
        if w7.device.type == "cuda":
            _, encode, nbytes, _, _ = _bf16_entry_points()
            maps = ctypes.create_string_buffer(nbytes)
            with torch.cuda.device(w7.device):
                err = encode(w7p.data_ptr(), w1p.data_ptr(), C, maps)
            if err != 0:
                raise RuntimeError(f"pack_bf16: TMA tensor maps failed for C={C}, cudaError {err}")
        return Bf16Pack(w7p, w1p, b7.to(bf16).contiguous(), b1.to(bf16).contiguous(), a1, recip1,
                        a2, recip2, maps)


def _check_pack(who: str, pack: Bf16Pack, C: int, device) -> None:
    for name, shape, dtype in (("w7", (C, 7 * C), torch.bfloat16), ("w1", (C, C), torch.bfloat16),
                               ("b7", (C,), torch.bfloat16), ("b1", (C,), torch.bfloat16),
                               ("alpha1", (C,), torch.float32), ("recip1", (C,), torch.float32),
                               ("alpha2", (C,), torch.float32), ("recip2", (C,), torch.float32)):
        t = getattr(pack, name)
        _check(who, f"pack.{name}", t, shape, device, (dtype,))
        if not t.is_contiguous():
            raise ValueError(f"{who}: pack.{name} must be contiguous")
    if device.type == "cuda" and pack.maps is None:
        raise ValueError(f"{who}: the pack has no TMA tensor maps (packed off the card)")


def fused_residual_unit_packed(x, pack: Bf16Pack, dilation: int, causal: bool) -> torch.Tensor:
    """The bf16 entry with operands packed by `pack_bf16`, forward only: x
    (B, T, C) bf16 on the card (on the CPU, `fused_residual_unit` runs the
    plain version)."""
    who = "fused_residual_unit_packed"
    _check_x(who, x, dilation, (torch.bfloat16,))
    _check_pack(who, pack, x.shape[-1], x.device)
    if x.device.type != "cuda":
        raise ValueError(f"{who}: the packed entry runs on the card only, x is on {x.device}")
    _wants_grad(who, x)
    pl, ext = _reflect_extent(x.shape[1], dilation, causal)
    return launch_bf16(_aligned16(x), pack, dilation, pl, ext)


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
fused_residual_unit.bf16_launches = 0


def launch_bf16(x, pack: Bf16Pack, dilation: int, pad_left: int, ext: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the bf16 kernel on checked operands (x contiguous and
    16-byte aligned, a pack made on x's card), into `out` or a new tensor;
    the pads as `_reflect_extent` gives them."""
    B, T, C = x.shape
    out = torch.empty_like(x) if out is None else out
    fn, size = (_bf16_entry_points()[i] for i in (0, 4))
    with torch.cuda.device(x.device):
        # the s2 tile of each CTA, for units too wide to keep it in shared memory
        nbytes = size(B, T, C, dilation)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes > 0 else None
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), ctypes.addressof(pack.maps),
                 *(t.data_ptr() for t in (pack.b7, pack.b1, pack.alpha1, pack.recip1,
                                          pack.alpha2, pack.recip2, out)),
                 None if scratch is None else scratch.data_ptr(), B, T, C, dilation, pad_left,
                 ext, stream)
    if err != 0:
        why = " (shapes the kernel refuses: C, B, T, d and the pads)" if err == 1 else ""
        raise RuntimeError(f"fused_residual_unit: bf16 kernel launch failed, cudaError {err}{why}")
    fused_residual_unit.bf16_launches += 1
    return out


def bf16_plan(B: int, T: int, C: int, dilation: int) -> dict:
    """The bf16 kernel's tiling for a call (card only): N tile width, rows
    per tile, N tiles, K elements of a weight slice (and channels of an s1
    group), ring stages, whether the weights stay resident, whether s2 goes
    to the device scratch (units too wide for shared memory), dynamic
    shared memory in bytes, grid, row tiles."""
    plan = _bf16_entry_points()[3]
    out = (ctypes.c_int * 10)()
    if plan(B, T, C, dilation, out) != 0:
        raise ValueError(f"bf16_plan: the kernel refuses B={B} T={T} C={C} d={dilation}")
    keys = ("bn", "bm", "n_tiles", "kc", "stages", "resident", "spill", "smem", "grid", "tiles")
    return dict(zip(keys, out))


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
