"""Fused DAC residual unit: CUDA kernel wrappers and their plain PyTorch versions.

Port of facodec_tpu/ops/pallas/resunit.py. Computes

    out = x + conv1x1(snake2(conv7_dilated(snake1(pad(x))))),

x NTC (B, T, C) float32, with the effective (weight-normed) torch-layout
weights w7 (C, C, 7) and w1 (C, C, 1) and alphas of shape (1, C, 1). The pad
is SConv1d's: reflect, (6d, 0) when causal, split otherwise.

The wrappers check their operands and call the custom ops of ops.py
(`facodec::resunit_f32`, `facodec::resunit_bf16`,
`facodec::resunit_halo_f32`): on a CUDA tensor the op launches
csrc/resunit.cu (3xTF32 tensor cores, with a scratch buffer for the
block-local snake1 and y2 rows) or raises. On a CPU tensor the wrapper runs
`residual_unit_reference` itself, and goes through the op (whose CPU
implementation is that same function) only while a program is being
exported, where the op is one graph node: eagerly, the op's dispatch would
add about 0.2 ms to every small call. The float32 entry carries gradients (the op's
`register_autograd`): the JAX package's `_bwd`, the gradient of the plain
composition recomputed from the saved inputs, for x, w7, b7, w1, b1 and
both alphas (the weights are the effective weight-norm weights, so the
gradient flows on through the weight norm in autograd).

A bf16 x (the decoder under the `bfloat16_act` policy) goes on the card to
the bf16 entry, csrc/resunit_bf16.cu (wgmma, weights by TMA), with its own
launch count (`fused_residual_unit.bf16_launches`; `launches` counts the
float32 entry): bf16 operands, float32 sums, rounded where the JAX
package's default path rounds. Its plain version is
`residual_unit_reference` under that policy; the weights, biases and alphas
stay float32 parameters, and the policy rounds them. The kernel takes them
packed (`pack_bf16`: w7 as the (out, 7C) K-major bf16 matrix, w1, the bf16
biases and the snake reciprocals); the TMA tensor maps of both weights are
encoded at launch (`tma_maps`, kept per weight address).
`fused_residual_unit` packs on every call; `fused_residual_unit_packed`
takes a pack that the caller keeps (`models.dac.ResidualUnit` keeps one per
weight version) or, in a program being exported, makes with graph ops. The
bf16 entry and the halo entry below are forward only (the hybrid decode and
streams serve): asked for a gradient on the card, they raise.

Under the other precision policies the unit runs in the kernel form that
`unit_route` picks from the policy, x's dtype and the unit's width, each
forward only, on operands packed once per weight version (`make_pack`,
kept by `models.dac.ResidualUnit`), each with its launch count:
  - the float32-in/out forms of the bf16 kernel (csrc/resunit_bf16.cu,
    `facodec::resunit_bf16_f32io`, `pack_bf16` with float32 biases):
    `bfloat16` (`f32io_launches`: the conv outputs rounded to bf16 and
    widened, float32 biases) and, with `act`, the bf16 entry's rounding on
    a float32 x and out (`f32io_act_launches`: `int8`'s units whose conv7
    does not quantize); plain version `f32io_reference`;
  - the int8 unit (csrc/resunit_int8.cu, `pack_int8`): the W8A8 conv7 of
    `int8`'s units with `is_int8(7 C)`, two launches, the row maxima of
    |snake1(x)| (`facodec::resunit_int8_amax`, `int8_amax_launches`) and
    the unit (`facodec::resunit_int8`, `int8_launches`: int8 and bf16
    wgmma, the weights by TMA, their maps encoded at launch as the bf16
    kernel's); plain version `int8_unit_parts` (bit-equal in its int8
    operands and conv7 output).
On the CPU `fused_residual_unit` runs the plain composition under the
current policy, which every form's plain version equals on its route.

`fused_residual_unit_stream` runs one chunk of a causal stream through the
kernel's halo entry (plain version `residual_unit_stream_reference`): the
left pad is the carried halo, the last 6d rows of the previous chunk's
padded snake1 input, (B, 6d, C), which is the JAX package's stream state of
the unit's conv7; on a stream's first chunk (halo None) it is the causal
reflect. It returns the output and the new halo.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from facodec_tpu_torch.nn.activations import snake
from facodec_tpu_torch.nn.conv import conv1d_ntc, int8_conv1d
from facodec_tpu_torch.ops.kernels import build
from facodec_tpu_torch.ops.padding import pad1d
from facodec_tpu_torch.ops.precision import (INT8_SCALE, compute_dtype, get_policy, is_int8,
                                             policy, quantize_dynamic)


def _pads(dilation: int, causal: bool) -> Tuple[int, int]:
    halo = 6 * dilation
    return (halo, 0) if causal else (halo - halo // 2, halo // 2)


def residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                            causal: bool, policy_name: Optional[str] = None) -> torch.Tensor:
    """The plain composition (the JAX package's `_reference`) under
    `policy_name`, or else the current policy; a bf16 x where that policy
    keeps float32 outputs runs under `bfloat16_act`, whose convs round as
    the kernel's bf16 entry does."""
    C = x.shape[-1]
    if policy_name is None and x.dtype == torch.bfloat16 and compute_dtype() == torch.float32:
        policy_name = "bfloat16_act"
    with policy(policy_name):
        y = snake(x, alpha1.reshape(1, 1, C))
        y = pad1d(y, _pads(dilation, causal))
        y = conv1d_ntc(y, w7, b7, dilation=dilation)
        y = snake(y, alpha2.reshape(1, 1, C))
        return x + conv1d_ntc(y, w1, b1)


# the policy each kernel form's plain version runs under (unit_route)
ROUTE_POLICY = {"f32": "float32", "bf16": "bfloat16_act", "f32io": "bfloat16",
                "f32io_act": "bfloat16_act"}


def unit_route(dtype: torch.dtype, C: int) -> str:
    """Which kernel form runs a unit of width C on an input of `dtype` on the
    card under the current policy, following the JAX package's dtypes:
    "f32" (the float32 entry: float32 and the entry-point policies' float32
    reading), "bf16" (bf16 in and out: `bfloat16_act`, and `int8`'s units
    that do not quantize, on a bf16 x), "f32io" (float32 in and out with
    `bfloat16`'s rounding), "f32io_act" (float32 in and out with the bf16
    entry's rounding: `int8`'s units that do not quantize, on a float32 x)
    or "int8" (a conv7 that quantizes: `is_int8(7 C)`, float32 x). Raises
    where no kernel computes what the policy asks: a bf16 x under
    `bfloat16`, or under `int8` into a quantizing conv7, and a unit whose
    1x1 quantizes too (INT8_MIN_FANIN <= C)."""
    pol, bf16 = get_policy(), dtype == torch.bfloat16
    if pol == "int8":
        if is_int8(C):
            raise ValueError(f"no residual-unit kernel quantizes the 1x1 conv (C={C} >= "
                             f"INT8_MIN_FANIN); it runs only on the CPU")
        if is_int8(7 * C):
            if bf16:
                raise TypeError("the int8 residual unit takes a float32 x, got bfloat16")
            return "int8"
        return "bf16" if bf16 else "f32io_act"
    if pol == "bfloat16":
        if bf16:
            raise TypeError("under the bfloat16 policy a residual unit takes a float32 x")
        return "f32io"
    if pol == "bfloat16_act":
        return "bf16" if bf16 else "f32io_act"
    return "bf16" if bf16 else "f32"


def bf16_error_scale(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                     causal: bool, route: str = "bf16") -> torch.Tensor:
    """Per element of a bf16-operand unit's output (kernel form `route`),
    the magnitude whose bf16 ulp measures a difference between two
    evaluations of the unit: the largest term of its last sums, max(|x|,
    |out|, |b1|, |W1| . |s2|), s2 the 1x1's bf16 operand. Two summation
    orders can round a sum one ulp apart; such a step in s2 moves W1 . s2 by
    up to |W1| . ulp(s2), and reaches the output unchanged where the 1x1's
    products or x + y cancel. |W1| . |s2| bounds the 1x1's terms as a
    rounding-error analysis of a sum does."""
    C = x.shape[-1]
    if route == "int8":
        parts = int8_unit_parts(x, int8_row_amax_reference(x, alpha1),
                                pack_int8(w7, b7, w1, b1, alpha1, alpha2), dilation, causal)
        s2, out = parts["s2"], parts["out"]
    else:
        with policy(ROUTE_POLICY[route]):
            y = snake(x, alpha1.reshape(1, 1, C))
            y = conv1d_ntc(pad1d(y, _pads(dilation, causal)), w7, b7, dilation=dilation)
            s2 = snake(y, alpha2.reshape(1, 1, C))
        out = residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal,
                                      ROUTE_POLICY[route])
    terms = conv1d_ntc(s2.to(torch.bfloat16).float().abs(),
                       w1.to(torch.bfloat16).float().abs(), None, exact=True)
    parts = (x.float().abs(), out.float().abs(), terms, b1.float().abs().expand_as(terms))
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
    """(bf16 entry, tensor-map builder, map bytes, plan, scratch size,
    float32-in/out entry) from csrc/resunit_bf16.cu, typed once per
    process."""
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
    f32io = lib.facodec_resunit_bf16_f32io
    f32io.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    f32io.restype = ctypes.c_int
    return fn, maps, lib.facodec_resunit_bf16_maps_bytes(), plan, size, f32io


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


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its address is not 16-byte aligned (the
    kernels' vector loads and TMA need it); called where tensors are real."""
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
    x, w7, w1 = (aligned16(t.contiguous()) for t in (x, w7, w1))
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
    """out = x + conv1x1(snake(conv7(snake(x)))) under the current policy:
    on the card in the kernel form `unit_route` picks, its operands packed
    for this call (the float32 entry with gradients, the others forward
    only); on the CPU the plain version under the policy, with gradients."""
    _check_unit("fused_residual_unit", x, w7, b7, w1, b1, alpha1, alpha2, dilation,
                (torch.float32, torch.bfloat16))
    if x.device.type == "cpu" and not torch.compiler.is_exporting():
        return residual_unit_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
    route = unit_route(x.dtype, x.shape[-1])
    if route == "f32":
        return torch.ops.facodec.resunit_f32(x, w7, b7, w1, b1, alpha1, alpha2, dilation, causal)
    _wants_grad(f"fused_residual_unit ({route} entry)", x, w7, b7, w1, b1, alpha1, alpha2)
    return run_packed(route, x, make_pack(route, w7, b7, w1, b1, alpha1, alpha2), dilation,
                      causal)


def make_pack(route: str, w7, b7, w1, b1, alpha1, alpha2):
    """The packed operands of kernel form `route` (not "f32") from the
    effective float32 weights."""
    if route == "int8":
        return pack_int8(w7, b7, w1, b1, alpha1, alpha2)
    bias = torch.bfloat16 if route == "bf16" else torch.float32
    return pack_bf16(w7, b7, w1, b1, alpha1, alpha2, bias)


def run_packed(route: str, x, pack, dilation: int, causal: bool) -> torch.Tensor:
    """Kernel form `route` (not "f32") on a pack that `make_pack` made."""
    if route == "bf16":
        return fused_residual_unit_packed(x, pack, dilation, causal)
    if route == "int8":
        return fused_residual_unit_int8_packed(x, pack, dilation, causal)
    return fused_residual_unit_f32io_packed(x, pack, dilation, causal, act=route == "f32io_act")


class Bf16Pack(NamedTuple):
    """The bf16 kernel's operands, packed once per weight version: w7 (C, 7C)
    bf16 with K index tap * C + in, w1 (C, C), b7 and b1 (C) (bf16 as the
    policy rounds them for the bf16 entry; float32 for the float32-in/out
    forms, which round them where their policy does), the alphas and their
    snake reciprocals 1 / (alpha + 1e-9) (C) float32; in the order
    `facodec::resunit_bf16` and `facodec::resunit_bf16_f32io` take them."""
    w7: torch.Tensor
    w1: torch.Tensor
    b7: torch.Tensor
    b1: torch.Tensor
    alpha1: torch.Tensor
    recip1: torch.Tensor
    alpha2: torch.Tensor
    recip2: torch.Tensor


def pack_bf16(w7, b7, w1, b1, alpha1, alpha2, bias_dtype=torch.bfloat16) -> Bf16Pack:
    """The bf16 kernel's operands from the effective (weight-normed) float32
    weights in torch's layout, with biases of `bias_dtype`."""
    C = w7.shape[0]
    bf16 = torch.bfloat16
    with torch.no_grad():
        w7p = w7.to(bf16).permute(0, 2, 1).reshape(C, 7 * C).contiguous()
        w1p = w1[:, :, 0].to(bf16).contiguous()
        a1, a2 = (a.reshape(C).clone() for a in (alpha1, alpha2))
        recip1, recip2 = (1.0 / (a + 1e-9) for a in (a1, a2))
        return Bf16Pack(w7p, w1p, b7.to(bias_dtype).contiguous(), b1.to(bias_dtype).contiguous(),
                        a1, recip1, a2, recip2)


_MAPS: "collections.OrderedDict[tuple, ctypes.Array]" = collections.OrderedDict()
_MAPS_KEPT = 256  # packs whose maps stay encoded: far more than a model's kernel units
_MAPS_LOCK = threading.Lock()


def tma_maps(w7: torch.Tensor, w1: torch.Tensor, kind: str = "bf16") -> ctypes.Array:
    """The TMA tensor maps of a pack's conv7 and 1x1 weights on the card
    (host memory, copied into the kernel's parameters at each launch), for
    the bf16 kernel (`kind` "bf16": w7 and w1 bf16) or the int8 unit
    ("int8": q7 int8 and w1). A map holds the weight's address and shape
    and no values, so it is kept per (kind, device, addresses, C): a repack
    in place or a new pack at the same address reuses it, and an exported
    program's per-call pack, which the caching allocator gives the same
    addresses, encodes once."""
    C = w7.shape[0]
    key = (kind, w7.device.index, w7.data_ptr(), w1.data_ptr(), C)
    with _MAPS_LOCK:  # replicas launch from several threads (api.FACodec.shard_inference)
        maps = _MAPS.get(key)
        if maps is None:
            entries = _bf16_entry_points() if kind == "bf16" else _int8_entry_points()
            encode, nbytes = entries[1], entries[2]
            maps = ctypes.create_string_buffer(nbytes)
            with torch.cuda.device(w7.device):
                err = encode(w7.data_ptr(), w1.data_ptr(), C, maps)
            if err != 0:
                raise RuntimeError(f"tma_maps: TMA tensor maps failed for C={C}, cudaError {err}")
            _MAPS[key] = maps
            if len(_MAPS) > _MAPS_KEPT:
                _MAPS.popitem(last=False)
        else:
            _MAPS.move_to_end(key)
        return maps


def _check_pack(who: str, pack, C: int, device, bias=torch.bfloat16) -> None:
    w7 = ("q7", (C, 7 * C), torch.int8) if isinstance(pack, Int8Pack) else \
        ("w7", (C, 7 * C), torch.bfloat16)
    b7 = torch.float32 if isinstance(pack, Int8Pack) else bias
    for name, shape, dtype in (w7, ("w1", (C, C), torch.bfloat16),
                               ("b7", (C,), b7), ("b1", (C,), bias),
                               ("alpha1", (C,), torch.float32), ("recip1", (C,), torch.float32),
                               ("alpha2", (C,), torch.float32), ("recip2", (C,), torch.float32)):
        t = getattr(pack, name)
        _check(who, f"pack.{name}", t, shape, device, (dtype,))
        if not t.is_contiguous():
            raise ValueError(f"{who}: pack.{name} must be contiguous")


def fused_residual_unit_packed(x, pack: Bf16Pack, dilation: int, causal: bool) -> torch.Tensor:
    """The bf16 entry with operands packed by `pack_bf16`, forward only: x
    (B, T, C) bf16 on the card, or any device's in a program being exported
    (eagerly on the CPU, `fused_residual_unit` runs the plain version)."""
    who = "fused_residual_unit_packed"
    _check_x(who, x, dilation, (torch.bfloat16,))
    _check_pack(who, pack, x.shape[-1], x.device)
    if x.device.type != "cuda" and not torch.compiler.is_exporting():
        raise ValueError(f"{who}: the packed entry runs on the card only, x is on {x.device}")
    _wants_grad(who, x)
    return torch.ops.facodec.resunit_bf16(x, *pack, dilation, causal)


def reflect_extent(T: int, dilation: int, causal: bool) -> Tuple[int, int]:
    """(left pad, rows the kernel reflects over): the kernel reflects x's
    rows itself, as `pad1d` pads, and a short input is zero-extended to one
    row more than the longer pad first."""
    pl, pr = _pads(dilation, causal)
    return pl, (T if T > max(pl, pr) else max(pl, pr) + 1)


def launch_f32(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int, causal: bool) -> torch.Tensor:
    """One launch of the float32 one-shot entry on CUDA tensors (the CUDA
    implementation of `facodec::resunit_f32`)."""
    B, T, C = x.shape
    pl, ext = reflect_extent(T, dilation, causal)
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
    build.count_launch(fused_residual_unit)
    return out


fused_residual_unit.launches = 0  # the float32 entry
fused_residual_unit.bf16_launches = 0
fused_residual_unit.f32io_launches = 0  # float32 in and out, bfloat16's rounding
fused_residual_unit.f32io_act_launches = 0  # float32 in and out, the bf16 entry's rounding
fused_residual_unit.int8_amax_launches = 0  # the int8 unit's row maxima
fused_residual_unit.int8_launches = 0  # the int8 unit


def launch_bf16(x, pack: Bf16Pack, dilation: int, pad_left: int, ext: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the bf16 kernel on checked operands (x contiguous and
    16-byte aligned, a pack on x's card), into `out` or a new tensor; the
    pads as `reflect_extent` gives them (the CUDA implementation of
    `facodec::resunit_bf16`)."""
    B, T, C = x.shape
    w7, w1 = (aligned16(t.contiguous()) for t in (pack.w7, pack.w1))
    rest = [t.contiguous() for t in pack[2:]]
    out = torch.empty_like(x) if out is None else out
    fn, size = (_bf16_entry_points()[i] for i in (0, 4))
    maps = tma_maps(w7, w1)
    with torch.cuda.device(x.device):
        # the s2 tile of each CTA, for units too wide to keep it in shared memory
        nbytes = size(B, T, C, dilation)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes > 0 else None
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), ctypes.addressof(maps), *(t.data_ptr() for t in (*rest, out)),
                 None if scratch is None else scratch.data_ptr(), B, T, C, dilation, pad_left,
                 ext, stream)
    if err != 0:
        why = " (shapes the kernel refuses: C, B, T, d and the pads)" if err == 1 else ""
        raise RuntimeError(f"fused_residual_unit: bf16 kernel launch failed, cudaError {err}{why}")
    build.count_launch(fused_residual_unit, "bf16_launches")
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
        if x.device.type == "cuda" and not halo.is_contiguous():
            raise ValueError(f"{who}: halo must be contiguous")
    if x.device.type == "cpu" and not torch.compiler.is_exporting():
        return residual_unit_stream_reference(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation)
    return torch.ops.facodec.resunit_halo_f32(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation)


def launch_halo(x, halo, w7, b7, w1, b1, alpha1, alpha2, dilation: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the halo entry on CUDA tensors (the CUDA implementation
    of `facodec::resunit_halo_f32`)."""
    B, T, C = x.shape
    ops = _kernel_operands(x, w7, b7, w1, b1, alpha1, alpha2)
    halo = None if halo is None else aligned16(halo.contiguous())
    out = torch.empty_like(ops[0])
    new_halo = torch.empty(B, 6 * dilation, C, dtype=torch.float32, device=x.device)
    _, fn, size = _entry_points()
    with torch.cuda.device(x.device):
        scratch = torch.empty(size(B, T, C, dilation), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ops[0].data_ptr(), None if halo is None else halo.data_ptr(),
                 *(t.data_ptr() for t in ops[1:]), out.data_ptr(), new_halo.data_ptr(),
                 scratch.data_ptr(), B, T, C, dilation, stream)
    if err != 0:
        raise RuntimeError(f"fused_residual_unit_stream: kernel launch failed, cudaError {err}")
    build.count_launch(fused_residual_unit_stream)
    return out, new_halo


fused_residual_unit_stream.launches = 0


# ------------------------------------------- float32-in/out forms (bf16 kernel)
def fused_residual_unit_f32io_packed(x, pack: Bf16Pack, dilation: int, causal: bool,
                                     act: bool) -> torch.Tensor:
    """The bf16 kernel's float32-in/out forms on a pack with float32 biases
    (`pack_bf16(..., torch.float32)`), forward only: with `act` the bf16
    entry's rounding (`bfloat16_act`; the `int8` policy's units that do not
    quantize, given a float32 x), else the `bfloat16` policy's, whose convs
    round their products to bf16 and add the float32 biases in float32. x
    (B, T, C) float32 on the card, or any device's in a program being
    exported."""
    who = "fused_residual_unit_f32io_packed"
    _check_x(who, x, dilation, (torch.float32,))
    _check_pack(who, pack, x.shape[-1], x.device, bias=torch.float32)
    if x.device.type != "cuda" and not torch.compiler.is_exporting():
        raise ValueError(f"{who}: the packed entry runs on the card only, x is on {x.device}")
    _wants_grad(who, x)
    return torch.ops.facodec.resunit_bf16_f32io(x, *pack, dilation, causal, act)


def unpack_w7(w7: torch.Tensor) -> torch.Tensor:
    """A pack's (C, 7C) w7 back in torch's (C, C, 7) layout, contiguous as
    the module's own weight is: a CPU conv sums a strided weight in another
    order, and one float32 ulp can round a bf16 output the other way."""
    C = w7.shape[0]
    return w7.reshape(C, 7, C).permute(0, 2, 1).contiguous()


def f32io_reference(x, pack: Bf16Pack, dilation: int, causal: bool, act: bool) -> torch.Tensor:
    """The plain version of the float32-in/out forms on their pack: the
    packed weights are the bf16 roundings the policy makes of the float32
    ones, which it leaves as they are."""
    C = x.shape[-1]
    return residual_unit_reference(
        x, unpack_w7(pack.w7), pack.b7, pack.w1[:, :, None], pack.b1, pack.alpha1.reshape(1, C, 1),
        pack.alpha2.reshape(1, C, 1), dilation, causal, "bfloat16_act" if act else "bfloat16")


def launch_f32io(x, pack: Bf16Pack, dilation: int, pad_left: int, ext: int, act: bool,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of a float32-in/out form of the bf16 kernel on checked
    operands (x float32, contiguous and 16-byte aligned; a pack with float32
    biases on x's card), into `out` or a new tensor (the CUDA implementation
    of `facodec::resunit_bf16_f32io`)."""
    B, T, C = x.shape
    w7, w1 = (aligned16(t.contiguous()) for t in (pack.w7, pack.w1))
    rest = [t.contiguous() for t in pack[2:]]
    out = torch.empty_like(x) if out is None else out
    fn, size = (_bf16_entry_points()[i] for i in (5, 4))
    maps = tma_maps(w7, w1)
    with torch.cuda.device(x.device):
        nbytes = size(B, T, C, dilation)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes > 0 else None
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), ctypes.addressof(maps), *(t.data_ptr() for t in (*rest, out)),
                 None if scratch is None else scratch.data_ptr(), B, T, C, dilation, pad_left,
                 ext, int(act), stream)
    if err != 0:
        why = " (shapes the kernel refuses: C, B, T, d and the pads)" if err == 1 else ""
        raise RuntimeError(f"fused_residual_unit: float32-in/out bf16 kernel launch failed, "
                           f"cudaError {err}{why}")
    build.count_launch(fused_residual_unit, "f32io_act_launches" if act else "f32io_launches")
    return out


# ----------------------------------------------------- the int8 unit (W8A8)
class Int8Pack(NamedTuple):
    """The int8 unit's operands, packed once per weight version: q7 (C, 7C)
    int8, the conv7's weight quantized per output channel over (tap, in),
    K index tap * C + in; sw (C) float32, its scales; w1 (C, C) bf16; b7
    (C) float32; b1 (C) bf16 (as `bfloat16_act` rounds it); the alphas and
    their snake reciprocals (C) float32; in the order `facodec::resunit_int8`
    takes them after x and the row maxima."""
    q7: torch.Tensor
    sw: torch.Tensor
    w1: torch.Tensor
    b7: torch.Tensor
    b1: torch.Tensor
    alpha1: torch.Tensor
    recip1: torch.Tensor
    alpha2: torch.Tensor
    recip2: torch.Tensor


def pack_int8(w7, b7, w1, b1, alpha1, alpha2) -> Int8Pack:
    """The int8 unit's operands from the effective (weight-normed) float32
    weights in torch's layout (`quantize_dynamic` per output channel, as the
    JAX package's W8A8 conv quantizes its weight)."""
    C = w7.shape[0]
    with torch.no_grad():
        q7, sw = quantize_dynamic(w7, (1, 2))
        a1, a2 = (a.reshape(C).float().clone() for a in (alpha1, alpha2))
        recip1, recip2 = (1.0 / (a + 1e-9) for a in (a1, a2))
        return Int8Pack(q7.permute(0, 2, 1).reshape(C, 7 * C).contiguous(),
                        sw.reshape(C).contiguous(), w1[:, :, 0].to(torch.bfloat16).contiguous(),
                        b7.float().contiguous(), b1.to(torch.bfloat16).contiguous(), a1, recip1,
                        a2, recip2)


def int8_row_amax_reference(x, alpha1) -> torch.Tensor:
    """max |snake1(x)| over (T, C) per batch row, (B,) float32: the amax of
    the conv7's per-row activation scale (the reflect pad copies rows, so
    the padded input has the same maximum)."""
    C = x.shape[-1]
    return snake(x, alpha1.reshape(1, 1, C)).abs().amax(dim=(1, 2))


def int8_unit_parts(x, amax, pack: Int8Pack, dilation: int, causal: bool) -> dict:
    """The int8 unit's plain version on its pack, step by step, as the JAX
    package's default path computes a unit under the `int8` policy whose
    conv7 quantizes and whose 1x1 does not:
        s1 = snake1(pad(x))                        float32
        sx = max(amax, 1e-12) * (1/127)            per batch row
        q1 = clip(rint(s1 / sx), -127, 127)        int8
        c7 = float32(q1 (*)_d q7) * (sx * sw) + b7   float32
        s2 = snake2(c7)                            float32 (the 1x1 rounds it)
        y  = bf16(bf16(W1 . bf16(s2)) + bf16(b1))
        out = x + y                                float32
    Returns {"sx" (B, 1, 1), "q1" (B, T + 6d, C), "c7", "s2", "out"}."""
    C = x.shape[-1]
    s1 = pad1d(snake(x, pack.alpha1.reshape(1, 1, C)), _pads(dilation, causal))
    sx = (torch.clamp_min(amax, 1e-12) * INT8_SCALE).reshape(-1, 1, 1)
    q1 = torch.clamp(torch.round(s1 / sx), -127, 127).to(torch.int8)
    acc = int8_conv1d(q1, pack.q7.reshape(C, 7, C).permute(0, 2, 1), 1, dilation, 0, 1)
    c7 = acc.float() * (sx * pack.sw.reshape(1, 1, C)) + pack.b7
    s2 = snake(c7, pack.alpha2.reshape(1, 1, C))
    with policy("bfloat16_act"):
        y = conv1d_ntc(s2, pack.w1[:, :, None], pack.b1)
    return dict(sx=sx, q1=q1, c7=c7, s2=s2, out=x + y)


def residual_unit_int8_reference(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int,
                                 causal: bool) -> torch.Tensor:
    """The int8 unit's plain version from the float32 weights."""
    pack = pack_int8(w7, b7, w1, b1, alpha1, alpha2)
    return int8_unit_parts(x, int8_row_amax_reference(x, alpha1), pack, dilation, causal)["out"]


def fused_residual_unit_int8_packed(x, pack: Int8Pack, dilation: int,
                                    causal: bool) -> torch.Tensor:
    """The int8 unit on a pack (`pack_int8`), forward only: two launches,
    the row maxima of |snake1(x)| (`facodec::resunit_int8_amax`), then the
    unit (`facodec::resunit_int8`). x (B, T, C) float32 on the card, or any
    device's in a program being exported."""
    who = "fused_residual_unit_int8_packed"
    _check_x(who, x, dilation, (torch.float32,))
    _check_pack(who, pack, x.shape[-1], x.device)
    _check(who, "pack.sw", pack.sw, (x.shape[-1],), x.device)
    if x.device.type != "cuda" and not torch.compiler.is_exporting():
        raise ValueError(f"{who}: the packed entry runs on the card only, x is on {x.device}")
    _wants_grad(who, x)
    amax = torch.ops.facodec.resunit_int8_amax(x, pack.alpha1, pack.recip1)
    return torch.ops.facodec.resunit_int8(x, amax, *pack, dilation, causal)


@functools.lru_cache(maxsize=None)
def _int8_entry_points():
    """(row-maxima entry, tensor-map builder, map bytes, unit entry, scratch
    size) from csrc/resunit_int8.cu, typed once per process."""
    lib = build.library("resunit_int8")
    amax = lib.facodec_resunit_int8_amax
    amax.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    amax.restype = ctypes.c_int
    maps = lib.facodec_resunit_int8_maps
    maps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    maps.restype = ctypes.c_int
    lib.facodec_resunit_int8_maps_bytes.restype = ctypes.c_int
    fn = lib.facodec_resunit_int8
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.facodec_resunit_int8_scratch_bytes
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return amax, maps, lib.facodec_resunit_int8_maps_bytes(), fn, size


def launch_int8_amax(x, alpha1, recip1, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the int8 unit's first kernel on CUDA tensors: max
    |snake1(x)| per batch row into `out` (B,) float32, zeroed here (the
    kernel takes maxima into it with atomics; the CUDA implementation of
    `facodec::resunit_int8_amax`)."""
    B, T, C = x.shape
    x = aligned16(x.contiguous())
    alpha1, recip1 = (aligned16(t.contiguous()) for t in (alpha1, recip1))
    out = torch.zeros(B, dtype=torch.float32, device=x.device) if out is None else out.zero_()
    fn = _int8_entry_points()[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), alpha1.data_ptr(), recip1.data_ptr(), out.data_ptr(), B, T, C,
                 stream)
    if err != 0:
        raise RuntimeError(f"fused_residual_unit: int8 row-maxima launch failed, cudaError {err}")
    build.count_launch(fused_residual_unit, "int8_amax_launches")
    return out


def launch_int8(x, amax, pack: Int8Pack, dilation: int, pad_left: int, ext: int,
                out: Optional[torch.Tensor] = None, c7: Optional[torch.Tensor] = None,
                q1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the int8 unit on checked CUDA operands, into `out` or a
    new tensor (the CUDA implementation of `facodec::resunit_int8`). Given
    `c7` (B, T, C) float32 and `q1` (B, T + 6d, C) int8, the kernel also
    writes its conv7 output and its quantized padded input there, for the
    tests that hold them bit-equal to the plain version's."""
    B, T, C = x.shape
    x = aligned16(x.contiguous())
    q7, sw, w1, *rest = (aligned16(t.contiguous()) for t in pack)
    out = torch.empty_like(x) if out is None else out
    fn, size = (_int8_entry_points()[i] for i in (3, 4))
    maps = tma_maps(q7, w1, "int8")
    dev = x.device.index
    with torch.cuda.device(x.device):
        # each CTA's s2 tile (the 1x1's operand), which the kernel reads back by bulk copy
        nbytes = size(B, T, C, dilation, dev)
        scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), amax.data_ptr(), ctypes.addressof(maps),
                 *(t.data_ptr() for t in (sw, *rest, out)),
                 None if c7 is None else c7.data_ptr(), None if q1 is None else q1.data_ptr(),
                 scratch.data_ptr(), B, T, C, dilation, pad_left, ext, dev, stream)
    if err != 0:
        why = " (shapes the kernel refuses: C, d, and shared memory)" if err == 1 else ""
        raise RuntimeError(f"fused_residual_unit: int8 kernel launch failed, cudaError {err}{why}")
    build.count_launch(fused_residual_unit, "int8_launches")
    return out

