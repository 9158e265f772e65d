"""Precision policy of the matmul / conv path (port of facodec_tpu/ops/precision.py).

A scoped `policy(name)` sets, for the code that runs inside it, the dtype
that conv and matmul operands are rounded to (`compute_dtype`) and the
dtype conv layers return (`out_dtype`):

  float32        every operand and output float32 (the default)
  bfloat16       bf16 operands, float32 accumulation; a conv rounds its
                 result to bf16 and returns it widened to float32, plus a
                 float32 bias: activations stay float32 between layers
  bfloat16_act   bf16 operands, float32 accumulation, bf16 layer outputs:
                 activations stay bf16 between layers; elementwise math
                 (snake) computes in float32 and rounds its result
  int8           selective W8A8: a conv whose fan-in (C_in * K) is at least
                 INT8_MIN_FANIN quantizes its input per batch row and its
                 weight per output channel to int8 (`quantize_dynamic`),
                 sums the int8 products exactly and returns float32
                 (`sum * (sx * sw) + bias`); every other conv and matmul
                 runs as under bfloat16_act. Inference only.
  hybrid         an entry-point policy (api.FACodec): a float32 encode, so
                 the codes are exact, and a bfloat16_act decode. Inside a
                 model it reads as float32.
  hybrid_int8    an entry-point policy: a float32 encode and an int8 decode.

The VQ projections opt out (`exact=True` on their convs), so the code
search stays a float32 island under every policy.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, Optional, Sequence, Tuple

import torch

_ALIASES = {
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "bfloat16_act": "bfloat16_act", "bf16_act": "bfloat16_act",
    "int8": "int8", "w8a8": "int8",
    "hybrid": "hybrid", "hybrid_int8": "hybrid_int8",
}

POLICY_NAMES = tuple(sorted(_ALIASES))
INT8_POLICIES = ("int8", "w8a8", "hybrid_int8")  # names of the inference-only policies

# convs at or above this fan-in (C_in * K) quantize under the int8 policy;
# below it they run as under bfloat16_act (the JAX package's default and
# environment variable). Read on every call, so tests may set it.
INT8_MIN_FANIN = int(os.environ.get("FACODEC_INT8_MIN_FANIN", "4096"))

_BF16 = ("bfloat16", "bfloat16_act", "int8")  # bf16 operands
_BF16_OUT = ("bfloat16_act", "int8")  # bf16 layer outputs

# per thread: a serving thread's policy must not leak into another's
_STATE = threading.local()


def check(name: str) -> str:
    """The canonical name of a policy; raises ValueError on any other."""
    try:
        return _ALIASES[str(name).lower()]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; expected one of "
                         f"{list(POLICY_NAMES)}") from None


def entry_policies(name: str) -> Tuple[str, str]:
    """(encode policy, decode policy) of an entry point's policy, as the
    JAX package's api.FACodec splits them."""
    name = check(name)
    if name == "hybrid":
        return "float32", "bfloat16_act"
    if name == "hybrid_int8":
        return "float32", "int8"
    return name, name


def get_policy() -> str:
    return getattr(_STATE, "name", "float32")


@contextlib.contextmanager
def policy(name: Optional[str]) -> Iterator[None]:
    """Scoped policy; None keeps the current one."""
    old = get_policy()
    if name is not None:
        _STATE.name = check(name)
    try:
        yield
    finally:
        _STATE.name = old


def compute_dtype() -> torch.dtype:
    """The dtype conv / matmul operands are rounded to."""
    return torch.bfloat16 if get_policy() in _BF16 else torch.float32


def out_dtype() -> torch.dtype:
    """The dtype conv layers return (a W8A8 conv returns float32)."""
    return torch.bfloat16 if get_policy() in _BF16_OUT else torch.float32


def cast_operands(*xs):
    """Floating tensors rounded to the compute dtype (a no-op under float32);
    one tensor in, one out."""
    if compute_dtype() == torch.bfloat16:
        xs = tuple(x.to(torch.bfloat16) if x is not None and x.is_floating_point() else x
                   for x in xs)
    return xs[0] if len(xs) == 1 else xs


def bf16_values(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in float32: a float32 product of two such
    values is exact, so a float32 matmul or conv over them is a bf16-operand
    one with float32 accumulation."""
    return x.to(torch.bfloat16).float()


def is_int8(fan_in: int) -> bool:
    """Whether a conv with this fan-in (C_in * K) quantizes to int8 under
    the current policy (see INT8_MIN_FANIN)."""
    return get_policy() == "int8" and fan_in >= INT8_MIN_FANIN


INT8_SCALE = 1.0 / 127.0  # rounded to float32 where it multiplies, as in the JAX package


def quantize_dynamic(x: torch.Tensor, dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic int8 quantization: (int8 values, float32 scale with
    keepdims over `dims`). The scale is max(amax, 1e-12) * (1/127); x / scale
    (a division) is rounded half to even and clipped to [-127, 127]; the
    scale floor keeps all-zero slices finite (they quantize to zeros)."""
    x = x.float()
    amax = x.abs().amax(dim=tuple(dims), keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) * INT8_SCALE
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale
