"""Precision policy of the matmul / conv path (port of facodec_tpu/ops/precision.py).

A scoped `policy(name)` sets, for the code that runs inside it, the dtype
that conv and matmul operands are rounded to (`compute_dtype`) and the
dtype conv layers return (`out_dtype`):

  float32        every operand and output float32 (the default)
  bfloat16_act   bf16 operands, float32 accumulation, bf16 layer outputs:
                 activations stay bf16 between layers; elementwise math
                 (snake) computes in float32 and rounds its result
  hybrid         an entry-point policy (api.FACodec): a float32 encode, so
                 the codes are exact, and a bfloat16_act decode. Inside a
                 model it reads as float32.

The VQ projections opt out (`exact=True` on their convs), so the code
search stays a float32 island under every policy.

Not ported (ROADMAP item 6): `bfloat16` (bf16 operands with float32 layer
outputs, which would need a third form of the residual-unit kernel) and
the int8 policies; asking for them raises NotImplementedError.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch

_ALIASES = {
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "bfloat16_act": "bfloat16_act", "bf16_act": "bfloat16_act",
    "hybrid": "hybrid",
}
_UNPORTED = {
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "w8a8": "int8", "hybrid_int8": "hybrid_int8",
}

# per thread: a serving thread's policy must not leak into another's
_STATE = threading.local()


def check(name: str) -> str:
    """The canonical name of a supported policy; raises on any other."""
    key = str(name).lower()
    if key in _UNPORTED:
        raise NotImplementedError(
            f"precision policy {_UNPORTED[key]!r} is not ported yet (ROADMAP item 6); "
            f"the port runs {sorted(set(_ALIASES.values()))}")
    try:
        return _ALIASES[key]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; expected one of "
                         f"{sorted(_ALIASES)}") from None


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


def bf16_active() -> bool:
    return get_policy() == "bfloat16_act"


def compute_dtype() -> torch.dtype:
    """The dtype conv / matmul operands are rounded to."""
    return torch.bfloat16 if bf16_active() else torch.float32


def out_dtype() -> torch.dtype:
    """The dtype conv layers return."""
    return torch.bfloat16 if bf16_active() else torch.float32


def cast_operands(*xs):
    """Floating tensors rounded to the compute dtype (a no-op under float32);
    one tensor in, one out."""
    if bf16_active():
        xs = tuple(x.to(torch.bfloat16) if x is not None and x.is_floating_point() else x
                   for x in xs)
    return xs[0] if len(xs) == 1 else xs


def bf16_values(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in float32: a float32 product of two such
    values is exact, so a float32 matmul or conv over them is a bf16-operand
    one with float32 accumulation."""
    return x.to(torch.bfloat16).float()
