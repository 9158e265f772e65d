"""W8A8 LSTM recurrence: CUDA kernel wrapper over the plain version.

The JAX package's opt-in int8 recurrence (facodec_tpu/nn/lstm.py
`lstm_layer` under `_lstm_int8`, FACODEC_LSTM_INT8) is an XLA scan, not a
Pallas kernel; cuDNN has no int8 recurrence, so the port carries it on
csrc/lstm_int8.cu, one launch a layer. `lstm_int8` checks its operands and
calls the custom op `facodec::lstm_int8` (ops.py), which launches the kernel
(`launch`) for CUDA tensors, or raises. For CPU tensors it runs
`lstm_int8_reference` itself, through the op (whose CPU implementation that
is) only while a program is being exported. Forward only: the path is
inference only, as in the JAX package.

Operands of one layer: `x_proj` (B, T, 4H) float32, the hoisted input
projection plus both biases; `w_q` (4H, H) int8 and `w_scale` (4H,)
float32, w_hh quantized per row (`quantize_weight`: the JAX package's
`quantize_dynamic(w_hh.T, axes=0)`, transposed, which the kernel reads a
gate column at a time); `h0`, `c0` (B, H) float32. Returns (y (B, T, H),
hT, cT) in float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from facodec_tpu_torch.ops.kernels import build
from facodec_tpu_torch.ops.precision import quantize_dynamic


def quantize_weight(w_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_hh (4H, H) -> (w_q (4H, H) int8, w_scale (4H,) float32), each row
    quantized on its own (the JAX package's per-column w_hh.T, transposed)."""
    q, s = quantize_dynamic(w_hh, (1,))
    return q.contiguous(), s.reshape(-1).contiguous()


def exact_sums(h_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """h_q (B, H) int8 against w_q (4H, H) int8: every sum formed exactly
    (float64 holds any such sum, |sum| < 2^53, where a float32 matmul would
    round one over 2^24), then rounded to float32 once, as JAX's int32 ->
    float32 cast rounds it."""
    return (h_q.double() @ w_q.double().t()).float()


def lstm_int8_reference(x_proj: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        h0: torch.Tensor, c0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version, op for op the JAX package's int8 scan step: h
    quantized per row, `exact_sums`, then `f32(sum) * (s_h * w_scale)`,
    plus the step's projection, and the cell in float32."""
    scale_w = w_scale.reshape(1, -1)
    h, c = h0.float(), c0.float()
    ys = []
    for t in range(x_proj.shape[1]):
        h_q, s_h = quantize_dynamic(h, (-1,))
        gates = x_proj[:, t] + exact_sums(h_q, w_q) * (s_h * scale_w)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, 1), h, c


def _check(x_proj, w_q, w_scale, h0, c0) -> None:
    if x_proj.ndim != 3 or x_proj.shape[-1] % 4 or x_proj.shape[0] == 0 or x_proj.shape[1] == 0:
        raise ValueError(f"lstm_int8: x_proj must be (B >= 1, T >= 1, 4H), got "
                         f"{tuple(x_proj.shape)}")
    B, _, G = x_proj.shape
    H = G // 4
    want = {"w_q": (G, H), "w_scale": (G,), "h0": (B, H), "c0": (B, H)}
    for name, t in (("w_q", w_q), ("w_scale", w_scale), ("h0", h0), ("c0", c0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"lstm_int8: {name} must be {want[name]} for x_proj "
                             f"{tuple(x_proj.shape)}, got {tuple(t.shape)}")
    for name, t, dtype in (("x_proj", x_proj, torch.float32), ("w_q", w_q, torch.int8),
                           ("w_scale", w_scale, torch.float32), ("h0", h0, torch.float32),
                           ("c0", c0, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"lstm_int8: {name} must be {dtype}, got {t.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"lstm_int8: {name} on {t.device}, x_proj on {x_proj.device}")
    if x_proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_int8: no kernel for device {x_proj.device}")
    if x_proj.device.type == "cuda":
        if not all(t.is_contiguous() for t in (x_proj, w_q, w_scale, h0, c0)):
            raise ValueError("lstm_int8: every operand must be contiguous")
        if H % 4:  # the kernel reads h's rows as float4s
            raise ValueError(f"lstm_int8: the kernel takes H % 4 == 0, got H={H}")


def lstm_int8(x_proj: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              h0: torch.Tensor, c0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's W8A8 recurrence: (y (B, T, H), hT, cT)."""
    _check(x_proj, w_q, w_scale, h0, c0)
    if x_proj.device.type == "cpu" and not torch.compiler.is_exporting():
        return lstm_int8_reference(x_proj, w_q, w_scale, h0, c0)
    return torch.ops.facodec.lstm_int8(x_proj, w_q, w_scale, h0, c0)


lstm_int8.launches = 0


@functools.lru_cache(maxsize=None)
def _entry_points():
    """(recurrence, plan, barriers) from csrc/lstm_int8.cu, typed once."""
    lib = build.library("lstm_int8")
    fn = lib.facodec_lstm_int8
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = lib.facodec_lstm_int8_plan
    plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    plan.restype = ctypes.c_int
    barriers = lib.facodec_lstm_int8_barriers
    barriers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    barriers.restype = ctypes.c_int
    return fn, plan, barriers


PLAN_KEYS = ("rows_a_task", "units_a_cta", "ctas", "padded_k", "rows_a_chunk", "smem_bytes")


def plan(B: int, H: int, device: torch.device) -> Dict[str, int]:
    """The kernel's launch shape for batch B and width H on a CUDA device."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    with torch.cuda.device(device):
        err = _entry_points()[1](B, H, out)
    if err != 0:
        raise RuntimeError(f"lstm_int8: no launch shape for B={B}, H={H}, cudaError {err}")
    return dict(zip(PLAN_KEYS, out))


def launch(x_proj: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, h0: torch.Tensor,
           c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer on CUDA tensors (the CUDA implementation of
    `facodec::lstm_int8`)."""
    _check(x_proj, w_q, w_scale, h0, c0)
    B, T, G = x_proj.shape
    H = G // 4
    y = torch.empty(B, T, H, dtype=torch.float32, device=x_proj.device)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    fn = _entry_points()[0]
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_proj.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), h0.data_ptr(),
                 c0.data_ptr(), y.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_int8: kernel launch failed (B={B}, T={T}, H={H}), "
                           f"cudaError {err}")
    build.count_launch(lstm_int8)
    return y, hT, cT


def barriers(B: int, H: int, n: int, device: torch.device) -> None:
    """`n` grid barriers on the recurrence's grid for (B, H), on the current
    stream and nothing else (the serial floor's yardstick; not counted)."""
    with torch.cuda.device(device):
        err = _entry_points()[2](B, H, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_int8: barrier launch failed, cudaError {err}")
