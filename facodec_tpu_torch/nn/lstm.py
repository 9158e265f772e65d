"""Skip-connected LSTM (port of facodec_tpu/nn/lstm.py `SLSTM`).

The JAX package writes the recurrence as a `lax.scan` with torch's gate
order and parameter names, so here `torch.nn.LSTM` (cuDNN on the card)
holds the same `weight_ih_l{k}` / `weight_hh_l{k}` / `bias_*` tensors in a
submodule named `lstm`. The one-shot call starts from a zero state; a
stream passes `(h, c)`, each (layers, B, H) as in the JAX package, and
gets the final state back.

Under the `bfloat16`, `bfloat16_act` and `int8` policies the JAX package
rounds both matmuls' operands to bf16 (the input, the weights and, at
every step, h) and keeps the (h, c) carries, the gates and the output in
float32; the output plus the skip (bf16 or float32) is float32. cuDNN cannot round h at each step, and a Python
loop over the 800 steps of a 10 s decode is not a route on the card. So
the port runs the float32 LSTM on the bf16-rounded input and weights
(biases stay float32): every rounding but h's. Without gradients the
rounded weights are a cached copy of `lstm`, made again whenever a
parameter changes. Where autograd records (a bf16 training step) and in a
program being exported (utils/export.py) they are graph ops on every call,
run through `lstm` by `torch.func.functional_call`, which still lowers to
one `aten.lstm` (cuDNN on the card): the rounding is then part of the
graph, as JAX's cast is part of its traced forward, and the float32
weights get their gradients through it.

The JAX package's opt-in W8A8 recurrence (`FACODEC_LSTM_INT8=1`, never a
default) is ported: where `lstm_int8(H)` holds (the flag, a bf16 policy and
a recurrent weight of at least FACODEC_LSTM_INT8_MIN_BYTES in bf16: at the
flagship widths the decoder's 1536-wide LSTM, not the encoder's), each
layer runs the hoisted input projection and then `facodec::lstm_int8`
(ops/kernels/lstm.py: the kernel csrc/lstm_int8.cu on the card, one launch
a layer; the plain version on the CPU), with w_hh quantized per gate column
to int8 and h per row at every step, as the JAX package's int8 scan does.
The projection takes bf16 operands, as JAX's does, but sums them in
float64 and rounds once to float32 (JAX sums in float32), then adds both
biases. A float32 GEMM's bits depend on how many rows one call holds (cuBLAS
picks its algorithm by shape), and the quantizer turns a one-ulp change of
a gate into another int8 h, so a stream fed in chunks would leave the
one-shot's path. Float64 sums of bf16 products are exact unless the
products lie far apart in scale, so they make that rare rather than
impossible: on the H100 the flagship decoder's LSTM gave the one-shot bits
in 4-frame chunks at 4 x 10 s (chip_smoke.py phase 18c measures it on
every run), and the CPU tests hold it at their shapes. The quantized
weights and the bf16-rounded w_ih (float32, widened inside the call) are
kept per parameter storage and version like the rounded LSTM (graph ops
while exporting). Inference only: the op has no gradient.
"""

from __future__ import annotations

import copy
import os
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from facodec_tpu_torch.ops.kernels import lstm as lstm_kernel
from facodec_tpu_torch.ops.precision import bf16_values, compute_dtype, get_policy

LSTMState = Tuple[torch.Tensor, torch.Tensor]

_INT8_POLICIES = ("bfloat16", "bfloat16_act", "int8")  # the JAX package's non-float32 policies


def lstm_int8(hidden: int) -> bool:
    """Whether an LSTM layer of this width runs the W8A8 recurrence: the
    JAX package's `_lstm_int8` (facodec_tpu/nn/lstm.py:38-77), reading its
    two environment variables on every call as JAX reads them at trace
    time. FACODEC_LSTM_INT8=1, a policy other than float32 (the port's
    entry-point names `hybrid` and `hybrid_int8` read as float32 inside a
    model, as everywhere in ops/precision.py), and 4 * H * H * 2 bytes of
    bf16 w_hh at least FACODEC_LSTM_INT8_MIN_BYTES (12 MiB by default)."""
    if os.environ.get("FACODEC_LSTM_INT8", "0") != "1":
        return False
    if get_policy() not in _INT8_POLICIES:
        return False
    min_bytes = int(os.environ.get("FACODEC_LSTM_INT8_MIN_BYTES", str(12 << 20)))
    return 4 * hidden * hidden * 2 >= min_bytes


class SLSTM(nn.Module):
    """y = LSTM(x) + x over NTC input."""

    def __init__(self, dimension: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dimension, dimension, num_layers, batch_first=True)
        # plain dicts: not submodules, not in the state dict
        self._bf16_cache: dict = {}
        self._int8_cache: dict = {}

    def _key(self) -> tuple:
        return tuple((p.data_ptr(), p._version) for p in self.lstm.parameters())

    def _records_grad(self) -> bool:
        return torch.is_grad_enabled() and any(p.requires_grad for p in self.lstm.parameters())

    def _bf16_lstm(self) -> nn.LSTM:
        """`lstm` with bf16-rounded weight matrices, cached per parameter
        storage and version."""
        key = self._key()
        lstm = self._bf16_cache.get(key)
        if lstm is None:
            lstm = copy.deepcopy(self.lstm)
            with torch.no_grad():
                for name, p in lstm.named_parameters():
                    if name.startswith("weight"):
                        p.copy_(bf16_values(p))
            lstm.flatten_parameters()
            self._bf16_cache.clear()
            self._bf16_cache[key] = lstm
        return lstm

    def _int8_layers(self) -> List[tuple]:
        """Per layer (w_ih rounded to bf16, b_ih + b_hh, w_q, w_scale), kept
        per parameter storage and version; graph ops on every call while a
        program is being exported."""
        def make():
            lstm = self.lstm
            return [(bf16_values(getattr(lstm, f"weight_ih_l{k}")),
                     getattr(lstm, f"bias_ih_l{k}") + getattr(lstm, f"bias_hh_l{k}"),
                     *lstm_kernel.quantize_weight(getattr(lstm, f"weight_hh_l{k}")))
                    for k in range(lstm.num_layers)]

        if torch.compiler.is_exporting():
            return make()
        key = self._key()
        layers = self._int8_cache.get(key)
        if layers is None:
            with torch.no_grad():
                layers = make()
            self._int8_cache.clear()
            self._int8_cache[key] = layers
        return layers

    def _int8_forward(self, x: torch.Tensor, state: Optional[LSTMState]):
        """The JAX package's stacked layers under the int8 gate: each layer's
        projection `matmul(y, w_ih.T) + (b_ih + b_hh)` over the whole
        sequence (its sums in float64: the module docstring), then its
        recurrence; the carries are float32."""
        L, H = self.lstm.num_layers, self.lstm.hidden_size
        if state is None:
            h0 = c0 = x.new_zeros(L, x.shape[0], H, dtype=torch.float32)
        else:
            h0, c0 = state[0].float(), state[1].float()
        y, hs, cs = x, [], []
        for k, (w_ih, bias, w_q, w_scale) in enumerate(self._int8_layers()):
            x_proj = F.linear(bf16_values(y).double(), w_ih.double()).float() + bias
            y, hT, cT = lstm_kernel.lstm_int8(x_proj.contiguous(), w_q, w_scale,
                                              h0[k].contiguous(), c0[k].contiguous())
            hs.append(hT)
            cs.append(cT)
        return y, (torch.stack(hs), torch.stack(cs))

    def forward(self, x: torch.Tensor, state: Optional[LSTMState] = None,
                return_state: bool = False):
        if lstm_int8(self.lstm.hidden_size):
            y, new_state = self._int8_forward(x, state)
            y = y + x.float()
        elif compute_dtype() == torch.bfloat16:
            if torch.compiler.is_exporting() or self._records_grad():
                rounded = {name: bf16_values(p) if name.startswith("weight") else p
                           for name, p in self.lstm.named_parameters()}
                y, new_state = torch.func.functional_call(self.lstm, rounded,
                                                          (bf16_values(x), state))
            else:
                y, new_state = self._bf16_lstm()(bf16_values(x), state)
            y = y + x.float()
        else:
            y, new_state = self.lstm(x, state)
            y = y + x
        return (y, new_state) if return_state else y
