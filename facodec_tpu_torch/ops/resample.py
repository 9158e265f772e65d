"""Fractional sinc resampling with julius semantics (port of
facodec_tpu/ops/resample.py).

The multi-scale discriminator downsamples its input as audiotools'
`AudioSignal.resample` does, through `julius.resample_frac`:

  * reduce (old_sr, new_sr) by their gcd;
  * one FIR kernel per output phase j in [0, new_sr): a sinc at the
    rolled-off cutoff `sr = rolloff * min(old, new)`, windowed by a
    squared cosine over `zeros` zero crossings, normalised to unit sum;
  * replicate-pad the input by (width, width + old_sr) and convolve with
    stride old_sr; interleave the new_sr phase outputs and trim to
    int(new_sr * length / old_sr) samples.

The kernel bank is built in numpy once per (old, new, zeros, rolloff); the
work on the device is one strided `conv1d`.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _kernel_bank(old_sr: int, new_sr: int, zeros: int, rolloff: float):
    """((new_sr, 1, 2 * width + old_sr) float32 filter bank, width)."""
    sr = rolloff * min(old_sr, new_sr)
    width = int(math.ceil(zeros * old_sr / sr))
    idx = np.arange(-width, width + old_sr, dtype=np.float64)
    kernels = []
    for i in range(new_sr):
        t = (-i / new_sr + idx / old_sr) * sr
        t = np.clip(t, -zeros, zeros) * math.pi
        window = np.cos(t / zeros / 2) ** 2
        kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window
        kernel /= kernel.sum()
        kernels.append(kernel)
    return np.stack(kernels).astype(np.float32)[:, None, :], width


def resample_frac(x: torch.Tensor, old_sr: int, new_sr: int, zeros: int = 24,
                  rolloff: float = 0.945) -> torch.Tensor:
    """Resample the last axis of (..., T) from old_sr to new_sr."""
    g = math.gcd(int(old_sr), int(new_sr))
    old_sr, new_sr = int(old_sr) // g, int(new_sr) // g
    if old_sr == new_sr:
        return x
    shape, length = x.shape, x.shape[-1]
    xf = x.reshape(-1, length)
    bank, width = _kernel_bank(old_sr, new_sr, zeros, rolloff)
    xp = torch.cat([xf[:, :1].expand(-1, width), xf,
                    xf[:, -1:].expand(-1, width + old_sr)], dim=1)
    kernel = torch.from_numpy(bank).to(device=x.device)
    ys = F.conv1d(xp[:, None, :].float(), kernel, stride=old_sr)  # (B, new_sr, T')
    y = ys.transpose(1, 2).reshape(ys.shape[0], -1)  # the phases interleaved
    out_len = int(new_sr * length / old_sr)
    return y[:, :out_len].reshape(*shape[:-1], out_len).to(x.dtype)
