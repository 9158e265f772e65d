"""1-D padding math for the causal convolutions (NTC layout).

Port of facodec_tpu/ops/padding.py: the same static-int shape arithmetic and
the same reflect padding with the short-input zero-extend fallback (the
codec pads in reflect mode only).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def get_extra_padding_for_conv1d(
    length: int, kernel_size: int, stride: int, padding_total: int = 0
) -> int:
    """Extra right-padding so the final conv window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def pad1d(x: torch.Tensor, paddings: Tuple[int, int]) -> torch.Tensor:
    """Reflect-pad the time axis of an NTC tensor.

    `F.pad(..., "reflect")` refuses a pad at least as long as the input, so a
    short input is zero-extended first and the extension trimmed after.
    Returns an NTC view of a time-contiguous (NCT) tensor.
    """
    padding_left, padding_right = paddings
    if padding_left < 0 or padding_right < 0:
        raise ValueError(f"negative padding {paddings}")
    xt = x.transpose(1, 2)
    length = xt.shape[-1]
    max_pad = max(padding_left, padding_right)
    extra_pad = 0
    if length <= max_pad:
        extra_pad = max_pad - length + 1
        xt = F.pad(xt, (0, extra_pad))
    padded = F.pad(xt, (padding_left, padding_right), mode="reflect")
    return padded[..., : padded.shape[-1] - extra_pad].transpose(1, 2)
