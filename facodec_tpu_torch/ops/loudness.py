"""ITU-R BS.1770-4 integrated loudness and normalization (host-side numpy).

A copy of facodec_tpu/ops/loudness.py (the port imports nothing of
`facodec_tpu`). The reference's compress path loudness-normalizes its input
to -16 dB LUFS and restores the original loudness on decompress
(dac/model/base.py:176-183, :287-291), through audiotools' BS.1770 meter.
This is the same standard meter: K-weighting (spherical-head high-shelf and
RLB high-pass biquads, coefficients derived for any sample rate as
pyloudnorm and audiotools derive them) -> 400 ms blocks at 75% overlap ->
absolute (-70 LKFS) and relative (-10 LU) gating.

Host-side by design: normalization is one scalar gain decided before the
wave reaches the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# BS.1770 analog prototype parameters (as parameterized by pyloudnorm for
# arbitrary sample rates; at fs=48k these reproduce the tabled coefficients)
_SHELF_FC = 1681.974450955533
_SHELF_GAIN_DB = 3.999843853973347
_SHELF_Q = 0.7071752369554196
_HPF_FC = 38.13547087602444
_HPF_Q = 0.5003270373238773

BLOCK_S = 0.400  # gating block length
OVERLAP = 0.75
ABS_GATE_LKFS = -70.0
REL_GATE_LU = -10.0


def _high_shelf(fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """De Man (2014) parameterized spherical-head shelf — reproduces the
    BS.1770 tabled 48 kHz coefficients EXACTLY (b0 1.53512486, a1
    -1.69065929, ...) and generalizes to any sample rate."""
    K = math.tan(math.pi * _SHELF_FC / fs)
    Vh = 10.0 ** (_SHELF_GAIN_DB / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / _SHELF_Q + K * K
    b = np.array([
        (Vh + Vb * K / _SHELF_Q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / _SHELF_Q + K * K) / a0,
    ])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / _SHELF_Q + K * K) / a0])
    return b, a


def _high_pass(fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """De Man RLB high-pass; reproduces the tabled 48 kHz a-coefficients
    (-1.99004745, 0.99007225) with the table's b = [1, -2, 1]."""
    K = math.tan(math.pi * _HPF_FC / fs)
    a0 = 1.0 + K / _HPF_Q + K * K
    b = np.array([1.0, -2.0, 1.0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / _HPF_Q + K * K) / a0])
    return b, a


def k_weight(wave: np.ndarray, sample_rate: int) -> np.ndarray:
    """Apply the two-stage K-weighting filter. wave (..., T)."""
    from scipy.signal import lfilter

    b1, a1 = _high_shelf(sample_rate)
    b2, a2 = _high_pass(sample_rate)
    y = lfilter(b1, a1, wave, axis=-1)
    return lfilter(b2, a2, y, axis=-1)


def integrated_loudness(wave: np.ndarray, sample_rate: int) -> float:
    """Gated integrated loudness (LKFS) of a mono or (C, T) signal.

    Returns -inf for silence / signals shorter than one 400 ms block."""
    wave = np.asarray(wave, np.float64)
    if wave.ndim == 1:
        wave = wave[None]
    y = k_weight(wave, sample_rate)

    block = int(round(BLOCK_S * sample_rate))
    hop = int(round(block * (1.0 - OVERLAP)))
    T = y.shape[-1]
    if T < block or hop == 0:
        return float("-inf")
    n_blocks = (T - block) // hop + 1
    # per-block mean square, summed over channels (all weights G_i = 1.0 for
    # the front channels FAcodec ever sees; mono/stereo only here)
    sq = np.square(y)
    csum = np.concatenate(
        [np.zeros((sq.shape[0], 1)), np.cumsum(sq, axis=-1)], axis=-1
    )
    starts = np.arange(n_blocks) * hop
    z = (csum[:, starts + block] - csum[:, starts]) / block  # (C, n_blocks)
    z = z.sum(axis=0)
    with np.errstate(divide="ignore"):
        l_blocks = -0.691 + 10.0 * np.log10(z)

    passed = l_blocks > ABS_GATE_LKFS
    if not passed.any():
        return float("-inf")
    rel_thresh = (-0.691 + 10.0 * np.log10(z[passed].mean())) + REL_GATE_LU
    passed &= l_blocks > rel_thresh
    if not passed.any():
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(z[passed].mean()))


def normalize_loudness(
    wave: np.ndarray, sample_rate: int, target_db: float = -16.0,
    max_peak: float = 1.0,
) -> Tuple[np.ndarray, float]:
    """Scale `wave` to `target_db` LKFS (reference base.py:176-183 semantics:
    normalize, then cap the peak like audiotools' ensure_max_of_audio).

    Returns (normalized wave float32, measured input loudness in LKFS). A
    silent input is returned unchanged with loudness -inf; decode callers
    treat non-finite stored loudness as 'no restore'."""
    loud = integrated_loudness(wave, sample_rate)
    if not np.isfinite(loud):
        return np.asarray(wave, np.float32), loud
    gain = 10.0 ** ((target_db - loud) / 20.0)
    out = np.asarray(wave, np.float32) * np.float32(gain)
    peak = float(np.abs(out).max()) if out.size else 0.0
    if peak > max_peak:
        out = out * np.float32(max_peak / peak)
    return out, loud
