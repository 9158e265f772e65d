"""Objective quality and disentanglement metrics (host-side numpy).

A copy of facodec_tpu/ops/metrics.py, the same arithmetic in the same
order, so each function returns the JAX package's bits on the same input;
they power `cli/evaluate.py`'s scorecard:

  * si_sdr      scale-invariant SDR in dB (Le Roux et al. 2019).
  * stoi        short-time objective intelligibility (Taal et al. 2010):
                1/3-octave band short-time correlations at 10 kHz.
  * mcd         mel-cepstral distortion in dB over the training mel front
                end (its numpy form, ops/spectral.py `log_mel_np`).
  * f0_autocorr simple autocorrelation F0 tracker (voiced frames only), the
                probe of prosody disentanglement.
  * f0_correlation  Pearson r over co-voiced frames of two F0 tracks.

All functions take float numpy waves.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from facodec_tpu_torch.ops.spectral import MEL_STD, log_mel_np


def si_sdr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SDR in dB. est/ref (T,); zero-mean internally."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    T = min(len(est), len(ref))
    est, ref = est[:T] - est[:T].mean(), ref[:T] - ref[:T].mean()
    alpha = float(np.dot(est, ref) / (np.dot(ref, ref) + eps))
    target = alpha * ref
    noise = est - target
    return float(10.0 * np.log10(
        (np.dot(target, target) + eps) / (np.dot(noise, noise) + eps)
    ))


# --------------------------------------------------------------------- STOI

_STOI_SR = 10000
_FRAME = 256  # 25.6 ms at 10 kHz
_NFFT = 512
_NBANDS = 15
_FIRST_CF = 150.0
_SEG = 30  # 384 ms short-time segments
_BETA_DB = -15.0
_SIL_DB = 40.0


def _resample_10k(x: np.ndarray, sr: int) -> np.ndarray:
    if sr == _STOI_SR:
        return np.asarray(x, np.float64)
    from scipy.signal import resample_poly

    g = math.gcd(sr, _STOI_SR)
    return resample_poly(np.asarray(x, np.float64), _STOI_SR // g, sr // g)


def _third_octave_bands() -> np.ndarray:
    """(15, NFFT/2+1) binary band matrix (Taal 2010 §II-A)."""
    f = np.linspace(0, _STOI_SR / 2, _NFFT // 2 + 1)
    cfs = _FIRST_CF * 2.0 ** (np.arange(_NBANDS) / 3.0)
    lo = cfs * 2.0 ** (-1.0 / 6.0)
    hi = cfs * 2.0 ** (1.0 / 6.0)
    H = np.zeros((_NBANDS, len(f)))
    for k in range(_NBANDS):
        # nearest-bin band edges, as in the reference implementation
        i_lo = int(np.argmin(np.abs(f - lo[k])))
        i_hi = int(np.argmin(np.abs(f - hi[k])))
        H[k, i_lo:i_hi] = 1.0
    return H


def _frames(x: np.ndarray) -> np.ndarray:
    """50%-overlap hann frames (n, FRAME)."""
    hop = _FRAME // 2
    n = (len(x) - _FRAME) // hop + 1
    if n <= 0:
        return np.zeros((0, _FRAME))
    idx = np.arange(n)[:, None] * hop + np.arange(_FRAME)[None, :]
    return x[idx] * np.hanning(_FRAME)[None, :]


def stoi(est: np.ndarray, ref: np.ndarray, sample_rate: int) -> float:
    """STOI in [~0, 1]; higher = more intelligible. ref is the clean signal.

    Returns nan when fewer than SEG frames survive silence removal (signal
    too short/silent to score)."""
    x = _resample_10k(ref, sample_rate)
    y = _resample_10k(est, sample_rate)
    T = min(len(x), len(y))
    x, y = x[:T], y[:T]

    # silence removal on the CLEAN signal's frame energies (§II-B)
    xf, yf = _frames(x), _frames(y)
    if len(xf) == 0:
        return float("nan")
    en = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = en > en.max() - _SIL_DB
    xf, yf = xf[keep], yf[keep]
    if len(xf) < _SEG:
        return float("nan")

    H = _third_octave_bands()
    X = np.abs(np.fft.rfft(xf, n=_NFFT, axis=1)) ** 2  # (n, bins)
    Y = np.abs(np.fft.rfft(yf, n=_NFFT, axis=1)) ** 2
    Xb = np.sqrt(X @ H.T)  # (n, bands)
    Yb = np.sqrt(Y @ H.T)

    n = len(Xb)
    clip = 10.0 ** (-_BETA_DB / 20.0)
    d = []
    for m in range(_SEG, n + 1):
        xs = Xb[m - _SEG : m]  # (SEG, bands)
        ys = Yb[m - _SEG : m]
        alpha = np.linalg.norm(xs, axis=0) / (np.linalg.norm(ys, axis=0) + 1e-12)
        ys = np.minimum(ys * alpha[None, :], xs * (1.0 + clip))
        xm = xs - xs.mean(axis=0, keepdims=True)
        ym = ys - ys.mean(axis=0, keepdims=True)
        num = (xm * ym).sum(axis=0)
        den = np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12
        d.append(num / den)
    return float(np.mean(d))


# ----------------------------------------------------------------------- MCD
HOP = 300


def _mel(wave: np.ndarray) -> np.ndarray:
    """(T,) -> (T // hop, 80): the JAX pipeline's `compute_mel` at its
    defaults (24 kHz, hop 300), in numpy."""
    return log_mel_np(wave[None])[0, : len(wave) // HOP]


def mcd(est: np.ndarray, ref: np.ndarray, n_mcc: int = 13,
        floor_db: float = 60.0) -> float:
    """Mel-cepstral distortion in dB (lower = closer), the standard VC/codec
    spectral-fidelity number: (10/ln10)·sqrt(2·Σ_d (c_d^est − c_d^ref)²)
    averaged over frames, where c_1..c_n_mcc are DCT-II cepstra of the
    natural-log mel spectrogram (c0/energy excluded). Frames are
    time-aligned (no DTW) — a codec reconstruction is synchronous with its
    input. Uses the JAX pipeline's mel front-end (its `compute_mel`, in
    numpy), so the number is directly comparable to the mel_l1 training
    objective. Returns nan for sub-frame inputs."""
    T = min(len(est), len(ref))
    me = _mel(np.asarray(est[:T], np.float64).astype(np.float32))
    mr = _mel(np.asarray(ref[:T], np.float64).astype(np.float32))
    n = min(len(me), len(mr))
    if n == 0:
        return float("nan")
    # undo the training normalization and halve: the front-end is log-POWER,
    # MCD convention is log-MAGNITUDE cepstra (the affine offset cancels in
    # the difference; the scale must not)
    ln_e = 0.5 * me[:n] * MEL_STD
    ln_r = 0.5 * mr[:n] * MEL_STD
    # shared peak-relative dynamic-range floor: without it, near-silent mel
    # bins (log of the 1e-5 absolute floor) dominate the cepstral distance
    # with hundreds of meaningless dB whenever one signal has any noise floor
    floor = max(ln_e.max(), ln_r.max()) - floor_db * np.log(10.0) / 20.0
    ln_e = np.maximum(ln_e, floor)
    ln_r = np.maximum(ln_r, floor)
    N = ln_e.shape[1]
    k = np.arange(1, n_mcc + 1)[:, None]
    dct = np.sqrt(2.0 / N) * np.cos(np.pi * k * (np.arange(N)[None, :] + 0.5) / N)
    diff = (ln_e - ln_r) @ dct.T  # (frames, n_mcc)
    per_frame = (10.0 / np.log(10.0)) * np.sqrt(
        2.0 * np.sum(diff * diff, axis=1))
    return float(np.mean(per_frame))


# ---------------------------------------------------------------- F0 probes


def f0_autocorr(
    wave: np.ndarray, sample_rate: int = 24000, hop: int = 300,
    fmin: float = 60.0, fmax: float = 500.0, voicing_thresh: float = 0.3,
) -> np.ndarray:
    """Per-frame F0 in Hz via windowed normalized autocorrelation;
    unvoiced/silent frames -> 0. Frame length 4 hops (50 ms at 24 kHz)."""
    wave = np.asarray(wave, np.float64)
    win = 4 * hop
    lag_min = int(sample_rate / fmax)
    lag_max = min(int(sample_rate / fmin), win - 1)
    n = max(0, (len(wave) - win) // hop + 1)
    out = np.zeros(n, np.float64)
    if n == 0:
        return out
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    frames = wave[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    # FFT-based autocorrelation of every frame at once
    nfft = 1 << int(np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(frames, n=nfft, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, n=nfft, axis=1)[:, : lag_max + 1]
    e0 = ac[:, 0] + 1e-12
    seg = ac[:, lag_min : lag_max + 1] / e0[:, None]
    best = np.argmax(seg, axis=1)
    peak = seg[np.arange(n), best]
    voiced = (peak > voicing_thresh) & (e0 > 1e-8 * win)
    out[voiced] = sample_rate / (best[voiced] + lag_min)
    return out


def f0_correlation(f0_a: np.ndarray, f0_b: np.ndarray) -> Tuple[float, float]:
    """(Pearson r over co-voiced frames of log-F0, co-voicing agreement).
    r is nan when fewer than 3 co-voiced frames exist."""
    n = min(len(f0_a), len(f0_b))
    a, b = np.asarray(f0_a[:n]), np.asarray(f0_b[:n])
    va, vb = a > 0, b > 0
    agree = float(np.mean(va == vb)) if n else float("nan")
    both = va & vb
    if both.sum() < 3:
        return float("nan"), agree
    la, lb = np.log(a[both]), np.log(b[both])
    la, lb = la - la.mean(), lb - lb.mean()
    denom = float(np.linalg.norm(la) * np.linalg.norm(lb))
    if denom < 1e-12:
        return float("nan"), agree
    return float(np.dot(la, lb) / denom), agree
