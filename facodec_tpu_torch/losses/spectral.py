"""Spectral reconstruction losses (port of facodec_tpu/losses/spectral.py).

The reference's audiotools criteria: `multi_scale_stft_loss` (log-magnitude
and magnitude L1 per window), `mel_spectrogram_loss` (7-scale log-mel L1
over librosa's slaney mel scale and slaney-normalised filterbanks, unlike
the codec front end's HTK mels), `l1_loss` and `sisdr_loss` on waves. Waves
are (B, T). The STFT is audiotools' default: periodic Hann, window = n_fft
= w, hop w / 4, centred reflect padding. The filterbanks are numpy, a copy
of the JAX module's, held per device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from facodec_tpu_torch.ops.spectral import hann_window


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    mel = 3.0 * f / 200.0
    min_log_hz, min_log_mel, logstep = 1000.0, 15.0, math.log(6.4) / 27.0
    above = f >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f = 200.0 * m / 3.0
    min_log_hz, min_log_mel, logstep = 1000.0, 15.0, math.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=64)
def librosa_mel_fbank_np(sr: int, n_fft: int, n_mels: int, fmin: float,
                         fmax: Optional[float]) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') -> (n_freqs, n_mels) float32."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_f = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _mel_fbank(device: torch.device, dtype: torch.dtype, *args) -> torch.Tensor:
    return torch.from_numpy(librosa_mel_fbank_np(*args)).to(device, dtype)


def _magnitude(x: torch.Tensor, w: int) -> torch.Tensor:
    """|STFT|, (B, T) -> (B, frames, w // 2 + 1)."""
    window = hann_window(w, x.device, x.dtype)
    z = torch.stft(x, w, hop_length=w // 4, win_length=w, window=window, center=True,
                   pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    return torch.abs(z).transpose(1, 2)


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def _log10_pow(x: torch.Tensor, clamp_eps: float, pow: float) -> torch.Tensor:
    return torch.log10(torch.pow(torch.clamp_min(x, clamp_eps), pow))


def multi_scale_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                          window_lengths: Sequence[int] = (2048, 512), clamp_eps: float = 1e-5,
                          mag_weight: float = 1.0, log_weight: float = 1.0,
                          pow: float = 2.0) -> torch.Tensor:
    loss = 0.0
    for w in window_lengths:
        xm, ym = _magnitude(pred, w), _magnitude(target, w)
        loss = loss + log_weight * _l1(_log10_pow(xm, clamp_eps, pow),
                                       _log10_pow(ym, clamp_eps, pow)) + mag_weight * _l1(xm, ym)
    return loss


def mel_spectrogram_loss(pred: torch.Tensor, target: torch.Tensor, sample_rate: int = 24000,
                         n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
                         window_lengths: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
                         clamp_eps: float = 1e-5, mag_weight: float = 0.0,
                         log_weight: float = 1.0, pow: float = 1.0,
                         mel_fmin: Optional[Sequence[float]] = None,
                         mel_fmax: Optional[Sequence[Optional[float]]] = None) -> torch.Tensor:
    """The reference's 7-scale mel loss."""
    mel_fmin = [0.0] * len(n_mels) if mel_fmin is None else mel_fmin
    mel_fmax = [None] * len(n_mels) if mel_fmax is None else mel_fmax
    loss = 0.0
    for m, w, lo, hi in zip(n_mels, window_lengths, mel_fmin, mel_fmax):
        fb = _mel_fbank(pred.device, pred.dtype, sample_rate, w, m, lo, hi)
        xm, ym = _magnitude(pred, w) @ fb, _magnitude(target, w) @ fb
        loss = loss + log_weight * _l1(_log10_pow(xm, clamp_eps, pow),
                                       _log10_pow(ym, clamp_eps, pow)) + mag_weight * _l1(xm, ym)
    return loss


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _l1(pred, target)


def sisdr_loss(pred: torch.Tensor, target: torch.Tensor, scaling: bool = True,
               zero_mean: bool = True, clip_min: Optional[float] = None) -> torch.Tensor:
    """Negative SI-SDR of (B, T) waves."""
    eps = 1e-8
    references = target.reshape(target.shape[0], -1, 1)
    estimates = pred.reshape(pred.shape[0], -1, 1)
    if zero_mean:
        references = references - torch.mean(references, dim=1, keepdim=True)
        estimates = estimates - torch.mean(estimates, dim=1, keepdim=True)
    ref_proj = torch.sum(torch.square(references), dim=-2) + eps
    ref_on_est = torch.sum(estimates * references, dim=-2) + eps
    scale = (ref_on_est / ref_proj)[:, None] if scaling else 1.0
    e_true = scale * references
    e_res = estimates - e_true
    signal = torch.sum(torch.square(e_true), dim=1)
    noise = torch.sum(torch.square(e_res), dim=1)
    sdr = -10.0 * torch.log10(signal / noise + eps)
    if clip_min is not None:
        sdr = torch.clamp_min(sdr, clip_min)
    return torch.mean(sdr)
