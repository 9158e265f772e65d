"""STFT / log-mel front end with torch semantics.

Port of facodec_tpu/ops/spectral.py: n_fft 2048, win 1200 (periodic Hann,
zero-padded to the centre of the FFT frame), hop 300, centred reflect
padding, power 2, 80 HTK mel bands, `(log(1e-5 + mel) + 4) / 4`. The window
and the filterbank are built in numpy (re-homed from the JAX module so the
port needs no JAX) and held as non-persistent buffers.

`mel_frames` is the streaming form (port of facodec_tpu/models/streaming.py
`_mel_frames`): the same log-mel from explicit frames of a context, with
`reflect_front` / `reflect_back` for a stream's ends.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn


def hann_window_np(win_length: int) -> np.ndarray:
    """Periodic Hann window, as `torch.hann_window(N, periodic=True)`."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(np.float32)


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=32)
def _mel_filterbank_np(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float,
    f_max: Optional[float],
    norm: Optional[str],
) -> np.ndarray:
    """Triangular HTK mel filterbank, (n_freqs, n_mels) float32, as
    `torchaudio.functional.melscale_fbanks(..., mel_scale="htk")`."""
    if f_max is None:
        f_max = sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = _hz_to_mel_htk(np.asarray(f_min))
    m_max = _hz_to_mel_htk(np.asarray(f_max))
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


N_FFT = 2048
WIN_LENGTH = 1200
N_MELS = 80
MEL_MEAN, MEL_STD = -4.0, 4.0


class LogMelSpectrogram(nn.Module):
    """(B, T) wave -> (B, n_frames, 80) normalised log-mel."""

    def __init__(self, sample_rate: int = 24000, hop_length: int = 300):
        super().__init__()
        self.hop_length = hop_length
        window = hann_window_np(WIN_LENGTH)
        lpad = (N_FFT - WIN_LENGTH) // 2
        window = np.pad(window, (lpad, N_FFT - WIN_LENGTH - lpad))
        self.register_buffer("window", torch.from_numpy(window), persistent=False)
        fb = _mel_filterbank_np(N_FFT // 2 + 1, N_MELS, sample_rate, 0.0, None, None)
        self.register_buffer("fb", torch.from_numpy(fb.copy()), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = torch.stft(x, N_FFT, hop_length=self.hop_length, win_length=N_FFT,
                       window=self.window, center=True, pad_mode="reflect",
                       normalized=False, onesided=True, return_complex=True)
        spec = torch.square(torch.abs(z)).transpose(1, 2)  # (B, frames, freqs)
        mel = spec @ self.fb
        return (torch.log(1e-5 + mel) - MEL_MEAN) / MEL_STD


def mel_frames(wave_ctx: torch.Tensor, n_frames: int, hop_length: int, sample_rate: int,
               n_mels: int = N_MELS) -> torch.Tensor:
    """(B, n_frames * hop + WIN_LENGTH - hop) context -> (B, n_frames, n_mels)
    normalised log-mel; frame i's window is ctx[i * hop : i * hop + WIN_LENGTH].
    Its magnitude equals the centred STFT's, whose Hann window is zero-padded
    to N_FFT: only the phase differs."""
    dev = wave_ctx.device
    win = torch.from_numpy(hann_window_np(WIN_LENGTH)).to(dev, wave_ctx.dtype)
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop_length
           + torch.arange(WIN_LENGTH, device=dev)[None, :])
    frames = wave_ctx[:, idx] * win
    spec = torch.square(torch.abs(torch.fft.rfft(frames, n=N_FFT, dim=-1)))
    fb = _mel_filterbank_np(N_FFT // 2 + 1, n_mels, sample_rate, 0.0, None, None)
    mel = spec @ torch.from_numpy(fb).to(dev, spec.dtype)
    return (torch.log(1e-5 + mel) - MEL_MEAN) / MEL_STD


def reflect_front(chunk: torch.Tensor, pad: int) -> torch.Tensor:
    """torch-style left reflect of a stream's start: out[j] = chunk[pad - j]."""
    return torch.flip(chunk[:, 1 : pad + 1], dims=[1])


def reflect_back(tail: torch.Tensor, pad: int) -> torch.Tensor:
    """torch-style right reflect of a stream's end: out[j] = tail[-2 - j]."""
    return torch.flip(tail[:, tail.shape[1] - 1 - pad : tail.shape[1] - 1], dims=[1])
