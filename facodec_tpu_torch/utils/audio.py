"""Wav files in and out: mono float32 at the codec's rate.

Port of facodec_tpu/cli/_io.py `save_wav` and of the reader the JAX CLI
takes wherever its native library builds (facodec_tpu/native/wav_io.cpp,
chosen by facodec_tpu/train/data.py `load_wav`), in numpy: signed integer
samples are scaled by 2^(bits-1) (1/32768 for int16), channels are summed
in float32 and scaled by 1/channels, and a file at another rate is
resampled as that reader resamples: output sample i reads the float64
position i * (file_sr / sr) by linear interpolation, clamped at the last
sample, and there are floor(n_in * sr / file_sr) of them.
"""

from __future__ import annotations

import os

import numpy as np

SR = 24000


def resample_linear(data: np.ndarray, file_sr: int, sr: int = SR) -> np.ndarray:
    """Linear resampling of a mono float32 wave, as the native reader does
    it (the module docstring)."""
    n_in = len(data)
    n_out = int(n_in * sr / file_sr)
    pos = np.arange(n_out, dtype=np.float64) * (file_sr / sr)
    j = pos.astype(np.int64)
    frac = pos - j
    a = data[np.minimum(j, n_in - 1)].astype(np.float64)
    b = data[np.minimum(j + 1, n_in - 1)].astype(np.float64)
    return (a * (1.0 - frac) + b * frac).astype(np.float32)


def load_wav(path: str, sr: int = SR) -> np.ndarray:
    """Mono float32 wave (T,) at `sr`."""
    from scipy.io import wavfile

    file_sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.float32(-np.iinfo(data.dtype).min)
    elif data.dtype.kind == "u":
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        acc = data[:, 0].copy()
        for c in range(1, data.shape[1]):
            acc += data[:, c]
        data = acc * np.float32(1.0 / data.shape[1])
    if file_sr != sr:
        data = resample_linear(data, file_sr, sr)
    return data


def save_wav(path: str, wave: np.ndarray, sr: int = SR) -> None:
    """Write the first row of `wave` ((T,) or (B, T), clipped to [-1, 1]) as
    16-bit PCM."""
    from scipy.io import wavfile

    wave = np.asarray(wave)
    if wave.ndim == 2:
        wave = wave[0]
    wave = np.clip(wave, -1.0, 1.0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sr, (wave * 32767.0).astype(np.int16))
