"""Wav files in and out: mono float32 at the codec's rate.

Port of facodec_tpu/cli/_io.py `save_wav` and the scipy route of
facodec_tpu/train/data.py `load_wav`, with one difference: signed integer
samples are scaled by 2^(bits-1) (1/32768 for int16), as the JAX package's
native reader does (facodec_tpu/native/wav_io.cpp), the route its CLI takes
wherever that library builds; its scipy route divides by 32767. Channels
are averaged to mono. A file at another rate is resampled by linear
interpolation, as the scipy route does; the native reader's resampler is
not copied.
"""

from __future__ import annotations

import os

import numpy as np

SR = 24000


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
        data = data.mean(axis=1)
    if file_sr != sr:
        t = np.linspace(0.0, len(data) / file_sr, int(len(data) * sr / file_sr), endpoint=False)
        src_t = np.arange(len(data)) / file_sr
        data = np.interp(t, src_t, data).astype(np.float32)
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
