"""Wav files in and out: mono float32 at the codec's rate.

Port of facodec_tpu/cli/_io.py `save_wav` and of facodec_tpu/train/data.py
`load_wav`, in numpy. The JAX reader takes one of two routes by the file's
sample width (bits per sample in its `fmt ` chunk), and so does this one:

- 16-, 24- and 32-bit samples (int16, 24-bit and int32 PCM, float32): the
  native library's arithmetic (facodec_tpu/native/wav_io.cpp). Signed
  integer samples are scaled by 2^(bits-1) (1/32768 for int16), channels
  are summed in float32 and scaled by 1/channels, and a file at another
  rate is resampled as that reader resamples: output sample i reads the
  float64 position i * (file_sr / sr) by linear interpolation, clamped at
  the last sample, and there are floor(n_in * sr / file_sr) of them.
- every other width, which the native reader refuses (8-bit unsigned PCM,
  64-bit float, 64-bit PCM, ...): the JAX reader's scipy fallback. Signed
  integers are divided by their dtype's maximum (32767 for int16), uint8
  maps to (x - 128) / 128, channels are mixed with `mean(axis=1)`, and
  another rate is resampled with `np.linspace` output times and
  `np.interp`.
"""

from __future__ import annotations

import os
import struct

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


NATIVE_BITS = (16, 24, 32)


def wav_bits(path: str) -> int:
    """Bits per sample of a RIFF/WAVE file's `fmt ` chunk, or 0 where the
    header does not parse up to its `data` chunk (as the native reader walks
    it)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            return 0
        bits = 0
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                return 0
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if cid == b"fmt ":
                if size < 16:
                    return 0
                body = f.read(size)
                if len(body) < size:
                    return 0
                bits = struct.unpack("<H", body[14:16])[0]
            elif cid == b"data":
                return bits
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)


def _load_fallback(file_sr: int, data: np.ndarray, sr: int) -> np.ndarray:
    """The JAX reader's scipy route (facodec_tpu/train/data.py `load_wav`)."""
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
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


def load_wav(path: str, sr: int = SR) -> np.ndarray:
    """Mono float32 wave (T,) at `sr`, by the route of the file's sample
    width (the module docstring)."""
    from scipy.io import wavfile

    file_sr, data = wavfile.read(path)
    if wav_bits(path) not in NATIVE_BITS:
        return _load_fallback(file_sr, data, sr)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.float32(-np.iinfo(data.dtype).min)
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
