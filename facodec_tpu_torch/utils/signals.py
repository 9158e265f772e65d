"""Deterministic test signals for the port's checks."""

from __future__ import annotations

import numpy as np


def sweep_wave(batch: int, seconds: float, seed: int = 0, sr: int = 24000) -> np.ndarray:
    """(batch, sr * seconds) float32: a 100-1600 Hz sine sweep plus seeded noise."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    sweep = 0.4 * np.sin(2 * np.pi * (100.0 + 1500.0 * t / seconds) * t)
    return (sweep[None] + 0.05 * rng.standard_normal((batch, n))).astype(np.float32)
