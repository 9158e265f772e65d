"""The `.fac` code file: factorized code streams, the timbre vector, metadata.

A copy of facodec_tpu/codec_file.py (the port imports nothing of
`facodec_tpu`), with the same magic, version and `np.savez` layout, so that
files move both ways between the two packages. The prosody, content and
residual streams are stored apart, so that a consumer can drop streams (the
residual, for voice conversion), beside the continuous timbre vector.

At the flagship configuration: 6 codebooks x 10 bit x 80 frames/s = 4.8
kbps, plus one 1024-d timbre vector per utterance.
"""

from __future__ import annotations

import ast
import io
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

MAGIC = "facodec-tpu"
VERSION = 1


@dataclass
class FACodecFile:
    codes_p: np.ndarray  # (B, n_p, T) uint16
    codes_c: np.ndarray  # (B, n_c, T) uint16
    codes_r: Optional[np.ndarray]  # (B, n_r, T) uint16 or None
    timbre: np.ndarray  # (B, d) float32
    sample_rate: int = 24000
    hop_length: int = 300
    original_length: int = 0  # samples, for exact truncation on decode
    metadata: Dict = field(default_factory=dict)

    def _write(self, f) -> None:
        arrays = dict(
            codes_p=self.codes_p.astype(np.uint16),
            codes_c=self.codes_c.astype(np.uint16),
            timbre=self.timbre.astype(np.float32),
        )
        if self.codes_r is not None:
            arrays["codes_r"] = self.codes_r.astype(np.uint16)
        header = dict(
            magic=MAGIC, version=VERSION, sample_rate=self.sample_rate,
            hop_length=self.hop_length, original_length=self.original_length,
            **self.metadata,
        )
        np.savez(f, __header__=np.asarray([repr(header)]), **arrays)

    def save(self, path: str) -> str:
        if not path.endswith(".fac"):
            path = path + ".fac"
        with open(path, "wb") as f:
            self._write(f)
        return path

    def to_bytes(self) -> bytes:
        """In-memory serialization."""
        buf = io.BytesIO()
        self._write(buf)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "FACodecFile":
        return cls.load(io.BytesIO(blob))

    @classmethod
    def load(cls, path) -> "FACodecFile":
        data = np.load(path, allow_pickle=False)
        header = ast.literal_eval(str(data["__header__"][0]))
        if header.pop("magic", None) != MAGIC:
            raise ValueError(f"{path} is not a facodec-tpu code file")
        header.pop("version", None)
        f = cls(
            codes_p=data["codes_p"],
            codes_c=data["codes_c"],
            codes_r=data["codes_r"] if "codes_r" in data else None,
            timbre=data["timbre"],
            sample_rate=int(header.pop("sample_rate")),
            hop_length=int(header.pop("hop_length")),
            original_length=int(header.pop("original_length")),
            metadata=header,
        )
        f.validate()
        return f

    def validate(self) -> None:
        """Structural checks, so that a malformed file fails here with a
        clear message rather than inside the model."""
        streams = [("codes_p", self.codes_p), ("codes_c", self.codes_c)]
        if self.codes_r is not None:
            streams.append(("codes_r", self.codes_r))
        B, T = self.codes_p.shape[0], self.codes_p.shape[-1]
        for name, c in streams:
            if c.ndim != 3:
                raise ValueError(f"{name}: expected (B, n_codebooks, T), "
                                 f"got shape {c.shape}")
            if c.shape[0] != B or c.shape[-1] != T:
                raise ValueError(f"{name}: batch/frames {c.shape} disagree "
                                 f"with codes_p {self.codes_p.shape}")
            if not np.issubdtype(c.dtype, np.integer):
                raise ValueError(f"{name}: codes must be integers, "
                                 f"got {c.dtype}")
        if self.timbre.ndim != 2 or self.timbre.shape[0] != B:
            raise ValueError(f"timbre: expected (B={B}, d), "
                             f"got shape {self.timbre.shape}")
        if self.original_length < 0 or T < 1 or B < 1:
            raise ValueError("non-positive batch/frames/original_length")
