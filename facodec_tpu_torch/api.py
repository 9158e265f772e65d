"""High-level API: encode / decode / reconstruct / timbre_of.

Port of facodec_tpu/api.py `FACodec`, one-shot and float32. Waves go in and
come out as numpy arrays (24 kHz, (T,) or (B, T)); codes come back in a
`CodecCodes`, which carries the field names of facodec_tpu/codec_file.py
`FACodecFile` (reading and writing `.fac` files is not ported yet).

Every call runs with TF32 off for cuDNN convolutions and cuBLAS matmuls,
scoped to the call: cuDNN convolutions default to TF32 on Hopper, and the
codes of a float32 codec must not depend on it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch

from facodec_tpu_torch.models.builder import build_from_fields
from facodec_tpu_torch.utils.weights import init_random_

SR = 24000
HOP = 300


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """Turn TF32 off for cuDNN and cuBLAS inside the block, then restore."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


@dataclass
class CodecCodes:
    """The encoded form of a batch of waves (FACodecFile's fields)."""

    codes_p: np.ndarray  # (B, n_p, T) uint16
    codes_c: np.ndarray  # (B, n_c, T) uint16
    codes_r: Optional[np.ndarray]  # (B, n_r, T) uint16 or None
    timbre: np.ndarray  # (B, d) float32
    sample_rate: int = SR
    hop_length: int = HOP
    original_length: int = 0  # samples, for exact truncation on decode


class FACodec:
    """The codec: encoder + factorized quantizer + decoder, in eval mode."""

    def __init__(self, encoder: torch.nn.Module, quantizer: torch.nn.Module,
                 decoder: torch.nn.Module, n_c: int = 2):
        self.encoder = encoder.eval()
        self.quantizer = quantizer.eval()
        self.decoder = decoder.eval()
        self.n_c = n_c

    @classmethod
    def from_fields(cls, fields: Mapping[str, Mapping[str, Any]], seed: int = 0,
                    device: str = "cuda", n_c: int = 2) -> "FACodec":
        """Build from module fields (e.g. `config.FLAGSHIP`) with seeded
        random weights, on the card unless `device="cpu"` is asked for; the
        weights are drawn on the CPU, so one seed gives the same model on
        every device."""
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"FACodec.from_fields: device {device!r} asked for, but torch "
                               f"sees no CUDA device; pass device='cpu' to run on the CPU")
        models = build_from_fields(fields)
        gen = torch.Generator().manual_seed(seed)
        names = ("encoder", "quantizer", "decoder")
        for name in names:
            init_random_(models[name], gen)
        return cls(*(models[k].to(device) for k in names), n_c=n_c)

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device

    # ------------------------------------------------------------- tensors
    @torch.no_grad()
    def encode_tensor(self, wave: torch.Tensor):
        """wave (B, T) on the device -> (outs, [codes_p, codes_c, codes_r], timbre)."""
        with float32_exact():
            z = self.encoder(wave[:, :, None])
            return self.quantizer.forward_v2(z, wave, n_c=self.n_c)

    @torch.no_grad()
    def decode_tensor(self, codes_p, codes_c, codes_r, timbre) -> torch.Tensor:
        """Code streams (B, n, T) + timbre (B, d) -> wave (B, T)."""
        with float32_exact():
            outs = self.quantizer.decode_from_codes_v2(codes_p, codes_c, codes_r, timbre)
            return self.decoder(outs)[:, :, 0]

    @torch.no_grad()
    def decode_latent(self, outs: torch.Tensor) -> torch.Tensor:
        """Decoder-ready latent (B, T', d) -> wave (B, T)."""
        with float32_exact():
            return self.decoder(outs)[:, :, 0]

    # --------------------------------------------------------------- numpy
    def _prep(self, wave: np.ndarray) -> torch.Tensor:
        wave = np.asarray(wave, np.float32)
        if wave.ndim == 1:
            wave = wave[None]
        T = wave.shape[-1] // HOP * HOP
        return torch.from_numpy(np.ascontiguousarray(wave[:, :T])).to(self.device)

    def encode(self, wave: np.ndarray) -> CodecCodes:
        """wave (T,) or (B, T) float 24 kHz -> CodecCodes."""
        w = self._prep(wave)
        _, codes, timbre = self.encode_tensor(w)
        codes_p, codes_c, codes_r = (c.cpu().numpy().astype(np.uint16) for c in codes)
        return CodecCodes(codes_p=codes_p, codes_c=codes_c, codes_r=codes_r,
                          timbre=timbre.cpu().numpy(), sample_rate=SR, hop_length=HOP,
                          original_length=int(w.shape[-1]))

    def decode(self, f: CodecCodes) -> np.ndarray:
        """CodecCodes (its codes and timbre) -> wave (B, T) float numpy;
        without residual codes the residual stream is dropped."""
        dev = self.device

        def codes(a):
            return torch.from_numpy(a.astype(np.int32)).to(dev)

        cr = codes(f.codes_r) if f.codes_r is not None else None
        wave = self.decode_tensor(codes(f.codes_p), codes(f.codes_c), cr,
                                  torch.from_numpy(np.asarray(f.timbre, np.float32)).to(dev))
        out = wave.cpu().numpy()
        if f.original_length:
            out = out[:, : f.original_length]
        return out

    def reconstruct(self, wave: np.ndarray) -> np.ndarray:
        """Round trip through the quantized latent."""
        outs, _, _ = self.encode_tensor(self._prep(wave))
        return self.decode_latent(outs).cpu().numpy()

    def timbre_of(self, wave: np.ndarray) -> np.ndarray:
        """Global timbre vector of each utterance, (B, d)."""
        _, _, timbre = self.encode_tensor(self._prep(wave))
        return timbre.cpu().numpy()
