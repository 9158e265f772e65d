"""High-level API: the codec and voice conversion.

Port of facodec_tpu/api.py, one-shot and float32:
- `FACodec`: encode / decode / decode_subset / reconstruct / timbre_of.
  Codes come back in a `FACodecFile` (codec_file.py), which reads and
  writes `.fac` files that the JAX package reads too.
- `FARedecoder`: resynthesis of source codes in a target timbre.
- `convert_voice`: zero-shot voice conversion with both.

Waves go in and come out as numpy arrays (24 kHz, (T,) or (B, T)). Every
entry point builds on the card unless the caller asks for the CPU, and
raises where torch sees no CUDA device. Weights are seeded random, or read
from a torch checkpoint by `from_config`.

Every call runs with TF32 off for cuDNN convolutions and cuBLAS matmuls,
scoped to the call: cuDNN convolutions default to TF32 on Hopper, and the
codes of a float32 codec must not depend on it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from facodec_tpu_torch.codec_file import FACodecFile
from facodec_tpu_torch.models.builder import (
    build_from_fields, build_redecoder_from_fields, codec_fields, redecoder_fields,
)
from facodec_tpu_torch.utils.config import load_config
from facodec_tpu_torch.utils.weights import init_random_, load_torch_checkpoint

SR = 24000
HOP = 300
CODEC_MODULES = ("encoder", "quantizer", "decoder")
REDECODER_MODULES = ("encoder", "decoder")


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


def _build(who: str, build: Callable[[Mapping], Dict[str, nn.Module]],
           fields: Mapping[str, Mapping[str, Any]], names, seed: int, device: str,
           ckpt_path: Optional[str] = None) -> List[nn.Module]:
    """The modules `names` of `build(fields)` on `device`: seeded random
    weights, drawn on the CPU so one seed gives the same model on every
    device, then the checkpoint's where one is given."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device {device!r} asked for, but torch sees no CUDA "
                           f"device; pass device='cpu' (--device cpu) to run on the CPU")
    models = build(fields)
    gen = torch.Generator().manual_seed(seed)
    for name in names:
        init_random_(models[name], gen)
    if ckpt_path:
        load_torch_checkpoint({name: models[name] for name in names}, ckpt_path)
    return [models[name].to(device) for name in names]


def _codes(a: np.ndarray, n_codes: int, device: torch.device) -> torch.Tensor:
    """Integer codes (from a file) as an int64 tensor on `device`, checked
    against the codebook size on the host first."""
    a = np.asarray(a)
    if a.size and (int(a.min()) < 0 or int(a.max()) >= n_codes):
        raise ValueError(f"codes out of range [0, {n_codes}): min {a.min()} max {a.max()}")
    return torch.from_numpy(a.astype(np.int64)).to(device)


def _timbre(t: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(t, np.float32)).to(device)


class FACodec:
    """The codec: encoder + factorized quantizer + decoder, in eval mode."""

    def __init__(self, encoder: nn.Module, quantizer: nn.Module, decoder: nn.Module,
                 n_c: int = 2):
        self.encoder = encoder.eval()
        self.quantizer = quantizer.eval()
        self.decoder = decoder.eval()
        self.n_c = n_c

    @classmethod
    def from_fields(cls, fields: Mapping[str, Mapping[str, Any]], seed: int = 0,
                    device: str = "cuda", n_c: int = 2,
                    ckpt_path: Optional[str] = None) -> "FACodec":
        """Build from module fields (e.g. `config.FLAGSHIP`) with seeded
        random weights, or a torch checkpoint's, on the card unless
        `device="cpu"` is asked for."""
        return cls(*_build("FACodec", build_from_fields, fields, CODEC_MODULES, seed, device,
                           ckpt_path), n_c=n_c)

    @classmethod
    def from_config(cls, config_path: str, ckpt_path: Optional[str] = None, seed: int = 0,
                    n_c: int = 2, device: str = "cuda") -> "FACodec":
        """Build from a reference-schema config.yml (needs pyyaml) and, if
        given, a torch checkpoint holding `encoder`, `quantizer`, `decoder`."""
        fields = codec_fields(load_config(config_path).model_params)
        return cls.from_fields(fields, seed=seed, device=device, n_c=n_c, ckpt_path=ckpt_path)

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
    def decode_tensor(self, codes_p, codes_c, codes_r, timbre, use_p: bool = True,
                      use_c: bool = True, use_r: bool = True) -> torch.Tensor:
        """Code streams (B, n, T) + timbre (B, d) -> wave (B, T), from the
        selected streams."""
        with float32_exact():
            outs = self.quantizer.decode_streams_v2(codes_p, codes_c, codes_r, timbre,
                                                    use_p, use_c, use_r)
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

    def encode(self, wave: np.ndarray) -> FACodecFile:
        """wave (T,) or (B, T) float 24 kHz -> FACodecFile."""
        w = self._prep(wave)
        _, codes, timbre = self.encode_tensor(w)
        codes_p, codes_c, codes_r = (c.cpu().numpy().astype(np.uint16) for c in codes)
        return FACodecFile(codes_p=codes_p, codes_c=codes_c, codes_r=codes_r,
                           timbre=timbre.cpu().numpy(), sample_rate=SR, hop_length=HOP,
                           original_length=int(w.shape[-1]))

    def decode(self, f: FACodecFile, use_residual: bool = True) -> np.ndarray:
        """FACodecFile -> wave (B, T) float numpy; without residual codes,
        or with use_residual=False, the residual stream is dropped."""
        return self.decode_subset(f, use_residual=use_residual)

    def decode_subset(self, f: FACodecFile, use_prosody: bool = True,
                      use_content: bool = True, use_residual: bool = True) -> np.ndarray:
        """Decode a non-empty subset of the streams (the factorization
        probe): a prosody-only decode carries the F0 contour but no
        phonetic content where the factorization holds."""
        dev = self.device
        n_codes = self.quantizer.codebook_size
        cr = _codes(f.codes_r, n_codes, dev) if f.codes_r is not None else None
        wave = self.decode_tensor(_codes(f.codes_p, n_codes, dev),
                                  _codes(f.codes_c, n_codes, dev), cr, _timbre(f.timbre, dev),
                                  use_prosody, use_content, use_residual)
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


class FARedecoder:
    """The voice-conversion model: the Redecoder and its DAC decoder, in
    eval mode."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        self.encoder = encoder.eval()
        self.decoder = decoder.eval()

    @classmethod
    def from_fields(cls, fields: Mapping[str, Mapping[str, Any]], seed: int = 0,
                    device: str = "cuda", ckpt_path: Optional[str] = None) -> "FARedecoder":
        """Build from module fields (e.g. `config.FLAGSHIP_REDECODER`) with
        seeded random weights, or a torch checkpoint's, on the card unless
        `device="cpu"` is asked for."""
        return cls(*_build("FARedecoder", build_redecoder_from_fields, fields,
                           REDECODER_MODULES, seed, device, ckpt_path))

    @classmethod
    def from_config(cls, config_path: str, ckpt_path: Optional[str] = None, seed: int = 0,
                    device: str = "cuda") -> "FARedecoder":
        """Build from a reference-schema config_redecoder.yml (needs pyyaml)
        and, if given, a torch checkpoint holding `encoder`, `decoder`."""
        fields = redecoder_fields(load_config(config_path).model_params)
        return cls.from_fields(fields, seed=seed, device=device, ckpt_path=ckpt_path)

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device

    @torch.no_grad()
    def resynthesize(self, codes: FACodecFile, target_timbre: np.ndarray,
                     use_p_code: bool = False, n_c: int = 1) -> np.ndarray:
        """Source codes (their prosody and first n_c content streams) + a
        target timbre (B, d) -> wave (B, T) float numpy."""
        dev = self.device
        n_codes = self.encoder.codebook_size
        with float32_exact():
            z = self.encoder(_codes(codes.codes_p, n_codes, dev),
                             _codes(codes.codes_c, n_codes, dev), _timbre(target_timbre, dev),
                             use_p_code=use_p_code, n_c=n_c)
            wave = self.decoder(z)[:, :, 0]
        out = wave.cpu().numpy()
        if codes.original_length:
            out = out[:, : codes.original_length]
        return out


def convert_voice(codec: FACodec, redecoder: FARedecoder, source_wave: np.ndarray,
                  target_wave: np.ndarray) -> np.ndarray:
    """Zero-shot voice conversion: the source's content in the target's
    timbre (the prosody codes are not fed, as in the reference). Build the
    codec with n_c=1: the redecoder reads one content stream."""
    codes = codec.encode(source_wave)
    timbre = codec.timbre_of(target_wave)
    return redecoder.resynthesize(codes, timbre, use_p_code=False, n_c=1)
