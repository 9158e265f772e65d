"""High-level API: the codec and voice conversion.

Port of facodec_tpu/api.py:
- `FACodec`: encode / decode / decode_subset / reconstruct / timbre_of,
  the bounded-memory `encode_streaming` / `decode_streaming` for long
  inputs (the exact chunked session of models/streaming.py), and `latency`.
  Codes come back in a `FACodecFile` (codec_file.py), which reads and
  writes `.fac` files that the JAX package reads too.
- `FARedecoder`: resynthesis of source codes in a target timbre, one-shot
  or streamed (`resynthesize_streaming`, causal models).
- `shard_inference(devices)` on both: batch-parallel one-shot calls, one
  replica per device, each in its own worker thread (`Replicas`).
- `convert_voice`: zero-shot voice conversion with both.

Waves go in and come out as numpy arrays (24 kHz, (T,) or (B, T)). Every
entry point builds on the card unless the caller asks for the CPU, and
raises where torch sees no CUDA device. Weights are seeded random, or read
from a torch checkpoint by `from_config`.

Every call runs with TF32 off for cuDNN convolutions and cuBLAS matmuls,
scoped to the call: cuDNN convolutions default to TF32 on Hopper, and the
codes of a float32 codec must not depend on it. The one-shot calls mark
their parts "encode", "quantize" and "decode" for a trace
(utils/profiling.py).

`FACodec(precision=)` takes the policies of ops/precision.py, aliases
included: "float32" (the default); "hybrid", which encodes in float32
(codes exact) and decodes under `bfloat16_act` (bf16 activations; decoded
waves come back as float32 numpy), as the JAX package's "hybrid" does;
"hybrid_int8", a float32 encode and an `int8` decode (W8A8 wide convs, one
shot only: the activation scales pool over whole batch rows); and
"bfloat16", "bfloat16_act" and "int8", which run both halves under the
policy. The streaming methods and sessions stay float32 under every
policy, as the JAX package's do. `FARedecoder` is float32.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from facodec_tpu_torch.codec_file import FACodecFile
from facodec_tpu_torch.models.builder import (
    build_from_fields, build_redecoder_from_fields, codec_fields, redecoder_fields,
)
from facodec_tpu_torch.ops.precision import check as check_policy
from facodec_tpu_torch.ops.precision import entry_policies, get_policy, policy
from facodec_tpu_torch.parallel.mesh import make_devices
from facodec_tpu_torch.utils.config import load_config
from facodec_tpu_torch.utils.profiling import annotate
from facodec_tpu_torch.utils.weights import init_random_, load_torch_checkpoint

SR = 24000
HOP = 300
CODEC_MODULES = ("encoder", "quantizer", "decoder")
REDECODER_MODULES = ("encoder", "decoder")


_EXACT_LOCK = threading.Lock()
_EXACT: Dict[str, Any] = {"holders": 0, "saved": None}


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """Turn TF32 off for cuDNN and cuBLAS inside the block, and cuBLAS's
    bf16 reductions in bf16 (its bf16 GEMMs then sum in float32, as the
    bfloat16_act policy asks), then restore. The flags are process-wide,
    so the block is counted under a lock: the first to enter saves and
    clears them, the last to leave restores them, and threads that enter
    and leave interleaved (sharded replicas) never turn TF32 back on under
    one another."""
    flags = torch.backends.cuda.matmul
    with _EXACT_LOCK:
        if _EXACT["holders"] == 0:
            _EXACT["saved"] = (torch.backends.cudnn.allow_tf32, flags.allow_tf32,
                               flags.allow_bf16_reduced_precision_reduction)
            torch.backends.cudnn.allow_tf32 = False
            flags.allow_tf32 = False
            flags.allow_bf16_reduced_precision_reduction = False
        _EXACT["holders"] += 1
    try:
        yield
    finally:
        with _EXACT_LOCK:
            _EXACT["holders"] -= 1
            if _EXACT["holders"] == 0:
                (torch.backends.cudnn.allow_tf32, flags.allow_tf32,
                 flags.allow_bf16_reduced_precision_reduction) = _EXACT["saved"]


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


def _replicate(module: nn.Module, device: torch.device) -> nn.Module:
    """A copy of `module` on `device`, without the source's kept packed
    operands (ResidualUnit's pack, SLSTM's rounded LSTM and int8 weights):
    each replica makes its own on its device."""
    copy = deepcopy(module).to(device)
    for m in copy.modules():
        if hasattr(m, "_packs"):
            m._packs = {}
        if hasattr(m, "_bf16_cache"):
            m._bf16_cache, m._int8_cache = {}, {}
    return copy


def _tensor_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensor_leaves(x)]
    return []


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, x) for x in tree)
    return tree


def _zip_tensors(fn, trees):
    """fn(list of the trees' leaves at one place) over trees of one structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(list(trees))
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_tensors(fn, list(parts)) for parts in zip(*trees))
    return first


class Replicas:
    """Batch-parallel inference (port of the JAX package's
    `shard_inference`, whose SPMD program shards the batch over a data
    axis): one unsharded replica of a model per device, each in its own
    worker thread (on its own CUDA stream). `run(name, kwargs)`, the
    method's arguments by name, pads the batch of every tensor argument
    with zero rows to a multiple of the replica count (`wave_lens` with
    full-length rows, so a padded row's timbre pools a whole row of
    zeros), splits the rows in order, runs
    `getattr(replica, name)` on each part concurrently, gathers the results
    in row order on `home` and trims them to the batch. The caller's
    precision policy is entered in each worker, and `float32_exact` once
    around the whole call. A failure in any replica raises in the caller."""

    def __init__(self, replicas: List[Any], devices: List[torch.device], home: torch.device):
        self.replicas, self.devices, self.home = replicas, devices, home
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]
        self.pool = ThreadPoolExecutor(len(devices), thread_name_prefix="facodec-replica")

    def __len__(self) -> int:
        return len(self.replicas)

    def _part(self, i: int, name: str, kwargs, name_policy: str, waits):
        dev, stream = self.devices[i], self.streams[i]
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(policy(name_policy))
            if stream is not None:
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(stream))
                if waits is not None:
                    stream.wait_stream(waits)  # the caller's inputs are ready
            kwargs = _map_tensors(lambda t: t.to(dev), kwargs)
            out = getattr(self.replicas[i], name)(**kwargs)
            out = _map_tensors(lambda t: t.to(self.home), out)
            if stream is not None:
                stream.synchronize()
            return out

    def run(self, name: str, kwargs: dict):
        leaves = _tensor_leaves(kwargs)
        if not leaves:
            raise ValueError(f"{name}: a sharded call needs a batch tensor")
        B = leaves[0].shape[0]
        n = len(self.replicas)
        per = -(-B // n)
        T = leaves[0].shape[-1]

        def pad(t: torch.Tensor, fill=0) -> torch.Tensor:
            extra = per * n - t.shape[0]
            if extra == 0:
                return t
            return torch.cat([t, t.new_full((extra, *t.shape[1:]), fill)])

        kwargs = {k: (pad(v, T) if k == "wave_lens" and v is not None else _map_tensors(pad, v))
                  for k, v in kwargs.items()}
        waits = torch.cuda.current_stream(self.home) if self.home.type == "cuda" else None
        parts = [_map_tensors(lambda t: t[i * per:(i + 1) * per], kwargs) for i in range(n)]
        with float32_exact():
            futures = [self.pool.submit(self._part, i, name, k, get_policy(), waits)
                       for i, k in enumerate(parts)]
            outs = [f.result() for f in futures]
        return _zip_tensors(lambda ts: torch.cat(ts)[:B], outs)

    def close(self) -> None:
        self.pool.shutdown()


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    out = [torch.device(d) for d in (make_devices() if devices is None else devices)]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]


def _sharded(method):
    """The method on every replica's rows where `shard_inference` is on; its
    arguments go to `Replicas.run` by name, however the caller passed them."""
    signature = inspect.signature(method)

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        if self.replicas is None:
            return method(self, *args, **kwargs)
        named = signature.bind(self, *args, **kwargs).arguments
        named.pop("self")
        return self.replicas.run(method.__name__, dict(named))

    return call


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
                 n_c: int = 2, precision: str = "float32"):
        self.encoder = encoder.eval()
        self.quantizer = quantizer.eval()
        self.decoder = decoder.eval()
        self.n_c = n_c
        self.precision = check_policy(precision)
        self.enc_policy, self.dec_policy = entry_policies(self.precision)
        self.replicas: Optional[Replicas] = None

    def shard_inference(self, devices: Optional[Sequence] = None) -> "FACodec":
        """Batch-parallel inference over `devices` (default every visible
        GPU; a device may repeat, e.g. two replicas on cuda:0): one replica
        of the modules per device (the first device's shares this codec's
        modules where it is theirs), and every one-shot entry point
        (`encode`, `decode`, `decode_subset`, `reconstruct`, `timbre_of`
        and the `*_tensor` forms) splits its batch over them (`Replicas`).
        The streaming methods stay on this codec's device, as the JAX
        package's do. Returns self."""
        devices = _devices(devices)
        replicas = [FACodec(*(m if d == self.device and i == 0 else _replicate(m, d)
                              for m in (self.encoder, self.quantizer, self.decoder)),
                            n_c=self.n_c, precision=self.precision)
                    for i, d in enumerate(devices)]
        if self.replicas is not None:
            self.replicas.close()
        self.replicas = Replicas(replicas, devices, self.device)
        return self

    @classmethod
    def from_fields(cls, fields: Mapping[str, Mapping[str, Any]], seed: int = 0,
                    device: str = "cuda", n_c: int = 2, ckpt_path: Optional[str] = None,
                    precision: str = "float32") -> "FACodec":
        """Build from module fields (e.g. `config.FLAGSHIP`) with seeded
        random weights, or a torch checkpoint's, on the card unless
        `device="cpu"` is asked for."""
        check_policy(precision)
        return cls(*_build("FACodec", build_from_fields, fields, CODEC_MODULES, seed, device,
                           ckpt_path), n_c=n_c, precision=precision)

    @classmethod
    def from_config(cls, config_path: str, ckpt_path: Optional[str] = None, seed: int = 0,
                    n_c: int = 2, device: str = "cuda", precision: str = "float32") -> "FACodec":
        """Build from a reference-schema config.yml (needs pyyaml) and, if
        given, a torch checkpoint holding `encoder`, `quantizer`, `decoder`."""
        fields = codec_fields(load_config(config_path).model_params)
        return cls.from_fields(fields, seed=seed, device=device, n_c=n_c, ckpt_path=ckpt_path,
                               precision=precision)

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device

    # ------------------------------------------------------------- tensors
    @_sharded
    @torch.no_grad()
    def encode_tensor(self, wave: torch.Tensor, wave_lens: Optional[torch.Tensor] = None):
        """wave (B, T) on the device -> (outs, [codes_p, codes_c, codes_r],
        timbre). Given the rows' true lengths `wave_lens` (B,) in samples,
        the timbre pools each row's first wave_lens // 300 frames only (a
        batch zero-padded to a length bucket)."""
        with float32_exact(), policy(self.enc_policy):
            with annotate("encode"):
                z = self.encoder(wave[:, :, None])
            with annotate("quantize"):
                if wave_lens is None:
                    return self.quantizer.forward_v2(z, wave, n_c=self.n_c)
                return self.quantizer.forward_v2(z, wave, n_c=self.n_c, full_waves=wave,
                                                 wave_lens=wave_lens)

    @_sharded
    @torch.no_grad()
    def decode_tensor(self, codes_p, codes_c, codes_r, timbre, use_p: bool = True,
                      use_c: bool = True, use_r: bool = True) -> torch.Tensor:
        """Code streams (B, n, T) + timbre (B, d) -> float32 wave (B, T),
        from the selected streams."""
        with float32_exact(), policy(self.dec_policy), annotate("decode"):
            outs = self.quantizer.decode_streams_v2(codes_p, codes_c, codes_r, timbre,
                                                    use_p, use_c, use_r)
            return self.decoder(outs)[:, :, 0].float()

    @_sharded
    @torch.no_grad()
    def decode_latent(self, outs: torch.Tensor) -> torch.Tensor:
        """Decoder-ready latent (B, T', d) -> float32 wave (B, T)."""
        with float32_exact(), policy(self.dec_policy), annotate("decode"):
            return self.decoder(outs)[:, :, 0].float()

    @_sharded
    @torch.no_grad()
    def reconstruct_tensor(self, wave: torch.Tensor,
                           wave_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """wave (B, T) on the device -> the round trip's float32 wave
        (B, T), through the quantized latent (`wave_lens` as in
        `encode_tensor`)."""
        outs, _, _ = self.encode_tensor(wave, wave_lens)
        return self.decode_latent(outs)

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

    def encode_streaming(self, wave: np.ndarray, chunk_frames: int = 80,
                         timbre_seconds: float = 10.0) -> FACodecFile:
        """Bounded-memory encode for inputs of any length: the exact
        streaming session, chunk by chunk (codes equal the one-shot
        encoder's). The timbre, a global vector of the utterance, is taken
        from the first `timbre_seconds`: timbre is speaker-stationary, and
        the style encoder's attention is quadratic in frames. An input too
        short to prime the session, or shorter than two chunks, is encoded
        one-shot, as the JAX package does."""
        from facodec_tpu_torch.models.streaming import StreamingFACodec

        w = self._prep(wave)
        B, T = w.shape
        n_frames = T // HOP
        sess = StreamingFACodec(self.encoder, self.quantizer, self.decoder,
                                chunk_frames=chunk_frames, n_c=self.n_c)
        if n_frames < max(2 * chunk_frames, sess.prime_frames + 1):
            return self.encode(wave)
        twin = min(T, max(HOP, int(timbre_seconds * SR) // HOP * HOP))
        _, _, timbre = self.encode_tensor(w[:, :twin])
        est = sess.init_encode_state(B)
        step = chunk_frames * HOP
        parts = []
        for i in range(0, T, step):
            est, _, codes = sess.encode_chunk(est, w[:, i : i + step], timbre)
            if codes is not None:
                parts.append(codes)
        parts.append(sess.flush_encode(est, timbre)[1])
        cp, cc, cr = (torch.cat([p[j] for p in parts], dim=-1).cpu().numpy().astype(np.uint16)
                      for j in range(3))
        return FACodecFile(codes_p=cp, codes_c=cc, codes_r=cr, timbre=timbre.cpu().numpy(),
                           sample_rate=SR, hop_length=HOP, original_length=int(T))

    @torch.no_grad()
    def decode_streaming(self, f: FACodecFile, use_residual: bool = True,
                         chunk_frames: int = 80) -> np.ndarray:
        """Bounded-memory decode: the frame-local code decode and the
        streaming decoder, chunk by chunk (equal to `decode`)."""
        from facodec_tpu_torch.models.dac import decoder_stream_state
        from facodec_tpu_torch.models.streaming import min_first_frames_decoder

        need = min_first_frames_decoder(self.decoder.rates)
        if chunk_frames < need:
            raise ValueError(f"decode_streaming: chunk_frames must be >= {need}, "
                             f"got {chunk_frames}")
        dev = self.device
        n_codes = self.quantizer.codebook_size
        cp, cc = _codes(f.codes_p, n_codes, dev), _codes(f.codes_c, n_codes, dev)
        cr = (_codes(f.codes_r, n_codes, dev)
              if use_residual and f.codes_r is not None else None)
        timbre = _timbre(f.timbre, dev)
        state = decoder_stream_state(self.decoder, cp.shape[0])
        parts = []
        with float32_exact():
            for i in range(0, cp.shape[-1], chunk_frames):
                sl = slice(i, i + chunk_frames)
                outs = self.quantizer.decode_streams_v2(
                    cp[..., sl], cc[..., sl], None if cr is None else cr[..., sl], timbre)
                wave, state = self.decoder(outs, state, i == 0)
                parts.append(wave[:, :, 0].cpu().numpy())
        out = np.concatenate(parts, axis=1)
        if f.original_length:
            out = out[:, : f.original_length]
        return out

    def reconstruct(self, wave: np.ndarray) -> np.ndarray:
        """Round trip through the quantized latent."""
        return self.reconstruct_tensor(self._prep(wave)).cpu().numpy()

    def timbre_of(self, wave: np.ndarray) -> np.ndarray:
        """Global timbre vector of each utterance, (B, d)."""
        _, _, timbre = self.encode_tensor(self._prep(wave))
        return timbre.cpu().numpy()

    def latency(self, chunk_frames: Optional[int] = None, sample_rate: int = SR):
        """Analytic delay and latency report of this configuration
        (models/latency.py): algorithmic latency, lookahead (0 when causal),
        conv receptive fields and, given `chunk_frames`, the streaming
        session's chunk buffering and first emission."""
        from facodec_tpu_torch.models.latency import codec_latency

        return codec_latency(tuple(self.encoder.strides), tuple(self.decoder.rates),
                             causal=self.encoder.causal, sample_rate=sample_rate,
                             chunk_frames=chunk_frames)


class FARedecoder:
    """The voice-conversion model: the Redecoder and its DAC decoder, in
    eval mode."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        self.encoder = encoder.eval()
        self.decoder = decoder.eval()
        self.replicas: Optional[Replicas] = None

    def shard_inference(self, devices: Optional[Sequence] = None) -> "FARedecoder":
        """Batch-parallel `resynthesize` over `devices` (see
        `FACodec.shard_inference`); streaming stays on this model's device.
        Returns self."""
        devices = _devices(devices)
        replicas = [FARedecoder(*(m if d == self.device and i == 0 else _replicate(m, d)
                                  for m in (self.encoder, self.decoder)))
                    for i, d in enumerate(devices)]
        if self.replicas is not None:
            self.replicas.close()
        self.replicas = Replicas(replicas, devices, self.device)
        return self

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
        wave = self.resynthesize_tensor(_codes(codes.codes_p, n_codes, dev),
                                        _codes(codes.codes_c, n_codes, dev),
                                        _timbre(target_timbre, dev), use_p_code=use_p_code,
                                        n_c=n_c)
        out = wave.cpu().numpy()
        if codes.original_length:
            out = out[:, : codes.original_length]
        return out

    @_sharded
    @torch.no_grad()
    def resynthesize_tensor(self, codes_p: torch.Tensor, codes_c: torch.Tensor,
                            timbre: torch.Tensor, use_p_code: bool = False,
                            n_c: int = 1) -> torch.Tensor:
        """Code streams (B, n, T) on the device + a target timbre (B, d) ->
        wave (B, T)."""
        with float32_exact():
            z = self.encoder(codes_p, codes_c, timbre, use_p_code=use_p_code, n_c=n_c)
            return self.decoder(z)[:, :, 0]

    def resynthesize_streaming(self, codes: FACodecFile, target_timbre: np.ndarray,
                               chunk_frames: int = 16, use_p_code: bool = False,
                               n_c: int = 1) -> np.ndarray:
        """Chunked real-time voice conversion (equal to `resynthesize`;
        causal models only), in bounded memory for sources of any length.
        A source too short to prime the session is resynthesized one-shot."""
        from facodec_tpu_torch.models.streaming import StreamingRedecoder

        sess = StreamingRedecoder(self.encoder, self.decoder, chunk_frames=chunk_frames,
                                  use_p_code=use_p_code, n_c=n_c)
        dev = self.device
        n_codes = self.encoder.codebook_size
        cp, cc = _codes(codes.codes_p, n_codes, dev), _codes(codes.codes_c, n_codes, dev)
        if cp.shape[-1] < sess.prime_frames:
            return self.resynthesize(codes, target_timbre, use_p_code=use_p_code, n_c=n_c)
        timbre = _timbre(target_timbre, dev)
        state = sess.init_state(cp.shape[0])
        parts = []
        for i in range(0, cp.shape[-1], chunk_frames):
            sl = slice(i, i + chunk_frames)
            state, wave = sess.vc_chunk(state, cp[..., sl], cc[..., sl], timbre)
            if wave is not None:
                parts.append(wave.cpu().numpy())
        out = np.concatenate(parts, axis=1)
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
