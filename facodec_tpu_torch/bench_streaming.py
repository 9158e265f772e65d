"""Streaming benchmark of the port: per-chunk latency of the exact stateful
streaming session (encode + decode) on one card, flagship configuration
(port of the JAX package's `bench_streaming.py`).

    python -m facodec_tpu_torch bench streaming [--chunk-frames 4]
        [--seconds 8] [--batch 1] [--fast] [--device cuda] [--config-path cfg]

Prints one JSON line:
  {"metric": "streaming_chunk_p50_ms", "value": N, "unit": "ms", ...}

  value, p99_ms    one `StreamingFACodec.roundtrip_chunk` call until its
                   wave's last sample is on the host, p50 / p99 over the
                   chunks after the first two emitted
  device_only_ms   M chunks issued back to back and one synchronise, per
                   chunk (the fastest of REPEATS runs); _2call_ms the same
                   with `encode_chunk` and `decode_chunk` as two calls
  device_op_ms     the device kernels' time per chunk in a trace of M
                   chunks (`utils.profiling.aggregate_device_trace`);
                   null under `--device cpu`, where there is no device
  e2e_latency_ms   one chunk of buffering + one frame of mel lookahead + p50
  prime_ms, rtf_interactive, rtf_device, latency_analytic
                   (models/latency.py)
  redecoder_vc     the causal `StreamingRedecoder.vc_chunk` (the redecoder
                   at FLAGSHIP_REDECODER widths made causal, the codec's
                   causal decoder): p50, device-only, prime
  group_capacity   `BatchedStreamGroup.tick` of every slot at the group
                   sizes of FACODEC_BENCH_CAPACITY (default 8,32,128), per
                   tick: the largest group whose tick fits in one chunk of
                   audio sustains that many live streams

`--fast` times one repeat instead of REPEATS and sweeps only the first
group size. The session's timbre is zeros, as the JAX bench's. It runs on
the card unless given `--device cpu`; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from facodec_tpu_torch.api import FARedecoder
from facodec_tpu_torch.bench import REPEATS, build_codec, require_device, synchronize
from facodec_tpu_torch.config import FLAGSHIP, FLAGSHIP_REDECODER
from facodec_tpu_torch.models.latency import codec_latency
from facodec_tpu_torch.models.stream_batch import BatchedStreamGroup
from facodec_tpu_torch.models.streaming import StreamingFACodec, StreamingRedecoder
from facodec_tpu_torch.utils.profiling import aggregate_device_trace, trace

SR, HOP = 24000, 300
M = 16  # chunks issued back to back for the device-only and traced times


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return 0.1 * torch.randn(*shape, generator=gen, device=device)


def _p(xs, q: float) -> float:
    return float(np.percentile(xs, q)) * 1e3


def main(chunk_frames: int = 4, seconds: float = 8.0, batch: int = 1, fast: bool = False,
         device: str = "cuda", config_path: Optional[str] = None) -> dict:
    dev = require_device(device, "bench streaming")
    repeats = 1 if fast else REPEATS
    codec = build_codec(dev, "float32", config_path)
    sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder,
                            chunk_frames=chunk_frames, n_c=2)
    est, dst = sess.init_encode_state(batch), sess.init_decode_state(batch)
    timbre = torch.zeros(batch, codec.quantizer.in_dim, device=dev)
    step = chunk_frames * HOP
    gen = torch.Generator(device=dev).manual_seed(1)
    lat = []
    for _ in range(int(seconds * SR) // step):
        chunk = _randn(gen, (batch, step), dev)
        synchronize(dev)  # the input is ready before the clock starts
        t0 = time.perf_counter()
        est, dst, wave, _ = sess.roundtrip_chunk(est, dst, chunk, timbre)
        if wave is None:  # priming: no emission yet
            continue
        float(wave[0, -1])  # the chunk's wave on the host
        lat.append(time.perf_counter() - t0)
    warm = lat[2:]
    p50, p99 = _p(warm, 50), _p(warm, 99)
    chunk_ms = step / SR * 1e3

    # device-only: the chunk steps form a chain through the session's state,
    # so M chunks issued back to back and one synchronise time M executions
    chunks = [_randn(gen, (batch, step), dev) for _ in range(M)]
    ts, ts2 = [], []
    for _ in range(repeats):
        e2, d2 = est, dst
        synchronize(dev)
        t0 = time.perf_counter()
        for c in chunks:
            e2, d2, w, _ = sess.roundtrip_chunk(e2, d2, c, timbre)
        float(w[0, -1])
        ts.append(time.perf_counter() - t0)
        e2, d2 = est, dst  # encode and decode as two calls
        synchronize(dev)
        t0 = time.perf_counter()
        for c in chunks:
            e2, outs, _ = sess.encode_chunk(e2, c, timbre)
            d2, w = sess.decode_chunk(d2, outs)
        float(w[0, -1])
        ts2.append(time.perf_counter() - t0)
    dev_ms = min(ts) / M * 1e3
    dev_ms_2call = min(ts2) / M * 1e3

    dev_op_ms = None
    if dev.type == "cuda":
        with tempfile.TemporaryDirectory() as d:
            e2, d2 = est, dst
            with trace(d):
                for c in chunks:
                    e2, d2, w, _ = sess.roundtrip_chunk(e2, d2, c, timbre)
                float(w[0, -1])
            _, _, total_ms = aggregate_device_trace(d, printout=False)
        if total_ms <= 0:
            raise RuntimeError("bench streaming: the trace holds no device kernel")
        dev_op_ms = total_ms / M

    latency = codec_latency(tuple(codec.encoder.strides), tuple(codec.decoder.rates),
                            causal=codec.encoder.causal, sample_rate=SR,
                            chunk_frames=chunk_frames).as_dict()
    result = {
        "metric": "streaming_chunk_p50_ms",
        "value": round(p50, 2),
        "unit": "ms",
        "chunk_ms": round(chunk_ms, 1),
        "batch": batch,
        "p99_ms": round(p99, 2),
        "device_only_ms": round(dev_ms, 2),
        "device_only_2call_ms": round(dev_ms_2call, 2),
        "device_op_ms": None if dev_op_ms is None else round(dev_op_ms, 2),
        # what a listener waits in steady state: one chunk of buffering, one
        # frame of the mel's lookahead, and the chunk's compute (p50)
        "e2e_latency_ms": round(chunk_ms + HOP / SR * 1e3 + p50, 2),
        "prime_ms": round(sess.prime_frames * HOP / SR * 1e3, 1),
        "rtf_interactive": round(chunk_ms / p50, 2),
        "rtf_device": round(chunk_ms / dev_ms, 2),
        "latency_analytic": {k: v for k, v in latency.items()
                             if k.endswith("_ms") or k in ("hop", "causal", "lookahead")},
        "redecoder_vc": bench_redecoder_vc(dev, chunk_frames, batch, repeats, config_path),
        "group_capacity": bench_group_capacity(sess, fast),
    }
    print(json.dumps(result), flush=True)
    return result


def bench_group_capacity(sess: StreamingFACodec, fast: bool = False) -> dict:
    """Ticks of a `BatchedStreamGroup` with every slot active, at the group
    sizes of FACODEC_BENCH_CAPACITY (the first only when `fast`): a tick
    advances every live stream by one chunk (its chunks to the card, its
    output back to the host, as a server's tick does), so a card sustains
    B streams in real time where tick(B) <= one chunk of audio. Reports the
    ticks, the largest swept B within the budget, and the streams a linear
    extrapolation of its tick would sustain."""
    sweep = [int(b) for b in os.environ.get("FACODEC_BENCH_CAPACITY", "8,32,128").split(",")]
    if fast:
        sweep = sweep[:1]
    dev = next(sess.encoder.parameters()).device
    step = sess.chunk_frames * HOP
    chunk_ms = step / SR * 1e3
    d = sess.quantizer.in_dim
    ticks = {}
    for B in sweep:
        group = BatchedStreamGroup(sess, B)
        prime = torch.zeros(1, sess.prime_frames * HOP, device=dev)
        slots = [group.join(prime, torch.zeros(1, d, device=dev))[0] for _ in range(B)]
        chunks = {s: np.zeros(step, np.float32) for s in slots}
        group.tick(chunks)  # warm-up
        ts = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(8):
                group.tick(chunks)
            ts.append(time.perf_counter() - t0)
        ticks[B] = round(min(ts) / 8 * 1e3, 2)
    result = {"tick_ms": {str(B): t for B, t in ticks.items()},
              "chunk_budget_ms": round(chunk_ms, 1)}
    ok = [B for B, t in ticks.items() if t <= chunk_ms]
    if ok:
        B = max(ok)
        result["sustained_streams_measured"] = B
        result["sustained_streams_extrapolated"] = int(B * chunk_ms / ticks[B])
    return result


def bench_redecoder_vc(dev: torch.device, chunk_frames: int = 4, batch: int = 1,
                       repeats: int = REPEATS, config_path: Optional[str] = None) -> dict:
    """Per-chunk latency of streaming voice conversion (source codes and a
    target timbre -> wave) through the causal redecoder and the codec's
    causal decoder, at flagship widths (or the config's)."""
    if config_path:
        red = FARedecoder.from_config(config_path, device=str(dev))
    else:
        fields = dict(encoder=dict(FLAGSHIP_REDECODER["encoder"], causal=True),
                      decoder=FLAGSHIP["decoder"])
        red = FARedecoder.from_fields(fields, device=str(dev))
    sess = StreamingRedecoder(red.encoder, red.decoder, chunk_frames=chunk_frames,
                              use_p_code=False, n_c=1)
    state = sess.init_state(batch)
    timbre = torch.zeros(batch, red.encoder.encoder.cond_layer.in_channels, device=dev)
    n_codes = red.encoder.codebook_size
    rng = np.random.default_rng(0)

    def chunk():
        return (torch.from_numpy(rng.integers(0, n_codes, (batch, 1, chunk_frames))).to(dev),
                torch.from_numpy(rng.integers(0, n_codes, (batch, 2, chunk_frames))).to(dev))

    lat = []
    for _ in range(max(12, 2 * sess.prime_frames // chunk_frames)):
        cp, cc = chunk()
        synchronize(dev)
        t0 = time.perf_counter()
        state, wave = sess.vc_chunk(state, cp, cc, timbre)
        if wave is None:
            continue
        float(wave[0, -1])
        lat.append(time.perf_counter() - t0)
    p50 = _p(lat[2:], 50)
    cps = [chunk() for _ in range(M)]
    ts = []
    for _ in range(repeats):
        s2 = state
        synchronize(dev)
        t0 = time.perf_counter()
        for cp, cc in cps:
            s2, w = sess.vc_chunk(s2, cp, cc, timbre)
        float(w[0, -1])
        ts.append(time.perf_counter() - t0)
    dev_ms = min(ts) / M * 1e3
    chunk_ms = chunk_frames * HOP / SR * 1e3
    return {"p50_ms": round(p50, 2), "device_only_ms": round(dev_ms, 2),
            "rtf_device": round(chunk_ms / dev_ms, 2),
            "prime_ms": round(sess.prime_frames * HOP / SR * 1e3, 1)}


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--chunk-frames", type=int, default=4)


def run(args: argparse.Namespace) -> dict:
    return main(chunk_frames=args.chunk_frames, seconds=args.seconds or 8.0,
                batch=args.batch or 1, fast=bool(args.fast), device=args.device,
                config_path=args.config_path)
