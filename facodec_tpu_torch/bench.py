"""Headline benchmark of the port: the codec round trip's real-time factor
on one card, flagship configuration (port of the JAX package's `bench.py`).

    python -m facodec_tpu_torch bench [roundtrip] [--precision P] [--fast]
        [--batch 16] [--seconds 10] [--device cuda] [--config-path cfg]

Prints ONE JSON line:
  {"metric": "encode_decode_rtf", "value": N, "unit": "x_realtime", ...}

The timed call is `FACodec.reconstruct_tensor`: encode -> factorized
quantize -> decode of the quantized latent, the JAX bench's `_roundtrip_fn`,
at `config.FLAGSHIP` (seed 0) on a (batch, seconds) wave of 0.1 * randn from
a seeded generator on the device. Timing: one warm-up call, then three
repeats of ITERS calls issued back to back and one synchronise; a call's
time is the fastest repeat over ITERS.

Beside the headline (precision, batch, seconds):
  flops_per_s_audio  model FLOPs to process one second of audio
                   (`utils.flops.round_trip_flops`: the round trip's
                   convolutions, matrix products and LSTMs, counted from
                   the modules' shapes)
  mfu              FLOPs per second over the card's dense bf16 peak
                   (PEAK_BF16), under every policy, as the JAX bench
                   measures every policy against the bf16 peak; null under
                   `--device cpu`, where no card is measured
  device_kind, power_limit_w  the card's name and power limit (nvidia-smi)
and, unless `--fast` (FACODEC_BENCH_FAST=1):
  codes_match_f32_frac  the share of `bfloat16` codes equal to float32's,
                   1 x 2 s (the JAX bench's comparison)
  batch_curve      [{batch, rtf}] for batch in BATCH_CURVE
  rtf_<policy>     the other policies' RTF at the headline batch

`--precision` (FACODEC_BENCH_PRECISION; default hybrid_int8) takes every
name of ops/precision.py. It runs on the card unless given `--device cpu`;
without a card it exits non-zero. Departures from the JAX bench: no
`vs_baseline` (its target is a TPU's), no watchdog child and no stale
last-good line (a failure exits non-zero with its traceback), no
compilation cache.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.config import FLAGSHIP
from facodec_tpu_torch.ops.precision import POLICY_NAMES
from facodec_tpu_torch.utils.flops import round_trip_flops

SR = 24000
HOP = 300
ITERS = 10
REPEATS = 3
BATCH_CURVE = (1, 8, 16, 32)
OTHER_POLICIES = ("float32", "hybrid", "bfloat16_act", "hybrid_int8")
# Dense bf16 tensor-core peak of each card (FLOP/s), by
# torch.cuda.get_device_name: NVIDIA's data sheet, the SXM part at 700 W.
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}


def require_device(device: str, who: str) -> torch.device:
    """The device to run on; exits non-zero where a CUDA device is asked
    for and torch sees none (no measurement falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{who}: device {device!r} asked for, but torch sees no CUDA device; "
                         "pass --device cpu to run on the CPU")
    return dev


def device_info(device: torch.device) -> dict:
    """device_kind and power_limit_w of the card (nvidia-smi); the CPU has
    neither a kind of card nor a power limit."""
    if device.type != "cuda":
        return dict(device_kind="cpu", power_limit_w=None)
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    name, limit = (s.strip() for s in smi.strip().split(","))
    return dict(device_kind=name, power_limit_w=float(limit))


def peak_bf16(device: torch.device) -> float:
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_BF16:
        raise KeyError(f"bench: no bf16 peak known for {name!r}; add it to PEAK_BF16 from "
                       "the card's data sheet")
    return PEAK_BF16[name]


def build_codec(device: torch.device, precision: str, config_path: Optional[str] = None,
                seed: int = 0) -> FACodec:
    if config_path:
        return FACodec.from_config(config_path, seed=seed, device=str(device),
                                   precision=precision)
    return FACodec.from_fields(FLAGSHIP, seed=seed, device=str(device), precision=precision)


def with_policy(codec: FACodec, precision: str) -> FACodec:
    """The same modules under another policy."""
    return FACodec(codec.encoder, codec.quantizer, codec.decoder, n_c=codec.n_c,
                   precision=precision)


def bench_wave(batch: int, seconds: float, device: torch.device, seed: int = 1
               ) -> torch.Tensor:
    """(batch, seconds of whole frames) of 0.1 * randn, drawn on `device`."""
    T = int(seconds * SR) // HOP * HOP
    gen = torch.Generator(device=device).manual_seed(seed)
    return 0.1 * torch.randn(batch, T, generator=gen, device=device)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_rtf(codec: FACodec, batch: int, seconds: float) -> tuple:
    """(rtf, seconds per call) of `reconstruct_tensor` on a bench wave:
    one warm-up call, then REPEATS runs of ITERS calls and one synchronise."""
    dev = codec.device
    wave = bench_wave(batch, seconds, dev)
    codec.reconstruct_tensor(wave)
    synchronize(dev)
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            codec.reconstruct_tensor(wave)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    dt = min(times) / ITERS
    return batch * wave.shape[1] / SR / dt, dt


def codes_match_f32_frac(codec: FACodec, precision: str, seconds: float = 2.0) -> float:
    """Share of the codes of a 1 x `seconds` bench wave (seed 2) that
    `precision` encodes as float32 does."""
    wave = bench_wave(1, seconds, codec.device, seed=2)
    codes = {}
    for p in ("float32", precision):
        _, cs, _ = with_policy(codec, p).encode_tensor(wave)
        codes[p] = [c.cpu().numpy() for c in cs]
    total = sum(a.size for a in codes["float32"])
    agree = sum(int(np.sum(a == b)) for a, b in zip(codes["float32"], codes[precision]))
    return agree / total


def main(batch: int = 16, seconds: float = 10.0, precision: Optional[str] = None,
         fast: Optional[bool] = None, device: str = "cuda",
         config_path: Optional[str] = None) -> dict:
    """Measure, print the JSON line and return it as a dict."""
    precision = precision or os.environ.get("FACODEC_BENCH_PRECISION", "hybrid_int8")
    if fast is None:
        fast = os.environ.get("FACODEC_BENCH_FAST", "") == "1"
    dev = require_device(device, "bench")
    codec = build_codec(dev, precision, config_path)
    rtf, dt = timed_rtf(codec, batch, seconds)
    samples = int(seconds * SR) // HOP * HOP
    flops = round_trip_flops(dict(encoder=codec.encoder, quantizer=codec.quantizer,
                                  decoder=codec.decoder), batch, samples, n_c=codec.n_c)
    result = {
        "metric": "encode_decode_rtf",
        "value": round(rtf, 2),
        "unit": "x_realtime",
        "precision": codec.precision,
        "batch": batch,
        "seconds": seconds,
        "flops_per_s_audio": round(flops / (batch * samples / SR), 3),
        "mfu": round(flops / dt / peak_bf16(dev), 4) if dev.type == "cuda" else None,
        **device_info(dev),
    }
    if not fast:
        result["codes_match_f32_frac"] = round(codes_match_f32_frac(codec, "bfloat16"), 4)
        result["batch_curve"] = [
            {"batch": b, "rtf": round(rtf if b == batch else timed_rtf(codec, b, seconds)[0], 2)}
            for b in BATCH_CURVE]
        for other in OTHER_POLICIES:
            if other != codec.precision:
                result[f"rtf_{other}"] = round(timed_rtf(with_policy(codec, other), batch,
                                                         seconds)[0], 2)
    print(json.dumps(result), flush=True)
    return result


def add_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--precision", default=None, choices=POLICY_NAMES,
                   help="the timed policy (default FACODEC_BENCH_PRECISION, else hybrid_int8)")
    p.add_argument("--fast", action="store_true", default=None,
                   help="the headline only (FACODEC_BENCH_FAST=1)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--config-path", default=None,
                   help="reference-schema config.yml (needs pyyaml); default FLAGSHIP")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu where there is no CUDA card)")


def run(args: argparse.Namespace) -> dict:
    return main(batch=args.batch or 16, seconds=args.seconds or 10.0, precision=args.precision,
                fast=args.fast, device=args.device, config_path=args.config_path)
