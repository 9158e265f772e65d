"""Where the card's time goes in one flagship codec round trip.

    python -m facodec_tpu_torch.profile [batch] [seconds]

Builds the flagship codec (seeded random weights) on the card, runs
encode -> decode untraced five times (host clock around a synchronise),
then once under `torch.profiler`, and prints the device-kernel time of the
traced run by kind and its top kernels. Kernel times are summed from the
trace's device events; the `aten::` rows of `key_averages()` repeat the same
time and are left out. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict

import torch

from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.config import FLAGSHIP
from facodec_tpu_torch.utils.signals import sweep_wave

# (kind, substrings of the kernel name), first match wins
KINDS = (
    ("residual-unit kernel", ("resunit_kernel",)),
    ("VQ kernel", ("vq_norm_kernel", "vq_search_kernel")),
    ("cuDNN LSTM", ("LSTM", "lstm", "gemmSN", "RNN", "rnn")),
    ("copies", ("copy", "Copy", "memcpy", "Memcpy")),
    ("reflect pads", ("reflection_pad", "ReflectionPad")),
    ("convolutions and GEMMs", ("conv", "Conv", "xmma", "cutlass", "gemm", "Gemm", "sm90",
                                "sm80", "fft", "FFT")),
    ("elementwise and reductions", ("elementwise", "reduce", "Reduce", "norm", "softmax",
                                    "index", "cat", "where")),
)


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def device_ms(prof) -> tuple:
    """(ms by kind, ms by kernel name, launches by kernel name) of the
    device events of a finished `torch.profiler` trace."""
    by_kind, by_name, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        by_kind[kind_of(ev.name)] += us / 1e3
        by_name[ev.name] += us / 1e3
        count[ev.name] += 1
    return by_kind, by_name, count


def main(batch: int = 4, seconds: float = 10.0) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile: torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    codec = FACodec.from_fields(FLAGSHIP, seed=0)
    w = sweep_wave(batch, seconds)
    codec.decode(codec.encode(w))  # builds the kernels, warms cuDNN up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec.decode(codec.encode(w))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"untraced encode -> decode, batch {batch} x {seconds:g} s: "
          + ", ".join(f"{t:.4f}" for t in times) + " s")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec.decode(codec.encode(w))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind, by_name, count = device_ms(prof)
    total = sum(by_kind.values())
    print(f"traced encode -> decode: wall {wall * 1e3:.1f} ms, device kernels {total:.1f} ms "
          f"({total / (wall * 1e3):.1%} of the wall)")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:28s} {ms:9.2f} ms {ms / total:6.1%}")
    print("top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.2f} ms {count[name]:5d} x  {name[:110]}")


if __name__ == "__main__":
    main(*(f(a) for f, a in zip((int, float), sys.argv[1:])))
