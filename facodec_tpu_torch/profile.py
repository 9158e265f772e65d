"""Where the card's time goes in one flagship codec round trip, or in one
flagship training step.

    python -m facodec_tpu_torch.profile [batch] [seconds]
    python -m facodec_tpu_torch.profile train
    python -m facodec_tpu_torch.profile train-redecoder

Builds the flagship codec (seeded random weights) on the card, runs
encode -> decode untraced five times (host clock around a synchronise),
then once under `torch.profiler`, and prints the device-kernel time of the
traced run by kind and its top kernels. Kernel times are summed from the
trace's device events; the `aten::` rows of `key_averages()` repeat the same
time and are left out. `train` does the same for the training step of
`config.FLAGSHIP_TRAIN` at the loop's batch (4 x 80 frames of
`PseudoDataset`): `train_profile` times a steady step's parts between CUDA
events recorded at the step's phase marks, then traces one more step.
`train-redecoder` does the same for the redecoder step of
`config.FLAGSHIP_REDECODER_TRAIN` (frozen codec encode, Redecoder and
decoder, discriminator). Needs a CUDA card.
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


def train_profile(step_fn, batch, generator) -> dict:
    """One steady step with a CUDA event at each phase mark (device ms per
    phase, in the step's order: the stream's time between the marks, idle
    gaps included), then one step under torch.profiler: its device-kernel
    ms by kind, by kernel and launches, and the traced wall ms."""
    events = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    torch.cuda.synchronize()
    events[0][1].record()
    step_fn(batch, generator, mark=mark)
    torch.cuda.synchronize()
    phases = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(events, events[1:])}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step_fn(batch, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind, by_name, count = device_ms(prof)
    return dict(phases=phases, by_kind=by_kind, by_name=by_name, count=count,
                traced_wall_ms=wall * 1e3)


def print_breakdown(by_kind, by_name, count, wall_ms: float, top: int = 15) -> None:
    total = sum(by_kind.values())
    print(f"device kernels {total:.1f} ms of a traced wall {wall_ms:.1f} ms "
          f"({total / wall_ms:.1%})")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:28s} {ms:9.2f} ms {ms / total:6.1%}")
    print("top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.2f} ms {count[name]:5d} x  {name[:110]}")
    other = sorted(((ms, n) for n, ms in by_name.items() if kind_of(n) == "other"), reverse=True)
    if other:
        print("top kernels of kind 'other':")
        for ms, name in other[:8]:
            print(f"  {ms:9.2f} ms {count[name]:5d} x  {name[:110]}")


def redecoder_step_fn(seed: int = 0):
    """The redecoder step at `FLAGSHIP_REDECODER_TRAIN` on the card, over
    seeded modules."""
    from facodec_tpu_torch.config import FLAGSHIP_REDECODER_TRAIN
    from facodec_tpu_torch.train.optimizers import build_optimizers
    from facodec_tpu_torch.train.redecoder_loop import build_frozen_codec, build_redecoder_models
    from facodec_tpu_torch.train.redecoder_step import make_redecoder_train_step

    codec = build_frozen_codec(FLAGSHIP_REDECODER_TRAIN["codec"], "cuda")
    models = build_redecoder_models(FLAGSHIP_REDECODER_TRAIN, seed, "cuda")
    return make_redecoder_train_step(codec, models, build_optimizers(models))


def main_train(redecoder: bool = False) -> None:
    from facodec_tpu_torch.config import FLAGSHIP_TRAIN
    from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch, to_device
    from facodec_tpu_torch.train.loop import build_models
    from facodec_tpu_torch.train.optimizers import build_optimizers
    from facodec_tpu_torch.train.step import make_codec_train_step

    _device()
    if redecoder:
        step_fn = redecoder_step_fn()
    else:
        models = build_models(FLAGSHIP_TRAIN, 0, "cuda")
        step_fn = make_codec_train_step(models, build_optimizers(models))
    ds = PseudoDataset(length=4, seed=0)
    batch = to_device(segment_batch(collate([ds[i] for i in range(4)], 80), 80,
                                    generator=torch.Generator().manual_seed(0)), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(3):
        step_fn(batch, gen)
    torch.cuda.synchronize()
    out = train_profile(step_fn, batch, gen)
    print("steady step, device ms per phase (CUDA events at the phase marks): "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["phases"].items()))
    print_breakdown(out["by_kind"], out["by_name"], out["count"], out["traced_wall_ms"])


def _device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile: torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}")


def main(batch: int = 4, seconds: float = 10.0) -> None:
    _device()
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
    print("traced encode -> decode:")
    print_breakdown(*device_ms(prof), wall * 1e3)


if __name__ == "__main__":
    if sys.argv[1:2] in (["train"], ["train-redecoder"]):
        main_train(redecoder=sys.argv[1] == "train-redecoder")
    else:
        main(*(f(a) for f, a in zip((int, float), sys.argv[1:])))
