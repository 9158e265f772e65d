"""Where the card's time goes in one flagship codec round trip, or in one
flagship training step.

    python -m facodec_tpu_torch.profile [batch] [seconds] [--precision P]
    python -m facodec_tpu_torch.profile train
    python -m facodec_tpu_torch.profile train-redecoder

Builds the flagship codec (seeded random weights) on the card under the
precision policy `--precision` (any name ops/precision.py takes; default
float32), runs the bench's round trip (`FACodec.reconstruct_tensor`:
encode -> quantize -> decode of the quantized latent) untraced five times
(host clock around a synchronise), then once under `utils.profiling.trace`,
and prints the traced run's device time by kind, by kernel (with launches)
and by annotated range (the API's "encode", "quantize" and "decode").
Kernel times are summed from the trace's device events
(`utils.profiling.device_events`): the host's `aten::` rows repeat the
same time and are left out. `train` does the same for the training step of
`config.FLAGSHIP_TRAIN` at the loop's batch (4 x 80 frames of
`PseudoDataset`): `train_profile` times a steady step's parts between CUDA
events recorded at the step's phase marks, then traces one more step.
`train-redecoder` does the same for the redecoder step of
`config.FLAGSHIP_REDECODER_TRAIN` (frozen codec encode, Redecoder and
decoder, discriminator). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time
from collections import defaultdict
from typing import Iterable

import torch

from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.config import FLAGSHIP
from facodec_tpu_torch.ops.precision import POLICY_NAMES
from facodec_tpu_torch.utils.profiling import (DeviceEvent, aggregate_device_trace,
                                               device_events, force_completion, trace)
from facodec_tpu_torch.utils.signals import sweep_wave

# Each form of the residual unit has a kind of its own, so that two
# policies' profiles compare form by form.
RESUNIT_F32 = "residual unit, float32 and halo (resunit_kernel)"
RESUNIT_BF16 = "residual unit, bf16 forms (resunit_bf16_kernel)"
RESUNIT_INT8 = "residual unit, int8 (resunit_int8_amax + _kernel)"
VQ = "VQ kernel"
W8A8_GEMM = "W8A8 int8 GEMMs (torch._int_mm)"
LSTM_INT8 = "W8A8 LSTM recurrence (lstm_int8_kernel)"

# (kind, substrings of the kernel name), first match wins
KINDS = (
    (RESUNIT_BF16, ("resunit_bf16_kernel",)),
    (RESUNIT_INT8, ("resunit_int8_kernel", "resunit_int8_amax")),
    (RESUNIT_F32, ("resunit_kernel",)),
    (VQ, ("vq_norm_kernel", "vq_search_kernel")),
    # `torch._int_mm`'s cuBLASLt kernels (on an H100 with torch 2.11:
    # cutlass_80_tensorop_i16832gemm_s8_...), named by their int8 MMA shape
    # or their s8 operands
    (W8A8_GEMM, ("i16832gemm", "i8816gemm", "gemm_s8", "s8s8", "i8i8", "imma")),
    # csrc/lstm_int8.cu (FACODEC_LSTM_INT8): ahead of cuDNN's, whose keys match it
    (LSTM_INT8, ("lstm_int8_kernel", "lstm_barrier_kernel")),
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


def breakdown(events: Iterable[DeviceEvent]) -> tuple:
    """(ms by kind, ms by kernel name, launches by kernel name) of a trace's
    device events."""
    by_kind, by_name, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for ev in events:
        by_kind[kind_of(ev.name)] += ev.ms
        by_name[ev.name] += ev.ms
        count[ev.name] += 1
    return by_kind, by_name, count


def device_ms(prof) -> tuple:
    """`breakdown` of a finished `torch.profiler` run, read from its
    Chrome trace as `utils.profiling` reads one."""
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(os.path.join(d, "run.pt.trace.json"))
        return breakdown(device_events(d))


def train_profile(step_fn, batch, generator) -> dict:
    """One steady step with a CUDA event at each phase mark (device ms per
    phase, in the step's order: the stream's time between the marks, idle
    gaps included), then one step under `trace`: its device-kernel ms by
    kind, by kernel and launches, and the traced wall ms."""
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
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            t0 = time.perf_counter()
            step_fn(batch, generator)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_kind, by_name, count = breakdown(device_events(d))
    return dict(phases=phases, by_kind=by_kind, by_name=by_name, count=count,
                traced_wall_ms=wall * 1e3)


def print_breakdown(by_kind, by_name, count, wall_ms: float, top: int = 15) -> None:
    total = sum(by_kind.values())
    print(f"device kernels {total:.1f} ms of a traced wall {wall_ms:.1f} ms "
          f"({total / wall_ms:.1%})")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        n = sum(c for name, c in count.items() if kind_of(name) == kind)
        print(f"  {kind:52s} {ms:9.2f} ms {ms / total:6.1%} {n:6d} launches")
    print("top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.2f} ms {count[name]:5d} x  {name[:110]}")
    other = sorted(((ms, n) for n, ms in by_name.items() if kind_of(n) == "other"), reverse=True)
    if other:
        print("top kernels of kind 'other':")
        for ms, name in other[:8]:
            print(f"  {ms:9.2f} ms {count[name]:5d} x  {name[:110]}")


def round_trip_profile(codec: FACodec, wave: torch.Tensor) -> dict:
    """One traced `reconstruct_tensor` of `wave`: the `breakdown` of its
    device events, the annotated ranges' ms (`aggregate_device_trace`), each
    range's ms by kind, and the traced wall ms."""
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            force_completion(codec.reconstruct_tensor(wave))
            wall = time.perf_counter() - t0
        events = device_events(d)
        _, by_range, _ = aggregate_device_trace(d, printout=False)
    by_kind, by_name, count = breakdown(events)
    range_kind: dict = defaultdict(float)
    for ev in events:
        range_kind[f"{ev.attribution}: {kind_of(ev.name)}"] += ev.ms
    return dict(by_kind=by_kind, by_name=by_name, count=count, by_range=dict(by_range),
                by_range_kind=dict(range_kind), traced_wall_ms=wall * 1e3)


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


def main(batch: int = 4, seconds: float = 10.0, precision: str = "float32") -> None:
    _device()
    codec = FACodec.from_fields(FLAGSHIP, seed=0, precision=precision)
    w = torch.from_numpy(sweep_wave(batch, seconds)).cuda()
    codec.reconstruct_tensor(w)  # builds the kernels, warms cuDNN up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        force_completion(codec.reconstruct_tensor(w))
        times.append(time.perf_counter() - t0)
    print(f"untraced round trip ({precision}), batch {batch} x {seconds:g} s: "
          + ", ".join(f"{t:.4f}" for t in times) + " s")
    out = round_trip_profile(codec, w)
    print(f"traced round trip ({precision}):")
    print_breakdown(out["by_kind"], out["by_name"], out["count"], out["traced_wall_ms"])
    total = sum(out["by_kind"].values())
    for title, key in (("by annotated range", "by_range"),
                       ("by annotated range and kind", "by_range_kind")):
        print(f"{title}:")
        for name, ms in sorted(out[key].items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {ms:9.2f} ms {ms / total:6.1%}  {name}")


def _args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m facodec_tpu_torch.profile")
    p.add_argument("what", nargs="*", help="[batch] [seconds], or train, or train-redecoder")
    p.add_argument("--precision", default="float32", choices=POLICY_NAMES)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = _args()
    if args.what[:1] in (["train"], ["train-redecoder"]):
        main_train(redecoder=args.what[0] == "train-redecoder")
    else:
        main(*(f(a) for f, a in zip((int, float), args.what)), precision=args.precision)
