"""Drive the PyTorch port on one CUDA card and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit, TF32 flags, and the build of
   every CUDA kernel from facodec_tpu_torch/csrc (nvcc, timed).
2. Kernels against their plain PyTorch versions on the card, at the shapes
   of the flagship codec's main path, batch 4 x 10 s: the fused residual
   unit on the very inputs each of its 24 units receives in one reconstruct
   (captured with forward pre-hooks), and the VQ search on the 6 latents its
   quantizers give it in one encode (forward hooks on each in_proj, M =
   4 * 800 rows against a 1024 x 8 codebook), plus random latents and a
   codebook with duplicated rows. Times are medians of CUDA-event timings;
   the VQ search's device time per call is that of 200 calls replayed in
   one CUDA graph, its wrapper time that of one call. For each residual-unit
   shape: FLOP, the bound on float32 CUDA cores and on the kernel's 3xTF32
   tensor cores, TFLOP/s reached, and the error of kernel and plain version
   against a float64 evaluation of the plain version.
3. The slice at full width: the flagship FACodec with seeded random weights
   encodes, decodes and reconstructs the same batch of 4 x 10 s waves; the
   kernels' launch counts show that the path went through them. The JSON's
   `launches` are those of the encode -> decode round trip.
4. The card against the CPU: the same weights at batch 1 x 2 s through the
   port on the CPU (plain versions) and on the card (kernels).
5. Zero-shot voice conversion at full width: `convert_voice` with the
   phase-3 codec's modules at n_c = 1 and the published redecoder
   (`FLAGSHIP_REDECODER`, seeded random weights: embed 512, WN 16, decoder
   1536, non-causal, LSTM 2), source and target batches of 4 x 10 s. The
   launch counts show that it ran 36 residual units (12 encoder units on the
   source, 12 on the target, 12 non-causal decoder units) and 10 VQ searches.
   5a holds the residual-unit kernel to its plain version on the inputs of
   the 12 non-causal decoder units of one resynthesis, as phase 2a does.
6. Voice conversion card against CPU: the same source codes and target
   timbre through a CPU redecoder and a card redecoder of one seed, batch
   1 x 2 s. 6a: a `.fac` file on the card: encode -> bytes -> decode equals
   the decode of the file in memory, and every non-empty stream subset
   decodes with 12 residual-unit launches and no VQ search.
7. Exact chunked streaming at full width: a `StreamingFACodec` session of
   the phase-3 codec over batch 1 x 10 s in 16-frame (200 ms) chunks, then
   batch 4 x 10 s in 4-frame chunks (T < 6d at the d = 9 units of encoder
   stage 4 and decoder stage 1), through `roundtrip_chunk` and
   `flush_encode`, against the card's one-shot `encode` / `reconstruct` of
   the same wave and timbre (codes >= 0.99 equal, wave max abs <= 1e-3).
   Every steady chunk launches exactly 24 residual units through the
   kernel's halo entry and 6 VQ searches. Per-chunk wall latency, from the
   call until the chunk's wave is on the host (p50, p95, after 3 warm
   chunks), the realtime factor and the priming step's time; 10 further
   steady chunks run under torch.profiler, for the device kernels' time per
   chunk by kind (facodec_tpu_torch/profile.py), and are left out of p50
   and p95.
   7a holds the halo entry to its plain version at every flagship unit (C,
   d) for the chunk T of 16 and 4 frames at batch 1 and 4 (the inputs of
   one steady chunk of phase 7 where it ran that combination, captured
   with forward pre-hooks; random inputs of the same shape otherwise), and
   at T = 1, 53, 54, 55 at d = 9: max abs error <= 1e-5, new halo bit-equal.
   7b: `encode_streaming` of batch 1 x 40 s (80-frame chunks) against a
   one-shot encode (codes), `timbre_of` its first 10 s (timbre <= 1e-3),
   and `decode_streaming` against `decode` (<= 1e-3). 7c: a
   `StreamingRedecoder` at the FLAGSHIP_REDECODER widths made causal (a
   field override of this script), batch 1 x 10 s in 16-frame chunks,
   against `resynthesize` (<= 1e-3).

8. The `hybrid` codec (float32 encode, bf16-activation decode) at full
   width, batch 4 x 10 s, built on the phase-3 codec's modules: its codes
   equal the float32 codes, its decode is within err / scale 8e-2 of the
   float32 decode and within 2e-2 of a hybrid decode on the CPU (batch 1 x
   2 s, equal codes), both at the worst sample. One round trip launches 12 float32
   units (the encoder's), 12 bf16 units (the decoder's) and 6 VQ searches.
   Round-trip times against float32, in turns; the CUDA kernels one hybrid
   decode launches (a traced decode), with the units' kept packs of bf16
   operands and with each unit packing on every call. 8a holds the bf16
   entry (csrc/resunit_bf16.cu) to its plain version on the inputs of the
   12 decoder units of one hybrid decode (forward pre-hooks): no element
   more than 2 bf16 ulps off at `resunit.bf16_error_scale`, the kept pack
   giving the per-call pack's bits; per shape the kernel alone (one raw
   launch on the kept pack: device time of 200 launches in one CUDA graph,
   and one launch between two events), the wrapper call, the unit's call
   and the plain version, FLOP, the bf16 bound (989 TFLOP/s, or the bytes
   at 3.35 TB/s), what bounds it and the share reached, the tiling the
   kernel chose (N tile, rows, weight slice, ring stages, shared memory)
   and ptxas's registers and spills for that instantiation. In the kernels
   line, `ms` of `fused_residual_unit_bf16` is the 12 wrapper calls (as it
   was before the kernel kept its operands packed) and `kernel_ms` the 12
   kernels alone (the CUDA-graph device times).
9. `serve` in process: a `CodecService` over the hybrid codec (the serve
   default) behind `make_server` on 127.0.0.1:0. 8 concurrent 10 s
   /reconstruct requests inside a 200 ms batch window run as one device call
   of batch 8; each output is within err / scale 2e-2 of the same request
   sent alone at the worst sample. Then /encode -> /decode, /health,
   /metrics; requests per second concurrent and sequential. Any status but
   200 fails.
9a. Live streams. First a `BatchedStreamGroup` of capacity 8 alone, 4-frame
   (50 ms) chunks: tick times with 1, 4 and 8 active slots, and 10 ticks at
   8 slots under torch.profiler. Then a `StreamingService` with group
   capacity 8 behind `make_stream_server`, and 1, 4 and 8 concurrent
   connections of 10 s each from a client process of their own (the port's
   `stream_wav` in threads, each sending as fast as it is answered):
   per-tick p50 / p95, slots per tick, each stream's time per chunk against
   the 50 ms of audio it carries; every stream's output within 1e-3 of a
   solo session; every tick launches 24 halo entries and 6 VQ searches.

10. Training at full width (`FLAGSHIP_TRAIN`: the codec, its predictor
   heads and its discriminator, seeded random weights). 10a: one training
   forward at batch 4 x 80 frames (PseudoDataset utterances of 1-30 s,
   cropped as the loop crops them); on the inputs of its 24 residual units
   (forward pre-hooks) the kernel's autograd.Function against the plain
   composition's autograd, forward within phase 2a's limit and the
   gradients of x, both weights, both biases and both alphas within
   1e-4 x max|g|, with forward and forward+backward times; on its 6 VQ
   searches the codebook gradient against the plain gather's within
   1e-6 x max|g| and a zero latent gradient. 10b: one draws-off step of
   one seed on the CPU (plain versions) and on the card (kernels), batch
   1 x 20 frames: every loss and gradient norm within 1e-3 relative. 10c:
   `run_training(fields=FLAGSHIP_TRAIN, device="cuda")` with the JAX loop's
   defaults for 6 steps (the first a warm-up), a checkpoint at step 6 and a
   resume to step 7: the median step time, steps/s, seconds of audio per
   second, peak memory, exactly 24 residual-unit and 6 VQ launches a step,
   every loss finite, every module's parameters changed; then one steady
   step's device time per part (CUDA events at the step's phase marks) and
   one traced step by kind and kernel (`profile.train_profile`).
11. Redecoder training at full width (`FLAGSHIP_REDECODER_TRAIN`: the
   frozen flagship codec encoder and quantizer, seed 1; the published
   redecoder with dropout 0.2, its non-causal decoder and the
   discriminator, seed 0). 11a: one redecoder-training forward at batch
   4 x 80 frames; on the inputs of its 12 non-causal decoder units the
   kernel's autograd.Function against the plain composition's autograd, as
   10a. 11b: one draws-off step, CPU against card, batch 1 x 20 frames,
   within 1e-3 relative. 11c: `run_redecoder_training(fields=
   FLAGSHIP_REDECODER_TRAIN, device="cuda")` for 6 steps (the first a
   warm-up), a checkpoint at step 6 and a resume to step 7: median step
   time, steps/s, audio seconds per second, peak memory, exactly 24
   residual-unit launches (12 frozen encoder units without a graph, 12
   decoder units through the Function) and 6 VQ searches a step, every loss
   finite, the three trained modules moved, the frozen codec bit-equal to
   its seeded weights; one steady step's parts and one traced step by
   kind. 11d: from one state and one generator seed, one step each of the
   fused, split and remat variants of the redecoder step and of the codec
   step (`FLAGSHIP_TRAIN`), dropout on: metrics within 1e-4 relative of the
   fused step, the peak memory of each, and the launches each variant
   adds (the split step's second generator forward, remat's recompute).

The line before the last is the kernels' JSON summary; the last line is the
run's JSON result. The kernels' `train_launches` are a training step's,
`train_ms` their device time in the traced step, `train_grad_max_rel` the
worst gradient gap of phase 10a; `redecoder_train_launches`,
`redecoder_train_ms` and `redecoder_grad_max_rel` are the same for the
redecoder step (11c, 11a).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from facodec_tpu_torch.api import FACodec, FARedecoder, convert_voice, float32_exact
from facodec_tpu_torch.cli import serve as serve_cli
from facodec_tpu_torch.cli import stream_serve
from facodec_tpu_torch.codec_file import FACodecFile
from facodec_tpu_torch.config import (FLAGSHIP, FLAGSHIP_REDECODER, FLAGSHIP_REDECODER_TRAIN,
                                      FLAGSHIP_TRAIN)
from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.models.streaming import HOP, StreamingFACodec
from facodec_tpu_torch.models.quantize import ResidualVectorQuantize, VectorQuantize
from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.kernels import build, resunit, vq
from facodec_tpu_torch.profile import device_ms as traced_device_ms
from facodec_tpu_torch.profile import print_breakdown, train_profile
from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch, to_device
from facodec_tpu_torch.train.loop import build_models, latest_checkpoint, run_training
from facodec_tpu_torch.train.optimizers import build_optimizers
from facodec_tpu_torch.train.redecoder_loop import (build_frozen_codec, build_redecoder_models,
                                                    run_redecoder_training)
from facodec_tpu_torch.train.redecoder_step import (frozen_encode, make_redecoder_train_step,
                                                    make_redecoder_train_step_split,
                                                    redecoder_forward)
from facodec_tpu_torch.train.step import (gen_forward, make_codec_train_step,
                                          make_codec_train_step_split)
from facodec_tpu_torch.utils.signals import sweep_wave

SR = 24000
BATCH = 4
SECONDS = 10.0
# Kernel 1 against its plain version: both sum in float32, in another order.
RESUNIT_TOL = 1e-4  # rtol = atol
# Kernel 2: indices equal except where the plain top-2 distance gap is below
# VQ_TIE_GAP (a float32 near-tie), in at most VQ_TIE_SHARE of the rows; the
# gathered rows equal exactly where the indices agree.
VQ_TIE_GAP = 1e-6
VQ_TIE_SHARE = 1e-3
# Phase 4: codes of the card against the CPU, and the decode of equal codes.
CODE_MATCH_MIN = 0.99
DECODE_MAX_DIFF = 1e-3
REPEATS = 10
GRAPH_LAUNCHES = 200  # calls per CUDA graph for a device time per call
RESUNIT_MAX_ERR = 1e-5  # the kernel's float32 sums against the plain version's
# Published peaks of one H100 SXM (dense): the roofline of each kernel.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
# The bf16 entry against its plain version (tests/test_torch_precision.py).
BF16_MAX_ULPS = 2
# A bf16 decode against another evaluation of it (the CPU's, another
# batch's): two orders of summation flip roundings, and a flip moves every
# later layer's input, so the worst sample differs by a few output ulps.
# err / scale at the worst sample; the RMS is printed beside it.
HYBRID_BF16 = 2e-2
# The hybrid decode against the float32 decode: the JAX package's limit
# (tests/test_precision.py).
HYBRID_VS_F32 = 8e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, repeats: int = REPEATS) -> float:
    fn()  # warm-up
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def unit_inputs(parts, run, expected: int) -> list:
    """(unit, x) for every ResidualUnit call of `parts` while `run()` runs."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: calls.append((mod, args[0])))
             for part in parts for m in part.modules() if isinstance(m, ResidualUnit)]
    run()
    for h in hooks:
        h.remove()
    if len(calls) != expected:
        raise AssertionError(f"{len(calls)} residual-unit calls, expected {expected}")
    return calls


def reset_counts() -> None:
    resunit.fused_residual_unit.launches = 0
    resunit.fused_residual_unit.bf16_launches = 0
    resunit.fused_residual_unit_stream.launches = 0
    vq.nearest_code.launches = 0


def all_counts() -> dict:
    return dict(f32=resunit.fused_residual_unit.launches,
                bf16=resunit.fused_residual_unit.bf16_launches,
                halo=resunit.fused_residual_unit_stream.launches, vq=vq.nearest_code.launches)


def wave_gap(got: np.ndarray, want: np.ndarray) -> tuple:
    """(worst-sample err / scale, RMS err / RMS) of two waves."""
    worst = float(np.abs(got - want).max() / np.abs(want).max())
    rms = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
    return worst, rms


def check_hybrid_gap(label: str, got: np.ndarray, want: np.ndarray) -> tuple:
    worst, rms = wave_gap(got, want)
    log(f"  {label}: err/scale {worst:.3e} at the worst sample (limit {HYBRID_BF16}), "
        f"{rms:.3e} in RMS")
    if not worst <= HYBRID_BF16:
        raise AssertionError(f"{label}: err/scale {worst} > {HYBRID_BF16}")
    return worst, rms


def counts() -> tuple:
    """(one-shot residual-unit launches, VQ launches); the halo entry's
    are `stream_count()`."""
    return resunit.fused_residual_unit.launches, vq.nearest_code.launches


def stream_count() -> int:
    return resunit.fused_residual_unit_stream.launches


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build()
    for name in build.SOURCES:
        build.library(name)
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return smi


def resunit_cost(B: int, T: int, C: int) -> tuple:
    """(FLOP, bytes) of one residual unit: 2 * 8 * C^2 FLOP per row (conv7 and
    1x1); x read once, out written once, the weights, biases and alphas once."""
    return 16 * B * T * C * C, 4 * (2 * B * T * C + 8 * C * C + 4 * C)


def bound_ms(flop: float, nbytes: float, peak_flops: float) -> float:
    return 1e3 * max(flop / peak_flops, nbytes / HBM_BYTES_S)


def phase_resunit(title: str, calls: list) -> dict:
    """Each captured unit input through the kernel and the plain version."""
    log(f"{title}, rtol=atol={RESUNIT_TOL}, max_abs_err <= {RESUNIT_MAX_ERR}; bounds at "
        f"{FP32_FLOPS / 1e12:.0f} TFLOP/s float32 (CUDA cores) and 3 x FLOP at "
        f"{TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 (3xTF32 route)")
    worst = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, flops=0, bound_ms=0.0, bound_fp32_ms=0.0)
    for unit, x in calls:
        snake1, conv7, snake2, conv1 = unit.block
        with torch.no_grad(), float32_exact():
            args = (x.contiguous(), conv7.effective_weight(), conv7.bias,
                    conv1.effective_weight(), conv1.bias, snake1.alpha, snake2.alpha,
                    unit.dilation, unit.causal)
            got = resunit.fused_residual_unit(*args)
            want = resunit.residual_unit_reference(*args)
            exact = resunit.residual_unit_reference(
                *(a.double() for a in args[:7]), unit.dilation, unit.causal)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            err64 = (got.double() - exact).abs().max().item()
            plain64 = (want.double() - exact).abs().max().item()
            del exact
            torch.testing.assert_close(got, want, rtol=RESUNIT_TOL, atol=RESUNIT_TOL)
            if not err <= RESUNIT_MAX_ERR:
                raise AssertionError(f"max_abs_err {err} > {RESUNIT_MAX_ERR}")
            tk = median_ms(lambda: resunit.fused_residual_unit(*args))
            tp = median_ms(lambda: resunit.residual_unit_reference(*args))
        B, T, C = x.shape
        flop, nbytes = resunit_cost(B, T, C)
        b3 = bound_ms(3 * flop, nbytes, TF32_FLOPS)
        b1 = bound_ms(flop, nbytes, FP32_FLOPS)
        worst = max(worst, err)
        for k, v in (("ms", tk), ("plain_ms", tp), ("flops", flop), ("bound_ms", b3),
                     ("bound_fp32_ms", b1)):
            tot[k] += v
        log(f"  B={B} C={C:4d} T={T:6d} d={unit.dilation} {'causal' if unit.causal else 'noncausal'}: "
            f"max|x| {x.abs().max().item():.3e} "
            f"FLOP {flop:.4e} bound {b1:.3f} ms fp32 / {b3:.3f} ms 3xtf32; "
            f"kernel {tk:.3f} ms ({flop / tk / 1e9:.1f} TFLOP/s) plain {tp:.3f} ms; "
            f"max_abs_err vs plain {err:.3e}, vs float64: kernel {err64:.3e} plain {plain64:.3e}")
    log(f"  {len(calls)} units: kernel {tot['ms']:.3f} ms plain {tot['plain_ms']:.3f} ms; bound "
        f"{tot['bound_fp32_ms']:.3f} ms fp32 ({tot['bound_fp32_ms'] / tot['ms']:.1%} of it reached) "
        f"/ {tot['bound_ms']:.3f} ms 3xtf32 ({tot['bound_ms'] / tot['ms']:.1%})")
    return dict(max_abs_err=worst, **tot)


def _vq_check(lat: torch.Tensor, cb: torch.Tensor, label: str) -> tuple:
    idx, zq = vq.nearest_code(lat, cb)
    want_idx, want_zq = vq_math.nearest_code(lat, cb)
    dist = vq_math.code_distances(lat, cb)
    top2 = torch.topk(dist, 2, dim=-1, largest=False).values
    near_tie = (top2[:, 1] - top2[:, 0]) < VQ_TIE_GAP
    differ = idx != want_idx
    n_diff = int(differ.sum())
    if bool((differ & ~near_tie).any()):
        raise AssertionError(f"VQ {label}: {int((differ & ~near_tie).sum())} rows differ "
                             f"outside a near-tie")
    if n_diff > VQ_TIE_SHARE * lat.shape[0]:
        raise AssertionError(f"VQ {label}: {n_diff} near-tie rows differ, over the allowance")
    agree = ~differ
    if not torch.equal(zq[agree], want_zq[agree]):
        raise AssertionError(f"VQ {label}: gathered rows differ where the indices agree")
    err = (zq[agree] - want_zq[agree]).abs().max().item() if bool(agree.any()) else 0.0
    log(f"  {label}: M={lat.shape[0]} rows, {n_diff} differ (near-ties, gap < {VQ_TIE_GAP}), "
        f"zq max_abs_err {err:.3e}")
    return idx, n_diff, err


def device_ms(fn, launches: int = GRAPH_LAUNCHES) -> float:
    """Device time per call of fn: `launches` calls captured in one CUDA graph,
    the graph replayed between two events, over the count (median of
    REPEATS replays). The graph takes the host out of the timing."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return median_ms(graph.replay) / launches


def vq_inputs(codec: FACodec, w: np.ndarray) -> list:
    """(name, codebook, latents (M, 8)) for every nearest_code call in one
    encode of w, in call order (forward hooks on each quantizer's in_proj,
    whose output is what the search receives)."""
    calls = []
    hooks = [vqm.in_proj.register_forward_hook(
        lambda mod, args, out, name=name, vqm=vqm: calls.append(
            (name, vqm.codebook.weight.detach(), out.detach().reshape(-1, out.shape[-1]))))
        for name, vqm in codec.quantizer.named_modules() if isinstance(vqm, VectorQuantize)]
    codec.encode(w)
    for h in hooks:
        h.remove()
    return calls


def vq_cost(M: int, K: int, D: int) -> tuple:
    """(FLOP, bytes) of one search: e.c for every pair and the two norms;
    latents and codebook read once, rows and indices written once."""
    return 2 * M * K * D + 2 * (M + K) * D, 4 * (2 * M * D + K * D + M)


def phase_vq(codec: FACodec, w: np.ndarray) -> dict:
    log(f"phase 2b: nearest_code vs plain, first-index ties, gap < {VQ_TIE_GAP} allowed "
        f"in <= {VQ_TIE_SHARE:.1%} of rows; device time = {GRAPH_LAUNCHES} calls in one CUDA "
        f"graph / {GRAPH_LAUNCHES}, wrapper time = one call between two events (median of "
        f"{REPEATS}); bound at {FP32_FLOPS / 1e12:.0f} TFLOP/s float32 (CUDA cores)")
    calls = vq_inputs(codec, w)
    if len(calls) != 6:
        raise AssertionError(f"one encode called nearest_code {len(calls)} times, expected 6")
    gen = torch.Generator(device="cuda").manual_seed(2)
    cb = codec.quantizer.content_quantizer.quantizers[0].codebook.weight.detach().contiguous()
    M = BATCH * int(SECONDS * SR / 300)
    lat = torch.randn(M, cb.shape[1], device="cuda", generator=gen)
    worst = 0.0
    tot = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, plain_wrapper_ms=0.0, flops=0, bound_ms=0.0)
    with torch.no_grad(), float32_exact():
        for name, book, x in calls:
            _, _, err = _vq_check(x, book, name)
            worst = max(worst, err)
            tk = device_ms(lambda: vq.nearest_code(x, book))
            tw = median_ms(lambda: vq.nearest_code(x, book))
            tp = device_ms(lambda: vq_math.nearest_code(x, book))
            tpw = median_ms(lambda: vq_math.nearest_code(x, book))
            flop, nbytes = vq_cost(x.shape[0], *book.shape)
            b = bound_ms(flop, nbytes, FP32_FLOPS)
            for k, v in (("ms", tk), ("wrapper_ms", tw), ("plain_ms", tp),
                         ("plain_wrapper_ms", tpw), ("flops", flop), ("bound_ms", b)):
                tot[k] += v
            log(f"    M={x.shape[0]} N={book.shape[0]}: FLOP {flop:.4e} bytes {nbytes} bound "
                f"{b * 1e3:.3f} us; kernel device {tk * 1e3:.2f} us ({b / tk:.2%} of the bound), "
                f"wrapper {tw * 1e3:.2f} us; plain device {tp * 1e3:.2f} us, one call "
                f"{tpw * 1e3:.2f} us")
        n = len(calls)
        log(f"  mean of the {n} main-path calls: kernel device {tot['ms'] / n * 1e3:.2f} us "
            f"({tot['bound_ms'] / tot['ms']:.2%} of the bound), wrapper "
            f"{tot['wrapper_ms'] / n * 1e3:.2f} us; plain device {tot['plain_ms'] / n * 1e3:.2f} us")
        _, _, err = _vq_check(lat, cb, "random latents")
        worst = max(worst, err)
        dup = cb.clone()
        dup[700], dup[901] = dup[10], dup[3]
        lat_dup = lat.clone()
        lat_dup[: M // 2] = 2.5 * dup[10]
        lat_dup[M // 2:] = 0.5 * dup[3]
        idx, _, _ = _vq_check(lat_dup, dup, "duplicated codebook rows")
        if not (bool((idx[: M // 2] == 10).all()) and bool((idx[M // 2:] == 3).all())):
            raise AssertionError("VQ: duplicated rows did not resolve to the first index")
    # per launch: the means over the main path's calls
    return dict(max_abs_err=worst, **{k: v / n for k, v in tot.items()})


def phase_slice(codec: FACodec, w: np.ndarray) -> dict:
    """Runs after phase 2a, whose reconstruct of the same w warmed the path up."""
    B = w.shape[0]
    log(f"phase 3: flagship round trip, batch {B} x {SECONDS:.0f} s, float32")
    frames = int(SECONDS * SR / 300)

    reset_counts()
    t0 = time.perf_counter()
    codes = codec.encode(w)
    y = codec.decode(codes)
    torch.cuda.synchronize()
    rt = time.perf_counter() - t0
    rt_counts = counts()
    log(f"  encode -> decode: {rt:.3f} s, {B * SECONDS / rt:.1f}x realtime; "
        f"launches resunit {rt_counts[0]} vq {rt_counts[1]}")
    if rt_counts != (24, 6):
        raise AssertionError(f"encode -> decode launched {rt_counts}, expected (24, 6)")
    shapes = (codes.codes_p.shape, codes.codes_c.shape, codes.codes_r.shape, codes.timbre.shape)
    want = ((B, 1, frames), (B, 2, frames), (B, 3, frames), (B, 1024))
    if shapes != want:
        raise AssertionError(f"code shapes {shapes}, expected {want}")
    if y.shape != (B, int(SR * SECONDS)) or not np.isfinite(y).all():
        raise AssertionError(f"decoded wave {y.shape} is not a finite (4, 240000) wave")

    t0 = time.perf_counter()
    r = codec.reconstruct(w)
    torch.cuda.synchronize()
    rt_rec = time.perf_counter() - t0
    total = counts()
    log(f"  reconstruct: {rt_rec:.3f} s, {B * SECONDS / rt_rec:.1f}x realtime; "
        f"launches resunit {total[0] - rt_counts[0]} vq {total[1] - rt_counts[1]}")
    if total != (48, 12):
        raise AssertionError(f"reconstruct launched {(total[0] - 24, total[1] - 6)}, "
                             f"expected (24, 6)")
    if r.shape != y.shape or not np.isfinite(r).all():
        raise AssertionError(f"reconstructed wave {r.shape} is not finite (4, 240000)")
    log(f"  wave rms in {float(np.sqrt(np.mean(w ** 2))):.4f} out {float(np.sqrt(np.mean(y ** 2))):.4f}")
    return dict(resunit=rt_counts[0], vq=rt_counts[1], roundtrip_s=rt, reconstruct_s=rt_rec)


def phase_cpu(codec: FACodec) -> FACodec:
    """Returns the CPU codec, for phase 8."""
    log("phase 4: card against CPU, flagship weights, batch 1 x 2 s")
    cpu = FACodec.from_fields(FLAGSHIP, seed=0, device="cpu")
    w = sweep_wave(1, 2.0, seed=3)
    t0 = time.perf_counter()
    c_cpu = cpu.encode(w)
    c_gpu = codec.encode(w)
    names = ("codes_p", "codes_c", "codes_r")
    same = sum(int((getattr(c_cpu, n) == getattr(c_gpu, n)).sum()) for n in names)
    total = sum(getattr(c_cpu, n).size for n in names)
    match = same / total
    y_cpu = cpu.decode(c_cpu)
    y_gpu = codec.decode(c_cpu)
    diff = float(np.abs(y_cpu - y_gpu).max())
    t_diff = float(np.abs(c_cpu.timbre - c_gpu.timbre).max())
    log(f"  code match {match:.5f} ({same}/{total}), timbre max diff {t_diff:.3e}, "
        f"decode of the same codes max abs diff {diff:.3e} ({time.perf_counter() - t0:.1f} s)")
    if match < CODE_MATCH_MIN:
        raise AssertionError(f"code match {match} < {CODE_MATCH_MIN}")
    if not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"decode difference {diff} > {DECODE_MAX_DIFF}")
    return cpu


def phase_vc(codec_vc: FACodec, red: FARedecoder, w: np.ndarray, target: np.ndarray,
             smi: str) -> tuple:
    """Two counted convert_voice runs, the second one warm, then its parts
    timed one by one. Returns the launch counts, the codes and the timbre."""
    B = w.shape[0]
    log(f"phase 5: convert_voice, FLAGSHIP_REDECODER, source and target batch {B} x "
        f"{SECONDS:.0f} s, float32 ({smi})")
    for run in ("first", "second"):
        reset_counts()
        t0 = time.perf_counter()
        y = convert_voice(codec_vc, red, w, target)
        torch.cuda.synchronize()
        rt = time.perf_counter() - t0
        vc_counts = counts()
        log(f"  {run} call: {rt:.3f} s, {B * SECONDS / rt:.1f}x realtime; "
            f"launches resunit {vc_counts[0]} vq {vc_counts[1]}")
        if vc_counts != (36, 10):
            raise AssertionError(f"convert_voice launched {vc_counts}, expected (36, 10)")
        if y.shape != (B, int(SR * SECONDS)) or not np.isfinite(y).all():
            raise AssertionError(f"converted wave {y.shape} is not a finite (4, 240000) wave")
    log(f"  wave rms source {float(np.sqrt(np.mean(w ** 2))):.4f} "
        f"out {float(np.sqrt(np.mean(y ** 2))):.4f}")
    parts = []

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts.append(f"{name} {time.perf_counter() - t0:.3f} s")
        return out

    codes = timed("encode source", lambda: codec_vc.encode(w))
    timbre = timed("timbre_of target", lambda: codec_vc.timbre_of(target))
    timed("resynthesize", lambda: red.resynthesize(codes, timbre))
    log(f"  its parts, one call each: {', '.join(parts)}")
    return vc_counts, codes, timbre


def phase_vc_cpu(codec_vc: FACodec, red: FARedecoder) -> None:
    log("phase 6: voice conversion card against CPU, FLAGSHIP_REDECODER seed 1, batch 1 x 2 s, "
        "the same source codes and target timbre")
    cpu = FARedecoder.from_fields(FLAGSHIP_REDECODER, seed=1, device="cpu")
    codes = codec_vc.encode(sweep_wave(1, 2.0, seed=6))
    timbre = codec_vc.timbre_of(sweep_wave(1, 2.0, seed=7))
    t0 = time.perf_counter()
    y_cpu = cpu.resynthesize(codes, timbre)
    y_gpu = red.resynthesize(codes, timbre)
    diff = float(np.abs(y_cpu - y_gpu).max())
    log(f"  max abs wave difference {diff:.3e} ({time.perf_counter() - t0:.1f} s)")
    if not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"VC card vs CPU difference {diff} > {DECODE_MAX_DIFF}")


def phase_fac(codec: FACodec, w: np.ndarray) -> None:
    log(f"phase 6a: .fac on the card, batch {w.shape[0]} x {SECONDS:.0f} s")
    f = codec.encode(w)
    blob = f.to_bytes()
    g = FACodecFile.from_bytes(blob)
    for name in ("codes_p", "codes_c", "codes_r", "timbre"):
        if not np.array_equal(getattr(f, name), getattr(g, name)):
            raise AssertionError(f".fac round trip changed {name}")
    y, y_file = codec.decode(f), codec.decode(g)
    if not np.array_equal(y, y_file):
        raise AssertionError(f"decode of the read-back file differs by "
                             f"{float(np.abs(y - y_file).max())}")
    log(f"  {len(blob)} bytes; decode of the read-back file equals the in-memory decode")
    for subset in [(p, c, r) for p in (True, False) for c in (True, False)
                   for r in (True, False) if p or c or r]:
        reset_counts()
        y = codec.decode_subset(f, *subset)
        n = counts()
        name = "".join(s for s, on in zip("pcr", subset) if on)
        log(f"  subset {name:3s}: launches resunit {n[0]} vq {n[1]}, rms "
            f"{float(np.sqrt(np.mean(y ** 2))):.4f}")
        if n != (12, 0):
            raise AssertionError(f"decode_subset {name} launched {n}, expected (12, 0)")
        if y.shape != w.shape or not np.isfinite(y).all():
            raise AssertionError(f"decode_subset {name}: wave {y.shape} is not finite")


STREAM_SECONDS = 10.0
LONG_SECONDS = 40.0
WARM_CHUNKS = 3
TRACED_CHUNKS = 10  # steady chunks of phase 7 run under torch.profiler, left out of p50 / p95


def stream_inputs(codec: FACodec) -> tuple:
    """Forward pre-hooks on every ResidualUnit of the codec that, while
    `armed["tag"]` is set, keep the (unit, x, halo) of each streamed call
    under that tag. Returns (hooks, captured, armed)."""
    captured: dict = {}
    armed = {"tag": None}

    def hook(mod, args):
        if armed["tag"] is not None and len(args) >= 3 and not args[2]:
            captured.setdefault(armed["tag"], []).append((mod, args[0], args[1]["block_1"]))

    hooks = [m.register_forward_pre_hook(hook) for part in (codec.encoder, codec.decoder)
             for m in part.modules() if isinstance(m, ResidualUnit)]
    return hooks, captured, armed


def phase_stream(codec: FACodec, B: int, chunk: int, armed: dict) -> dict:
    """One flagship streaming session over B x STREAM_SECONDS of sweep,
    checked against the card's one-shot path; the fourth steady chunk's unit
    inputs are captured under the tag (chunk, B), and TRACED_CHUNKS later
    steady chunks run under torch.profiler for the device's busy time.
    Returns its numbers."""
    w = sweep_wave(B, STREAM_SECONDS, seed=8)
    step = chunk * HOP
    wt = torch.from_numpy(w).cuda()
    timbre = torch.from_numpy(codec.timbre_of(w)).cuda()
    sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder,
                            chunk_frames=chunk, n_c=codec.n_c)
    log(f"phase 7: StreamingFACodec, flagship, batch {B} x {STREAM_SECONDS:.0f} s, chunk {chunk} "
        f"frames ({step / SR * 1e3:.0f} ms), prime {sess.prime_frames} frames")
    est, dst = sess.init_encode_state(B), sess.init_decode_state(B)
    waves, codes, lat, steady, traced = [], [], [], [], []
    prime_s = None
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    trace_from = WARM_CHUNKS + 2  # steady chunks before the traced ones
    torch.cuda.synchronize()
    reset_counts()
    t_run = time.perf_counter()
    for i in range(0, wt.shape[1], step):
        before = (*counts(), stream_count())
        if len(lat) == WARM_CHUNKS:
            armed["tag"] = (chunk, B)
        tracing = prime_s is not None and len(lat) + len(traced) >= trace_from and \
            len(traced) < TRACED_CHUNKS
        if tracing and not traced:
            prof.start()
        t0 = time.perf_counter()
        est, dst, y, c = sess.roundtrip_chunk(est, dst, wt[:, i : i + step], timbre)
        if y is None:
            continue
        y = y.cpu().numpy()  # the chunk's wave on the host
        dt = time.perf_counter() - t0
        armed["tag"] = None
        n = tuple(a - b for a, b in zip((*counts(), stream_count()), before))
        if prime_s is None:
            prime_s = dt
        else:
            (traced if tracing else lat).append(dt)
            steady.append(n)
            if tracing and len(traced) == TRACED_CHUNKS:
                prof.stop()
        waves.append(y)
        codes.append([x.cpu().numpy() for x in c])
    outs_t, codes_t = sess.flush_encode(est, timbre)
    dst, y = sess.decode_chunk(dst, outs_t)
    waves.append(y.cpu().numpy())
    codes.append([x.cpu().numpy() for x in codes_t])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    total = (*counts(), stream_count())
    if set(steady) != {(0, 6, 24)}:
        raise AssertionError(f"steady chunks launched (one-shot resunit, vq, halo entry) "
                             f"{sorted(set(steady))}, expected only (0, 6, 24)")
    if len(traced) != TRACED_CHUNKS:
        raise AssertionError(f"{len(traced)} traced chunks, expected {TRACED_CHUNKS}")
    n_emit = len(steady) + 1
    want_total = (0, 6 * n_emit + 6, 24 * n_emit + 12)
    if total != want_total:
        raise AssertionError(f"session launched {total}, expected {want_total}")

    recon = np.concatenate(waves, axis=1)
    stream_codes = [np.concatenate([c[j] for c in codes], axis=-1) for j in range(3)]
    f = codec.encode(w)
    one_shot = codec.reconstruct(w)
    same = sum(int((a == b).sum()) for a, b in
               zip(stream_codes, (f.codes_p, f.codes_c, f.codes_r)))
    n_codes = sum(a.size for a in stream_codes)
    diff = float(np.abs(recon - one_shot).max())
    warm = lat[WARM_CHUNKS:]
    p50, p95 = (float(np.percentile(warm, q)) for q in (50, 95))
    audio_s = B * step / SR
    log(f"  {len(lat) + 1} emitted chunks + flush in {run_s:.3f} s; priming step ({sess.prime_frames} "
        f"frames) {prime_s * 1e3:.2f} ms; steady chunk latency p50 {p50 * 1e3:.2f} ms p95 "
        f"{p95 * 1e3:.2f} ms over {len(warm)} chunks (call until its wave is on the host); "
        f"realtime factor at p50 {audio_s / p50:.1f}x ({B} x {step / SR * 1e3:.0f} ms of audio "
        f"per chunk)")
    by_kind, _, _ = traced_device_ms(prof)
    dev_ms = sum(by_kind.values()) / TRACED_CHUNKS
    wall_ms = 1e3 * sum(traced) / TRACED_CHUNKS
    log(f"  traced ({TRACED_CHUNKS} steady chunks under torch.profiler): wall {wall_ms:.2f} ms "
        f"per chunk, device kernels {dev_ms:.2f} ms per chunk ({dev_ms / wall_ms:.1%} busy): "
        + ", ".join(f"{k} {v / TRACED_CHUNKS:.2f} ms" for k, v in
                    sorted(by_kind.items(), key=lambda kv: -kv[1])))
    log(f"  launches per steady chunk: halo entry 24, vq 6, one-shot entry 0; session total "
        f"{total}; codes equal to the one-shot encode {same}/{n_codes} ({same / n_codes:.5f}); "
        f"wave max abs diff to the one-shot reconstruct {diff:.3e}")
    if recon.shape != w.shape or not np.isfinite(recon).all():
        raise AssertionError(f"streamed wave {recon.shape} is not a finite {w.shape} wave")
    if same / n_codes < CODE_MATCH_MIN:
        raise AssertionError(f"stream code match {same / n_codes} < {CODE_MATCH_MIN}")
    if not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"stream vs one-shot wave difference {diff} > {DECODE_MAX_DIFF}")
    return dict(p50_ms=p50 * 1e3, p95_ms=p95 * 1e3, prime_ms=prime_s * 1e3,
                rtf=audio_s / p50, device_ms=dev_ms, traced_wall_ms=wall_ms, halo=24, vq=6)


def stream_unit_cost(B: int, T: int, C: int, d: int) -> tuple:
    """(FLOP, bytes) of one streamed unit: as `resunit_cost`, plus the halo
    read and the new halo written."""
    flop, nbytes = resunit_cost(B, T, C)
    return flop, nbytes + 4 * 2 * B * 6 * d * C


def phase_halo(codec: FACodec, captured: dict) -> dict:
    """The halo entry against its plain version at every flagship unit."""
    log(f"phase 7a: fused_residual_unit_stream (halo entry) vs plain, max_abs_err <= "
        f"{RESUNIT_MAX_ERR}, new halo bit-equal; one call between two events (median of "
        f"{REPEATS}); bound = max(3 x FLOP at {TF32_FLOPS / 1e12:.0f} TFLOP/s, bytes at "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s)")
    units = [m for part in (codec.encoder, codec.decoder) for m in part.modules()
             if isinstance(m, ResidualUnit)]
    # rows per latent frame at each unit, from the captured 16-frame chunk
    rows = {id(m): x.shape[1] // 16 for m, x, _ in captured[(16, 1)]}
    real = {(key, id(m)): (x, halo) for key, calls in captured.items() for m, x, halo in calls}
    cases = []
    for m in units:
        for chunk in (16, 4):
            for B in (1, 4):
                cases.append((m, B, chunk * rows[id(m)], real.get(((chunk, B), id(m)))))
        if m.dilation == 9:
            cases += [(m, B, T, None) for T in (1, 53, 54, 55) for B in (1, 4)]
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    main = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for m, B, T, x_halo in cases:
        snake1, conv7, snake2, conv1 = m.block
        C, d = conv7.bias.shape[0], m.dilation
        if x_halo is None:
            x = 0.5 * torch.randn(B, T, C, device="cuda", generator=gen)
            halo = 0.5 * torch.randn(B, 6 * d, C, device="cuda", generator=gen)
        else:
            x, halo = x_halo
        with torch.no_grad(), float32_exact():
            args = (x.contiguous(), halo, conv7.effective_weight(), conv7.bias,
                    conv1.effective_weight(), conv1.bias, snake1.alpha, snake2.alpha, d)
            before = stream_count()
            got, got_halo = resunit.fused_residual_unit_stream(*args)
            want, want_halo = resunit.residual_unit_stream_reference(*args)
            torch.cuda.synchronize()
            launched = stream_count() - before
            err = (got - want).abs().max().item()
            if not torch.equal(got_halo, want_halo):
                raise AssertionError(f"halo entry C={C} d={d} B={B} T={T}: new halo differs "
                                     f"by {(got_halo - want_halo).abs().max().item()}")
            if not err <= RESUNIT_MAX_ERR:
                raise AssertionError(f"halo entry C={C} d={d} B={B} T={T}: max_abs_err {err}")
            tk = median_ms(lambda: resunit.fused_residual_unit_stream(*args))
            tp = median_ms(lambda: resunit.residual_unit_stream_reference(*args))
        flop, nbytes = stream_unit_cost(B, T, C, d)
        b = bound_ms(3 * flop, nbytes, TF32_FLOPS)
        by = "operations" if 3 * flop / TF32_FLOPS > nbytes / HBM_BYTES_S else "bytes"
        worst = max(worst, err)
        src = "phase 7 input" if x_halo is not None else "random input"
        if x_halo is not None and (B, T) == (1, 16 * rows[id(m)]):
            for k, v in (("ms", tk), ("plain_ms", tp), ("bound_ms", b)):
                main[k] += v
        log(f"  C={C:4d} d={d} B={B} T={T:5d} ({src}): kernel {tk:.4f} ms plain {tp:.4f} ms "
            f"bound {b * 1e3:.2f} us ({by}); launches {launched}; max_abs_err {err:.3e}")
    log(f"  the 24 units of a 16-frame steady chunk at batch 1: kernel {main['ms']:.3f} ms "
        f"plain {main['plain_ms']:.3f} ms bound {main['bound_ms'] * 1e3:.2f} us")
    return dict(max_abs_err=worst, cases=len(cases), **{f"stream_{k}": v for k, v in main.items()})


def phase_encode_streaming(codec: FACodec) -> None:
    w = sweep_wave(1, LONG_SECONDS, seed=10)
    log(f"phase 7b: encode_streaming, flagship, batch 1 x {LONG_SECONDS:.0f} s, chunk 80 frames")
    reset_counts()
    t0 = time.perf_counter()
    f = codec.encode_streaming(w, chunk_frames=80)
    t_enc = time.perf_counter() - t0
    n_enc = (*counts(), stream_count())
    reset_counts()
    t0 = time.perf_counter()
    y = codec.decode_streaming(f, chunk_frames=80)
    t_dec = time.perf_counter() - t0
    n_dec = (*counts(), stream_count())
    g = codec.encode(w)
    same = sum(int((getattr(f, n) == getattr(g, n)).sum()) for n in ("codes_p", "codes_c", "codes_r"))
    n_codes = sum(getattr(f, n).size for n in ("codes_p", "codes_c", "codes_r"))
    t_diff = float(np.abs(f.timbre - codec.timbre_of(w[:, : int(10 * SR)])).max())
    y_one = codec.decode(f)
    diff = float(np.abs(y - y_one).max())
    log(f"  encode_streaming {t_enc:.3f} s (launches one-shot resunit, vq, halo entry {n_enc}), "
        f"decode_streaming {t_dec:.3f} s ({n_dec}); codes equal to the one-shot encode "
        f"{same}/{n_codes} ({same / n_codes:.5f}); timbre max diff to timbre_of(first 10 s) "
        f"{t_diff:.3e}; decode_streaming vs decode max abs {diff:.3e}")
    if n_enc[2] == 0 or n_dec[2] == 0:
        raise AssertionError("the streaming route launched no halo entry")
    if same / n_codes < CODE_MATCH_MIN:
        raise AssertionError(f"encode_streaming code match {same / n_codes} < {CODE_MATCH_MIN}")
    if not t_diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"encode_streaming timbre difference {t_diff} > {DECODE_MAX_DIFF}")
    if y.shape != w.shape or not np.isfinite(y).all() or not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"decode_streaming {y.shape}, difference {diff}")


def phase_stream_vc(codec_vc: FACodec) -> None:
    fields = {k: dict(v, causal=True) for k, v in FLAGSHIP_REDECODER.items()}
    red = FARedecoder.from_fields(fields, seed=2, device="cuda")
    w = sweep_wave(1, STREAM_SECONDS, seed=11)
    codes = codec_vc.encode(w)
    timbre = codec_vc.timbre_of(sweep_wave(1, STREAM_SECONDS, seed=12))
    log(f"phase 7c: StreamingRedecoder, FLAGSHIP_REDECODER widths with causal redecoder and "
        f"decoder, batch 1 x {STREAM_SECONDS:.0f} s, chunk 16 frames")
    want = red.resynthesize(codes, timbre)
    reset_counts()
    t0 = time.perf_counter()
    got = red.resynthesize_streaming(codes, timbre, chunk_frames=16)
    dt = time.perf_counter() - t0
    n = (*counts(), stream_count())
    diff = float(np.abs(got - want).max())
    log(f"  resynthesize_streaming {dt:.3f} s, {STREAM_SECONDS / dt:.1f}x realtime; launches "
        f"(one-shot resunit, vq, halo entry) {n}; max abs difference to resynthesize {diff:.3e}")
    if n[0] or n[1] or n[2] == 0:
        raise AssertionError(f"streamed VC launched {n}")
    if got.shape != w.shape or not np.isfinite(got).all() or not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"streamed VC {got.shape}, difference {diff} > {DECODE_MAX_DIFF}")


# ------------------------------------------------------------- phase 8-9a
def phase_hybrid(codec: FACodec, codec_hy: FACodec, cpu: FACodec, w: np.ndarray) -> dict:
    """The hybrid round trip against float32 on the card, and against the
    hybrid decode on the CPU."""
    B = w.shape[0]
    log(f"phase 8: hybrid round trip (float32 encode, bfloat16_act decode), flagship, batch {B} "
        f"x {SECONDS:.0f} s")
    f32 = codec.encode(w)
    y32 = codec.decode(f32)
    codec_hy.decode(codec_hy.encode(w))  # warm the bf16 path up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fhy = codec_hy.encode(w)
    yhy = codec_hy.decode(fhy)
    torch.cuda.synchronize()
    rt = time.perf_counter() - t0
    n = all_counts()
    log(f"  encode -> decode {rt:.3f} s; launches {n}")
    if n != dict(f32=12, bf16=12, halo=0, vq=6):
        raise AssertionError(f"hybrid round trip launched {n}, expected 12 float32 units, "
                             f"12 bf16 units, 6 VQ searches")
    for name in ("codes_p", "codes_c", "codes_r"):
        a, b = getattr(fhy, name), getattr(f32, name)
        per_row = [int((a[i] == b[i]).sum()) for i in range(B)]
        log(f"  {name}: equal to float32's {per_row} of {a[0].size} per row")
        if not np.array_equal(a, b):
            raise AssertionError(f"hybrid {name} differ from float32's")
    if not np.array_equal(fhy.timbre, f32.timbre):
        raise AssertionError("hybrid timbre differs from float32's")
    if yhy.dtype != np.float32 or yhy.shape != y32.shape or not np.isfinite(yhy).all():
        raise AssertionError(f"hybrid wave {yhy.dtype} {yhy.shape} is not a finite float32 wave")
    # against float32, the JAX package's limit (tests/test_precision.py)
    worst32, rms32 = wave_gap(yhy, y32)
    log(f"  hybrid decode vs float32 decode, same codes: err/scale {worst32:.3e} at the worst "
        f"sample (limit {HYBRID_VS_F32}), {rms32:.3e} in RMS")
    if not worst32 < HYBRID_VS_F32:
        raise AssertionError(f"hybrid vs float32 err/scale {worst32} >= {HYBRID_VS_F32}")

    # CUDA kernels one hybrid decode launches: with the units' kept packs (the
    # decode as it runs), and with each unit packing its bf16 operands on
    # every call (its pack switched off for this count only)
    kept = decode_launches(codec_hy, fhy)
    bf16_pack = ResidualUnit.bf16_pack
    ResidualUnit.bf16_pack = lambda self, x: None
    try:
        per_call = decode_launches(codec_hy, fhy)
    finally:
        ResidualUnit.bf16_pack = bf16_pack
    log(f"  CUDA kernel launches of one hybrid decode (traced): {kept} with the units' kept "
        f"packs, {per_call} packing on every call ({(per_call - kept) / 12:.1f} a unit)")

    # times in turns: float32, hybrid, hybrid, float32
    times = {"float32": [], "hybrid": []}
    for name in ("float32", "hybrid", "hybrid", "float32"):
        c = codec if name == "float32" else codec_hy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.decode(c.encode(w))
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        c.reconstruct(w)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    log("  warm times (encode -> decode, reconstruct; in turns f32, hybrid, hybrid, f32): "
        + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)} s" for k, v in times.items()))

    wc = sweep_wave(1, 2.0, seed=3)
    f = codec.encode(wc)
    cpu_hy = FACodec(cpu.encoder, cpu.quantizer, cpu.decoder, precision="hybrid")
    t0 = time.perf_counter()
    y_cpu = cpu_hy.decode(f)
    y_gpu = codec_hy.decode(f)
    log(f"  card vs CPU, batch 1 x 2 s, equal codes ({time.perf_counter() - t0:.1f} s):")
    worst_cpu, rms_cpu = check_hybrid_gap("hybrid decode card vs CPU", y_gpu, y_cpu)
    return dict(hybrid_s=rt, f32_times=times["float32"], hybrid_times=times["hybrid"],
                worst32=worst32, rms32=rms32, worst_cpu=worst_cpu, rms_cpu=rms_cpu,
                launches=n, decode_kernels=kept, decode_kernels_per_call_pack=per_call, f=f32)


def decode_launches(codec_hy: FACodec, f) -> int:
    """CUDA kernels launched by one decode of f, from a traced run."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        codec_hy.decode(f)
        torch.cuda.synchronize()
    return sum(traced_device_ms(prof)[2].values())


def bf16_unit_cost(B: int, T: int, C: int) -> tuple:
    """(FLOP, bytes) of one bf16 unit: 16 C^2 FLOP per row; x read and out
    written in bf16, the float32 weights, biases and alphas read once."""
    return 16 * B * T * C * C, 2 * 2 * B * T * C + 4 * (8 * C * C + 4 * C)


def bf16_ptxas() -> dict:
    """(NW, MT, KC, SPILL) -> ptxas's spill and register lines for that
    instantiation of the bf16 kernel, from the build's log."""
    out, key = {}, None
    for line in build.build_log("resunit_bf16").splitlines():
        m = re.search(r"resunit_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", line)
        if m:
            key = tuple(int(v) for v in m.groups())
        elif key is not None and ("spill" in line or "registers" in line):
            out.setdefault(key, []).append(line.replace("ptxas info    :", "").strip())
    return out


def phase_bf16(calls: list) -> dict:
    log(f"phase 8a: the bf16 entry (csrc/resunit_bf16.cu) vs its plain version (bfloat16_act) on "
        f"the 12 decoder units' inputs of one hybrid decode; <= {BF16_MAX_ULPS} bf16 ulps at "
        f"bf16_error_scale; kernel = one raw launch on the unit's kept pack, device time of "
        f"{GRAPH_LAUNCHES} launches in one CUDA graph / {GRAPH_LAUNCHES} (and one launch between "
        f"two events); wrapper = one fused_residual_unit call (per-call pack); unit = the "
        f"ResidualUnit call (kept pack); bound = max(FLOP at {BF16_FLOPS / 1e12:.0f} TFLOP/s, "
        f"bytes at {HBM_BYTES_S / 1e12:.2f} TB/s)")
    ptx = bf16_ptxas()
    # ms: the wrapper call (the entry's `ms` before it kept packs); kernel_ms: the kernel alone
    tot = dict(kernel_ms=0.0, events_ms=0.0, ms=0.0, unit_ms=0.0, plain_ms=0.0, flops=0,
               bound_ms=0.0)
    bound_of = {"operations": 0.0, "bytes": 0.0}
    worst_abs, worst_ulps, min_equal = 0.0, 0.0, 1.0
    seen = set()
    for unit, x in calls:
        snake1, conv7, snake2, conv1 = unit.block
        d, causal = unit.dilation, unit.causal
        with torch.no_grad(), float32_exact():
            x = x.contiguous()
            if x.dtype != torch.bfloat16:
                raise AssertionError(f"decoder unit input is {x.dtype}, expected bfloat16")
            args = (x, conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
                    snake1.alpha, snake2.alpha, d, causal)
            pack = unit.bf16_pack(x)  # kept by the decode that gave x
            if pack is None or pack.maps is None:
                raise AssertionError("the decoder unit keeps no packed operands")
            got = resunit.fused_residual_unit(*args)
            packed = resunit.fused_residual_unit_packed(x, pack, d, causal)
            want = resunit.residual_unit_reference(*args)
            scale = resunit.bf16_error_scale(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, packed):
                raise AssertionError("the kept pack and a per-call pack give different outputs")
            ulps = resunit.bf16_ulps(got, want, scale).max().item()
            err = (got.float() - want.float()).abs().max().item()
            equal = (got == want).float().mean().item()
            if not ulps <= BF16_MAX_ULPS:
                raise AssertionError(f"bf16 entry {tuple(x.shape)} d={d}: {ulps} ulps > "
                                     f"{BF16_MAX_ULPS}")
            B, T, C = x.shape
            pad_left, ext = resunit._reflect_extent(T, d, causal)
            out = torch.empty_like(x)

            def launch():
                resunit.launch_bf16(x, pack, d, pad_left, ext, out)
            tk = device_ms(launch)
            te = median_ms(launch)
            tw = median_ms(lambda: resunit.fused_residual_unit(*args))
            tu = median_ms(lambda: unit(x))
            tp = median_ms(lambda: resunit.residual_unit_reference(*args))
        flop, nbytes = bf16_unit_cost(B, T, C)
        b = bound_ms(flop, nbytes, BF16_FLOPS)
        by = "operations" if flop / BF16_FLOPS > nbytes / HBM_BYTES_S else "bytes"
        bound_of[by] += b
        worst_abs, worst_ulps = max(worst_abs, err), max(worst_ulps, ulps)
        min_equal = min(min_equal, equal)
        for k, v in (("kernel_ms", tk), ("events_ms", te), ("ms", tw), ("unit_ms", tu),
                     ("plain_ms", tp), ("flops", flop), ("bound_ms", b)):
            tot[k] += v
        plan = resunit.bf16_plan(B, T, C, d)
        cfg = (plan["bn"] // 2, plan["bm"] // 64, plan["kc"], plan["spill"])
        if cfg not in seen:
            seen.add(cfg)
            log(f"  kernel <NW={cfg[0]}, MT={cfg[1]}, KC={cfg[2]}, SPILL={cfg[3]}> (ptxas): "
                + "; ".join(ptx.get(cfg, ["not in the build log"])))
        log(f"  B={B} C={C:4d} T={T:6d} d={d}: FLOP {flop:.4e} bytes {nbytes} bound {b:.4f} ms "
            f"({by}); kernel {tk:.4f} ms ({b / tk:.1%} of the bound, {flop / tk / 1e9:.1f} "
            f"TFLOP/s; one launch {te:.4f} ms), wrapper {tw:.4f} ms, unit {tu:.4f} ms, plain "
            f"{tp:.4f} ms; BN {plan['bn']} x BM {plan['bm']}, KC {plan['kc']}, "
            f"{plan['stages']} stages{' (resident)' if plan['resident'] else ''}"
            f"{', s2 in the device scratch' if plan['spill'] else ''}, "
            f"{plan['smem']} B shared memory, grid {plan['grid']} "
            f"for {plan['tiles']} tiles; {equal:.4%} bit-equal, worst {ulps:.2f} ulps, max abs "
            f"{err:.3e}")
    by_all = max(bound_of, key=bound_of.get)
    log(f"  12 units: kernel {tot['kernel_ms']:.3f} ms ({tot['bound_ms'] / tot['kernel_ms']:.1%} "
        f"of the {tot['bound_ms']:.3f} ms bound, {by_all}; one launch each "
        f"{tot['events_ms']:.3f} ms), wrapper {tot['ms']:.3f} ms, unit {tot['unit_ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms; bit-equal >= {min_equal:.4%}")
    return dict(max_abs_err=worst_abs, max_ulps=worst_ulps, min_bit_equal=min_equal,
                bound_by=by_all, **tot)


def _http(method: str, url: str, data: bytes = None) -> bytes:
    resp = urllib.request.urlopen(urllib.request.Request(url, data=data, method=method),
                                  timeout=600)
    if resp.status != 200:
        raise AssertionError(f"{method} {url}: HTTP {resp.status}")
    return resp.read()


def phase_serve(codec_hy: FACodec) -> dict:
    n_req = 8
    svc = serve_cli.CodecService(codec_hy, max_batch=n_req, batch_window_ms=200.0)
    server = serve_cli.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    log(f"phase 9: serve in process ({base}), precision {codec_hy.precision}, max batch "
        f"{svc.max_batch}, batch window 200 ms; {n_req} requests of {SECONDS:.0f} s")
    try:
        blobs = [serve_cli.write_wav_bytes(w) for w in sweep_wave(n_req, SECONDS, seed=20)]
        _http("POST", f"{base}/reconstruct", blobs[0])  # warm up
        seq = []
        t0 = time.perf_counter()
        for b in blobs:
            seq.append(serve_cli.read_wav_bytes(_http("POST", f"{base}/reconstruct", b)))
        t_seq = time.perf_counter() - t0
        calls0 = svc._batcher.calls
        reset_counts()
        results = [None] * n_req
        errors = []

        def worker(i):
            try:
                results[i] = serve_cli.read_wav_bytes(_http("POST", f"{base}/reconstruct",
                                                            blobs[i]))
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_req)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_conc = time.perf_counter() - t0
        n = all_counts()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"concurrent requests failed: {errors}")
        calls, seen = svc._batcher.calls - calls0, svc._batcher.max_seen
        log(f"  {n_req} concurrent /reconstruct: {calls} device call(s), largest batch {seen}, "
            f"launches {n}; {t_conc:.3f} s ({n_req / t_conc:.2f} requests/s, "
            f"{n_req * SECONDS / t_conc:.1f}x realtime); sequential {t_seq:.3f} s "
            f"({n_req / t_seq:.2f} requests/s)")
        if calls != 1 or seen != n_req:
            raise AssertionError(f"{n_req} concurrent requests ran as {calls} calls, largest "
                                 f"batch {seen}")
        if n != dict(f32=12, bf16=12, halo=0, vq=6):
            raise AssertionError(f"the batch-8 call launched {n}")
        gaps = [check_hybrid_gap(f"request {i}, batch 8 vs alone", results[i], seq[i])
                for i in range(n_req)]
        fac = _http("POST", f"{base}/encode", blobs[0])
        wav = _http("POST", f"{base}/decode", fac)
        f = FACodecFile.from_bytes(fac)
        if wav[:4] != b"RIFF" or f.codes_c.shape != (1, 2, int(SECONDS * SR / HOP)):
            raise AssertionError(f"/encode -> /decode gave {f.codes_c.shape}, {wav[:4]!r}")
        health = json.loads(_http("GET", f"{base}/health"))
        metrics = _http("GET", f"{base}/metrics").decode()
        if health["status"] != "ok" or "facodec_device_calls_total" not in metrics:
            raise AssertionError(f"/health {health}")
        log(f"  /encode -> /decode: {len(fac)} bytes of codes, {len(wav)} bytes of wav; "
            f"/health {health}")
        return dict(rps_concurrent=n_req / t_conc, rps_sequential=n_req / t_seq,
                    t_conc=t_conc, t_seq=t_seq, worst=max(g[0] for g in gaps),
                    rms=max(g[1] for g in gaps))
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def _solo_stream(sess: StreamingFACodec, wave: np.ndarray, timbre: torch.Tensor) -> np.ndarray:
    """A dedicated batch-1 session over the wave, flush included."""
    est, dst = sess.init_encode_state(1), sess.init_decode_state(1)
    w = torch.from_numpy(wave)[None].cuda()
    step = sess.chunk_frames * HOP
    parts = []
    for i in range(0, w.shape[1], step):
        est, dst, out, _ = sess.roundtrip_chunk(est, dst, w[:, i : i + step], timbre)
        if out is not None:
            parts.append(out.cpu().numpy()[0])
    outs_t, _ = sess.flush_encode(est, timbre)
    dst, out_t = sess.decode_chunk(dst, outs_t)
    parts.append(out_t.cpu().numpy()[0])
    return np.concatenate(parts)


# The live-stream clients run in a process of their own, so that their
# socket threads do not share the server's interpreter lock: N threads, each
# streaming one wave of `waves` as fast as the server answers it.
STREAM_CLIENT = r"""
import json, sys, threading, time
import numpy as np
sys.path.insert(0, sys.argv[4])
from facodec_tpu_torch.cli.stream_serve import stream_wav
port, chunk, stem = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
waves = np.load(stem + ".in.npy")
outs, errors = [None] * len(waves), []
def run(i):
    try:
        outs[i] = stream_wav("127.0.0.1", port, waves[i], chunk_frames=chunk)[0]
    except Exception as e:
        errors.append(repr(e))
threads = [threading.Thread(target=run, args=(i,)) for i in range(len(waves))]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
if not errors:
    np.save(stem + ".out.npy", np.stack(outs))
print(json.dumps({"wall": wall, "errors": errors}))
"""


def phase_group_ticks(codec: FACodec, chunk: int, capacity: int) -> dict:
    """The group alone, no server: ticks of a group of `capacity` slots
    with 1, 4 and 8 of them active, then TRACED_CHUNKS ticks of all under
    torch.profiler."""
    from facodec_tpu_torch.models.stream_batch import BatchedStreamGroup

    sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder, chunk_frames=chunk,
                            n_c=codec.n_c)
    group = BatchedStreamGroup(sess, capacity)
    P, step, n_ticks = sess.prime_frames, chunk * HOP, 60
    w = sweep_wave(capacity, (P * HOP + (3 * n_ticks + TRACED_CHUNKS) * step) / SR, seed=40)
    timbre = torch.from_numpy(codec.timbre_of(w[:, : P * HOP])).cuda()
    slots = [group.join(torch.from_numpy(w[i : i + 1, : P * HOP]).cuda(), timbre[i : i + 1])[0]
             for i in range(capacity)]
    log(f"phase 9a: BatchedStreamGroup alone (capacity {capacity}, {chunk}-frame chunks): "
        f"{n_ticks} ticks each with 1, 4 and 8 active slots (the call until the outputs are on "
        f"the host; first 10 left out)")
    out = {}
    pos = P * HOP
    for n in (1, 4, 8):
        times = []
        for i in range(n_ticks):
            chunks = {s: w[s, pos : pos + step] for s in slots[:n]}
            pos += step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group.tick(chunks)
            times.append(time.perf_counter() - t0)
        t = np.array(times[10:]) * 1e3
        out[n] = dict(p50_ms=float(np.percentile(t, 50)), p95_ms=float(np.percentile(t, 95)))
        log(f"  {n} active slot(s): tick p50 {out[n]['p50_ms']:.2f} ms p95 "
            f"{out[n]['p95_ms']:.2f} ms")
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        for i in range(TRACED_CHUNKS):
            group.tick({s: w[s, pos + i * step : pos + (i + 1) * step] for s in slots})
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRACED_CHUNKS
    by_kind, _, _ = traced_device_ms(prof)
    dev_ms = sum(by_kind.values()) / TRACED_CHUNKS
    log(f"  traced, 8 slots: wall {wall_ms:.2f} ms per tick, device kernels {dev_ms:.2f} ms "
        f"({dev_ms / wall_ms:.1%} busy): " + ", ".join(
            f"{k} {v / TRACED_CHUNKS:.2f} ms" for k, v in
            sorted(by_kind.items(), key=lambda kv: -kv[1])))
    out["traced"] = dict(wall_ms=wall_ms, device_ms=dev_ms)
    return out


def phase_live(codec_hy: FACodec) -> dict:
    import os
    import tempfile

    chunk, capacity = 4, 8
    group_alone = phase_group_ticks(codec_hy, chunk, capacity)
    svc = serve_cli.CodecService(codec_hy)
    streaming = stream_serve.StreamingService(svc, group_capacity=capacity)
    server = stream_serve.make_stream_server(streaming, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    disp = streaming.dispatcher(chunk)
    tick_counts = []
    group_tick = disp.group.tick

    def counted_tick(chunks, **kw):  # runs under the service lock
        before = all_counts()
        out = group_tick(chunks, **kw)
        tick_counts.append({k: v - before[k] for k, v in all_counts().items()})
        return out

    disp.group.tick = counted_tick
    chunk_ms = chunk * HOP / SR * 1e3
    log(f"phase 9a: live streams through StreamingService (group capacity {capacity}, window "
        f"{disp.window_s * 1e3:.0f} ms) on tcp://127.0.0.1:{port}, {chunk}-frame "
        f"({chunk_ms:.0f} ms) chunks, {SECONDS:.0f} s per stream, clients in a separate process")
    sess = streaming.session(chunk)
    root = os.path.dirname(os.path.abspath(__file__))
    out = {"group_alone": group_alone}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def run_clients(waves, stem):
                np.save(os.path.join(tmp, stem + ".in.npy"), waves)
                res = subprocess.run([sys.executable, "-c", STREAM_CLIENT, str(port), str(chunk),
                                      os.path.join(tmp, stem), root],
                                     capture_output=True, text=True, timeout=900)
                if res.returncode != 0:
                    raise AssertionError(f"stream clients failed: {res.stderr[-2000:]}")
                info = json.loads(res.stdout.strip().splitlines()[-1])
                if info["errors"]:
                    raise AssertionError(f"stream clients failed: {info['errors']}")
                return np.load(os.path.join(tmp, stem + ".out.npy")), info["wall"]

            run_clients(sweep_wave(1, 1.0, seed=29), "warm")
            for n in (1, 4, 8):
                waves = sweep_wave(n, SECONDS, seed=30 + n)
                disp.tick_s.clear()
                tick_counts.clear()
                results, wall = run_clients(waves, f"s{n}")
                ticks = list(disp.tick_s)
                dts = np.array([dt for dt, _ in ticks]) * 1e3
                stacked = np.array([k for _, k in ticks])
                p50, p95 = (float(np.percentile(dts, q)) for q in (50, 95))
                bad = [c for c in tick_counts if c != dict(f32=0, bf16=0, halo=24, vq=6)]
                if bad:
                    raise AssertionError(f"ticks launched {bad[:3]}, expected 24 halo entries "
                                         f"and 6 VQ searches each")
                worst = 0.0
                for i in range(n):
                    timbre = torch.from_numpy(streaming.timbre_from_wave(
                        waves[i][: sess.prime_frames * HOP])).cuda()
                    want = _solo_stream(sess, waves[i], timbre)
                    if results[i].shape != want.shape:
                        raise AssertionError(f"stream {i}: {results[i].shape} vs {want.shape}")
                    worst = max(worst, float(np.abs(results[i] - want).max()))
                # each client sends as fast as it is answered: one stream's
                # time per chunk is the wall over its chunks
                period = wall / (waves.shape[1] // (chunk * HOP)) * 1e3
                log(f"  {n} stream(s): a stream's chunk every {period:.2f} ms "
                    f"({'faster' if period < chunk_ms else 'slower'} than real time); "
                    f"{len(ticks)} ticks, slots per tick mean {stacked.mean():.2f} max "
                    f"{stacked.max()}; tick p50 {p50:.2f} ms p95 {p95:.2f} ms "
                    f"({'under' if p95 < chunk_ms else 'over'} the {chunk_ms:.0f} ms chunk at "
                    f"p95); every tick 24 halo / 6 VQ; max abs vs solo sessions {worst:.3e}")
                if not worst <= DECODE_MAX_DIFF:
                    raise AssertionError(f"grouped streams vs solo: {worst} > {DECODE_MAX_DIFF}")
                out[n] = dict(p50_ms=p50, p95_ms=p95, period_ms=period, ticks=len(ticks),
                              mean_slots=float(stacked.mean()), max_abs=worst)
    finally:
        server.shutdown()
        server.server_close()
        streaming.close()
        svc.close()
    return out

# ------------------------------------------------------------- phase 10
TRAIN_BATCH, TRAIN_FRAMES = 4, 80  # the JAX loop's batch and segment
TRAIN_GRAD_TOL = 1e-4  # a kernel path's gradients against plain autograd's, of max|g|
VQ_GRAD_TOL = 1e-6  # the codebook gradient against the plain gather's, of max|g|
STEP_TOL = 1e-3  # a step's losses and gradient norms, card against CPU, relative
TRAIN_STEPS = 6  # one warm-up step, five timed
UNIT_GRADS = ("x", "w7", "b7", "w1", "b1", "alpha1", "alpha2")


def train_batch(B: int, frames: int, seed: int, device: str, max_s: float = 30.0) -> dict:
    """A training batch as the loop makes it: PseudoDataset utterances of
    1..max_s s, collated into 80-frame buckets, one crop of `frames` each."""
    ds = PseudoDataset(length=B, seed=seed, max_s=max_s)
    seg = segment_batch(collate([ds[i] for i in range(B)], bucket_frames=80),
                        max_frames=frames, generator=torch.Generator().manual_seed(seed))
    return to_device(seg, device)


def draws_off(models: dict) -> dict:
    """Every draw of the generator forward out of play (the step's CPU and
    card legs then see the same numbers): no quantizer dropout, the residual
    stream always kept, every dropout rate 0."""
    for m in models["quantizer"].modules():
        if isinstance(m, ResidualVectorQuantize):
            m.quantizer_dropout = 0.0
        for attr in ("p_dropout", "dropout"):
            if isinstance(getattr(m, attr, None), float):
                setattr(m, attr, 0.0)
    models["quantizer"].prob_random_mask_residual = 0.0
    return models


def unit_grad_checks(units: list, gen: torch.Generator) -> tuple:
    """Each captured unit input through the kernel's autograd.Function and
    the plain composition's autograd: forward within phase 2a's limit, the
    gradients of x, both weights, both biases and both alphas within
    TRAIN_GRAD_TOL x max|g|; forward and forward+backward times.
    Returns (worst forward error, worst gradient gap, summed times)."""
    worst_fwd = worst_grad = 0.0
    tot = dict(fwd_ms=0.0, fwd_plain_ms=0.0, fwd_bwd_ms=0.0, fwd_bwd_plain_ms=0.0)
    for unit, x in units:
        snake1, conv7, snake2, conv1 = unit.block
        base = [t.detach().contiguous() for t in (
            x, conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
            snake1.alpha, snake2.alpha)]
        cot = torch.randn(x.shape, device="cuda", generator=gen)

        def run(fn, backward=True):
            leaves = [t.clone().requires_grad_(backward) for t in base]
            y = fn(*leaves, unit.dilation, unit.causal)
            return y, (torch.autograd.grad(y, leaves, cot) if backward else None)

        with float32_exact():
            got, g_kernel = run(resunit.fused_residual_unit)
            want, g_plain = run(resunit.residual_unit_reference)
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=RESUNIT_TOL, atol=RESUNIT_TOL)
            if not err <= RESUNIT_MAX_ERR:
                raise AssertionError(f"max_abs_err {err} > {RESUNIT_MAX_ERR}")
            rel = {}
            for name, a, b in zip(UNIT_GRADS, g_kernel, g_plain):
                rel[name] = ((a - b).abs().max() / b.abs().max()).item()
                if not rel[name] <= TRAIN_GRAD_TOL:
                    raise AssertionError(f"unit C={x.shape[-1]} d={unit.dilation}: {name} "
                                         f"gradient {rel[name]:.3e} of max|g| off plain")
            with torch.no_grad():
                tk = median_ms(lambda: resunit.fused_residual_unit(*base, unit.dilation,
                                                                   unit.causal))
                tp = median_ms(lambda: resunit.residual_unit_reference(*base, unit.dilation,
                                                                       unit.causal))
            tkb = median_ms(lambda: run(resunit.fused_residual_unit))
            tpb = median_ms(lambda: run(resunit.residual_unit_reference))
        worst_fwd, worst_grad = max(worst_fwd, err), max(worst_grad, max(rel.values()))
        for k, v in (("fwd_ms", tk), ("fwd_plain_ms", tp), ("fwd_bwd_ms", tkb),
                     ("fwd_bwd_plain_ms", tpb)):
            tot[k] += v
        B, T, C = x.shape
        log(f"  B={B} C={C:4d} T={T:6d} d={unit.dilation}: forward max_abs_err {err:.3e}, "
            f"gradients (of max|g|) " + " ".join(f"{k} {v:.1e}" for k, v in rel.items())
            + f"; forward kernel {tk:.3f} ms plain {tp:.3f} ms, forward+backward kernel "
            f"{tkb:.3f} ms plain {tpb:.3f} ms")
    log(f"  {len(units)} units: forward kernel {tot['fwd_ms']:.3f} ms plain "
        f"{tot['fwd_plain_ms']:.3f} ms; forward+backward kernel {tot['fwd_bwd_ms']:.3f} ms plain "
        f"{tot['fwd_bwd_plain_ms']:.3f} ms (the backward recomputes the plain composition)")
    return worst_fwd, worst_grad, tot


def phase_train_kernels(models: dict, batch: dict) -> dict:
    """10a: both kernels with their gradients, on the inputs of one
    training forward."""
    log(f"phase 10a: kernel gradients on the card, on the inputs of one flagship training "
        f"forward (batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames): forward to phase 2a's limit, "
        f"gradients of {', '.join(UNIT_GRADS)} within {TRAIN_GRAD_TOL} x max|g| of plain "
        f"autograd; VQ codebook gradient within {VQ_GRAD_TOL} x max|g| of the plain gather's, "
        f"latent gradient zero")
    units, searches = [], []
    hooks = [m.register_forward_pre_hook(lambda mod, args: units.append((mod, args[0])))
             for part in (models["encoder"], models["decoder"]) for m in part.modules()
             if isinstance(m, ResidualUnit)]
    hooks += [vqm.in_proj.register_forward_hook(
        lambda mod, args, out, vqm=vqm: searches.append((vqm, out)))
        for vqm in models["quantizer"].modules() if isinstance(vqm, VectorQuantize)]
    with float32_exact():
        out = gen_forward(models, batch, torch.Generator(device="cuda").manual_seed(1))
    for h in hooks:
        h.remove()
    del out
    if (len(units), len(searches)) != (24, 6):
        raise AssertionError(f"{len(units)} units and {len(searches)} searches, expected 24, 6")
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst_fwd, worst_grad, tot = unit_grad_checks(units, gen)
    worst_vq = 0.0
    for i, (vqm, z_e) in enumerate(searches):
        lat = z_e.detach().reshape(-1, z_e.shape[-1]).contiguous()
        cb = vqm.codebook.weight.detach()
        idx, _, _ = _vq_check(lat, cb, f"training search {i}")
        lat_k, cb_k, cb_p = (t.clone().requires_grad_(True) for t in (lat, cb, cb))
        _, zq = vq.nearest_code(lat_k, cb_k)
        cot = torch.randn(zq.shape, device="cuda", generator=gen)
        g_lat, g_cb = torch.autograd.grad(zq, (lat_k, cb_k), cot)
        (g_plain,) = torch.autograd.grad(cb_p[idx.long()], cb_p, cot)
        rel = ((g_cb - g_plain).abs().max() / g_plain.abs().max()).item()
        if not rel <= VQ_GRAD_TOL or g_lat.abs().max().item() != 0.0:
            raise AssertionError(f"VQ search {i}: codebook gradient {rel:.3e} of max|g| off the "
                                 f"gather's, latent gradient max {g_lat.abs().max().item()}")
        worst_vq = max(worst_vq, rel)
        log(f"  search {i}: codebook gradient {rel:.2e} of max|g| off the plain gather's, "
            f"latent gradient 0")
    return dict(max_abs_err=worst_fwd, grad_max_rel=worst_grad, vq_grad_max_rel=worst_vq, **tot)


def phase_train_cpu() -> dict:
    """10b: one draws-off step of the flagship at batch 1 x 20 frames, on the
    CPU (plain versions) and on the card (kernels), from one seed."""
    log(f"phase 10b: one training step, card against CPU, FLAGSHIP_TRAIN seed 7, batch 1 x 20 "
        f"frames, draws off; losses and gradient norms within {STEP_TOL} relative")
    out = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        models = draws_off(build_models(FLAGSHIP_TRAIN, 7, device))
        step = make_codec_train_step(models, build_optimizers(models))
        batch = train_batch(1, 20, 3, device, max_s=2.0)
        t1 = time.perf_counter()
        metrics = {k: float(v) for k, v in step(batch, None)[0].items()}
        log(f"  {device}: built in {t1 - t0:.1f} s, step in {time.perf_counter() - t1:.1f} s")
        out[device] = metrics
        del models, step
    worst = 0.0
    for k in sorted(out["cpu"]):
        a, b = out["cuda"][k], out["cpu"][k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        worst = max(worst, rel)
        log(f"  {k}: card {a:.6g} cpu {b:.6g} (rel {rel:.2e})")
        if not (np.isfinite(a) and rel <= STEP_TOL):
            raise AssertionError(f"{k}: card {a} against CPU {b}")
    return dict(step_max_rel=worst)


def phase_train(smi: str) -> dict:
    """10c: run_training at full width; then a resume; then one traced step."""
    log(f"phase 10c: run_training(fields=FLAGSHIP_TRAIN, device='cuda'), PseudoDataset, batch "
        f"{TRAIN_BATCH} x {TRAIN_FRAMES} frames, {TRAIN_STEPS} steps (1 warm-up), a checkpoint "
        f"at step {TRAIN_STEPS}, then a resume to step {TRAIN_STEPS + 1} [{smi}]")
    log_dir = tempfile.mkdtemp(prefix="train_smoke_", dir=build.BUILD_DIR)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = run_training(fields=FLAGSHIP_TRAIN, device="cuda", max_steps=TRAIN_STEPS,
                             log_dir=log_dir, log_writer=False, log_interval=1,
                             save_interval=TRAIN_STEPS)
        wall = time.perf_counter() - t0
        c = all_counts()
        per_step = dict(f32=c["f32"] / TRAIN_STEPS, vq=c["vq"] / TRAIN_STEPS)
        if (c["f32"], c["vq"], c["bf16"], c["halo"]) != (24 * TRAIN_STEPS, 6 * TRAIN_STEPS, 0, 0):
            raise AssertionError(f"launches {c} over {TRAIN_STEPS} steps; expected 24 residual "
                                 f"units and 6 VQ searches a step")
        times = [1e3 * state.step_times[s] for s in range(2, TRAIN_STEPS + 1)]
        step_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        audio_s = TRAIN_BATCH * TRAIN_FRAMES * HOP / SR
        for k, v in sorted(state.metrics.items()):
            log(f"  {k} {v:.6g}")
            if not np.isfinite(v):
                raise AssertionError(f"{k} is not finite: {v}")
        init = build_models(FLAGSHIP_TRAIN, 0, "cpu")
        for name, m in state.models.items():
            moved = sum(not torch.equal(p.detach().cpu(), q) for p, q in
                        zip(m.parameters(), init[name].parameters()))
            n = len(list(m.parameters()))
            log(f"  {name}: {moved} of {n} parameter tensors changed")
            if moved == 0:
                raise AssertionError(f"{name}: no parameter changed")
        del init
        log(f"  step ms (host clock, a step until its metrics are read): first "
            f"{1e3 * state.step_times[1]:.1f}, then " + ", ".join(f"{t:.1f}" for t in times)
            + f"; median {step_ms:.1f} ms, {1e3 / step_ms:.2f} steps/s, "
            f"{audio_s * 1e3 / step_ms:.2f} s of audio per s; peak memory "
            f"{peak / 2**30:.2f} GiB; launches per step {per_step}; run_training {wall:.1f} s "
            f"[{smi}]")
        ckpt = latest_checkpoint(log_dir)
        if not ckpt.endswith(f"_step_{TRAIN_STEPS:05d}.pth"):
            raise AssertionError(f"latest checkpoint {ckpt}")
        del state
        torch.cuda.empty_cache()
        reset_counts()
        state = run_training(fields=FLAGSHIP_TRAIN, device="cuda", max_steps=TRAIN_STEPS + 1,
                             log_dir=log_dir, log_writer=False, log_interval=1,
                             save_interval=10**9)
        c = all_counts()
        if state.step != TRAIN_STEPS + 1 or state.optimizers["encoder"].count != TRAIN_STEPS + 1:
            raise AssertionError(f"resume reached step {state.step}")
        if (c["f32"], c["vq"]) != (24, 6):
            raise AssertionError(f"resumed step launched {c}")
        log(f"  resumed from {os.path.basename(ckpt)} to step {state.step}: launches {c}")

        step_fn = make_codec_train_step(state.models, state.optimizers)
        batch = train_batch(TRAIN_BATCH, TRAIN_FRAMES, 11, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        step_fn(batch, gen)
        prof = train_profile(step_fn, batch, gen)
        log("  steady step, device ms per part (CUDA events at the step's phase marks): "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["phases"].items()))
        print_breakdown(prof["by_kind"], prof["by_name"], prof["count"], prof["traced_wall_ms"])
        kernel_ms = {kind: prof["by_kind"].get(kind, 0.0)
                     for kind in ("residual-unit kernel", "VQ kernel")}
        del state, step_fn
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return dict(step_ms=step_ms, steps_s=1e3 / step_ms, audio_s_per_s=audio_s * 1e3 / step_ms,
                peak_bytes=peak, per_step=per_step, times=times, phases=prof["phases"],
                kernel_ms=kernel_ms)


# ------------------------------------------------------------- phase 11
RED_STEPS = 6  # one warm-up step, five timed
VARIANT_TOL = 1e-4  # a split or remat step's metrics against the fused step's, relative
VARIANT_STEPS = 3  # timed steps of each variant after its warm-up


def red_setup(device: str, seed: int = 0) -> tuple:
    """(frozen codec, the three trained modules) of FLAGSHIP_REDECODER_TRAIN."""
    codec = build_frozen_codec(FLAGSHIP_REDECODER_TRAIN["codec"], device)
    return codec, build_redecoder_models(FLAGSHIP_REDECODER_TRAIN, seed, device)


def red_batch(B: int, frames: int, seed: int, device: str, max_s: float = 30.0) -> dict:
    """A redecoder batch as its loop makes it: the crop, the full waves and
    their lengths of `train_batch`."""
    batch = train_batch(B, frames, seed, device, max_s)
    return {k: batch[k] for k in ("wave_seg", "full_waves", "wave_lens")}


def phase_red_kernels(codec: dict, models: dict, batch: dict) -> dict:
    """11a: the residual unit's Function on the 12 non-causal decoder units
    of one redecoder-training forward."""
    log(f"phase 11a: kernel gradients on the card, on the 12 non-causal decoder units of one "
        f"redecoder-training forward (FLAGSHIP_REDECODER_TRAIN, batch {TRAIN_BATCH} x "
        f"{TRAIN_FRAMES} frames): forward to phase 2a's limit, gradients of "
        f"{', '.join(UNIT_GRADS)} within {TRAIN_GRAD_TOL} x max|g| of plain autograd")
    with float32_exact():
        codes, timbre = frozen_encode(codec, batch)
        units = unit_inputs((models["decoder"],), lambda: redecoder_forward(
            models, codes, timbre, torch.Generator(device="cuda").manual_seed(1)), 12)
    if any(unit.causal for unit, _ in units):
        raise AssertionError("the redecoder's decoder units should be non-causal")
    worst_fwd, worst_grad, tot = unit_grad_checks(units, torch.Generator(device="cuda")
                                                  .manual_seed(2))
    return dict(max_abs_err=worst_fwd, grad_max_rel=worst_grad, **tot)


def phase_red_cpu() -> dict:
    """11b: one draws-off redecoder step at batch 1 x 20 frames, on the CPU
    (plain versions) and on the card (kernels), from one seed."""
    log(f"phase 11b: one redecoder step, card against CPU, FLAGSHIP_REDECODER_TRAIN seed 7, "
        f"batch 1 x 20 frames, draws off; losses and gradient norms within {STEP_TOL} relative")
    out = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        codec, models = red_setup(device, seed=7)
        models["encoder"].encoder.p_dropout = 0.0
        step = make_redecoder_train_step(codec, models, build_optimizers(models))
        batch = red_batch(1, 20, 3, device, max_s=2.0)
        t1 = time.perf_counter()
        out[device] = {k: float(v) for k, v in step(batch, None)[0].items()}
        log(f"  {device}: built in {t1 - t0:.1f} s, step in {time.perf_counter() - t1:.1f} s")
        del codec, models, step
    worst = 0.0
    for k in sorted(out["cpu"]):
        a, b = out["cuda"][k], out["cpu"][k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        worst = max(worst, rel)
        log(f"  {k}: card {a:.6g} cpu {b:.6g} (rel {rel:.2e})")
        if not (np.isfinite(a) and rel <= STEP_TOL):
            raise AssertionError(f"{k}: card {a} against CPU {b}")
    return dict(step_max_rel=worst)


def phase_red_train(smi: str) -> dict:
    """11c: run_redecoder_training at full width; a resume; one traced step."""
    log(f"phase 11c: run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN, device='cuda'), "
        f"PseudoDataset, batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames, {RED_STEPS} steps "
        f"(1 warm-up), a checkpoint at step {RED_STEPS}, then a resume to step "
        f"{RED_STEPS + 1} [{smi}]")
    log_dir = tempfile.mkdtemp(prefix="red_smoke_", dir=build.BUILD_DIR)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN, device="cuda",
                                       max_steps=RED_STEPS, log_dir=log_dir, log_writer=False,
                                       log_interval=1, save_interval=RED_STEPS)
        wall = time.perf_counter() - t0
        c = all_counts()
        per_step = dict(f32=c["f32"] / RED_STEPS, vq=c["vq"] / RED_STEPS)
        if (c["f32"], c["vq"], c["bf16"], c["halo"]) != (24 * RED_STEPS, 6 * RED_STEPS, 0, 0):
            raise AssertionError(f"launches {c} over {RED_STEPS} steps; expected 24 residual "
                                 f"units (12 frozen encoder, 12 decoder) and 6 VQ searches a step")
        times = [1e3 * state.step_times[s] for s in range(2, RED_STEPS + 1)]
        step_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        audio_s = TRAIN_BATCH * TRAIN_FRAMES * HOP / SR
        for k, v in sorted(state.metrics.items()):
            log(f"  {k} {v:.6g}")
            if not np.isfinite(v):
                raise AssertionError(f"{k} is not finite: {v}")
        init_codec, init = red_setup("cpu")
        for name, m in state.models.items():
            moved = sum(not torch.equal(p.detach().cpu(), q) for p, q in
                        zip(m.parameters(), init[name].parameters()))
            log(f"  {name}: {moved} of {len(list(m.parameters()))} parameter tensors changed")
            if moved == 0:
                raise AssertionError(f"{name}: no parameter changed")
        for name, m in state.frozen.items():
            want = init_codec[name].state_dict()
            for key, t in m.state_dict().items():
                if not torch.equal(t.cpu(), want[key]):
                    raise AssertionError(f"frozen {name}.{key} changed")
        log("  frozen encoder and quantizer: every tensor bit-equal to the seeded codec")
        del init, init_codec
        log(f"  step ms (host clock, a step until its metrics are read): first "
            f"{1e3 * state.step_times[1]:.1f}, then " + ", ".join(f"{t:.1f}" for t in times)
            + f"; median {step_ms:.1f} ms, {1e3 / step_ms:.2f} steps/s, "
            f"{audio_s * 1e3 / step_ms:.2f} s of audio per s; peak memory "
            f"{peak / 2**30:.2f} GiB; launches per step {per_step}; run {wall:.1f} s [{smi}]")
        ckpt = latest_checkpoint(log_dir)
        if not ckpt.endswith(f"_step_{RED_STEPS:05d}.pth"):
            raise AssertionError(f"latest checkpoint {ckpt}")
        del state
        torch.cuda.empty_cache()
        reset_counts()
        state = run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN, device="cuda",
                                       max_steps=RED_STEPS + 1, log_dir=log_dir,
                                       log_writer=False, log_interval=1, save_interval=10**9)
        c = all_counts()
        if state.step != RED_STEPS + 1 or state.optimizers["decoder"].count != RED_STEPS + 1:
            raise AssertionError(f"resume reached step {state.step}")
        if (c["f32"], c["vq"]) != (24, 6):
            raise AssertionError(f"resumed step launched {c}")
        log(f"  resumed from {os.path.basename(ckpt)} to step {state.step}: launches {c}")

        step_fn = make_redecoder_train_step(state.frozen, state.models, state.optimizers)
        batch = red_batch(TRAIN_BATCH, TRAIN_FRAMES, 11, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        step_fn(batch, gen)
        prof = train_profile(step_fn, batch, gen)
        log("  steady step, device ms per part (CUDA events at the step's phase marks): "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["phases"].items()))
        print_breakdown(prof["by_kind"], prof["by_name"], prof["count"], prof["traced_wall_ms"])
        kernel_ms = {kind: prof["by_kind"].get(kind, 0.0)
                     for kind in ("residual-unit kernel", "VQ kernel")}
        del state, step_fn
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return dict(step_ms=step_ms, steps_s=1e3 / step_ms, audio_s_per_s=audio_s * 1e3 / step_ms,
                peak_bytes=peak, per_step=per_step, times=times, phases=prof["phases"],
                kernel_ms=kernel_ms, device_ms=sum(prof["by_kind"].values()),
                traced_wall_ms=prof["traced_wall_ms"])


def variant_runs(label: str, states: dict, make, expected: dict) -> dict:
    """One step of each variant from the same module states (`make(states)`
    restores them and gives the step factory's arguments) and generator
    seed, after a warm-up step from the same: metrics against the fused
    step's, peak memory above the states, launches (residual units, VQ
    searches) against `expected`; then the median host time, until the
    metrics are read, of that step and the next VARIANT_STEPS - 1."""
    out = {}
    for variant, (factory, remat, want) in expected.items():
        for _ in range(2):  # a warm-up step, then the measured one
            step = factory(*make(states), remat=remat)
            gen = torch.Generator(device="cuda").manual_seed(9)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            metrics = {k: float(v) for k, v in step(states["batch"], gen)[0].items()}
            times = [1e3 * (time.perf_counter() - t0)]
        c = all_counts()
        peak = torch.cuda.max_memory_allocated() - base
        if (c["f32"], c["vq"]) != want:
            raise AssertionError(f"{label} {variant}: launches {c}, expected {want}")
        for _ in range(VARIANT_STEPS - 1):  # steps on from there, for the time
            t0 = time.perf_counter()
            float(step(states["batch"], gen)[0]["loss/gen_all"])
            times.append(1e3 * (time.perf_counter() - t0))
        del step
        out[variant] = dict(metrics=metrics, peak_bytes=peak, launches=(c["f32"], c["vq"]),
                            ms=statistics.median(times), times=times)
    fused = out["fused"]["metrics"]
    for variant, r in out.items():
        worst = max(abs(r["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in fused.items())
        r["max_rel"] = worst
        log(f"  {label} {variant}: peak {r['peak_bytes'] / 2**30:.2f} GiB above the states, "
            f"launches {r['launches']}, step ms " + ", ".join(f"{t:.1f}" for t in r["times"])
            + f" (median {r['ms']:.1f}), metrics within {worst:.2e} of fused "
            f"(limit {VARIANT_TOL})")
        if not worst <= VARIANT_TOL:
            raise AssertionError(f"{label} {variant}: metrics {worst} off the fused step")
    return out


def phase_variants() -> dict:
    """11d: fused, split and remat steps of the redecoder and the codec."""
    log(f"phase 11d: one step each of fused, split and remat from one state and one generator "
        f"seed, dropout on, batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames: metrics within "
        f"{VARIANT_TOL} relative of fused, peak memory, launches")
    codec, models = red_setup("cuda")
    red_states = dict(codec=codec, init={k: {n: t.clone() for n, t in m.state_dict().items()}
                                         for k, m in models.items()},
                      models=models, batch=red_batch(TRAIN_BATCH, TRAIN_FRAMES, 13, "cuda"))

    def make_red(st):
        for k, m in st["models"].items():
            m.load_state_dict(st["init"][k])
        return st["codec"], st["models"], build_optimizers(st["models"])

    red = variant_runs("redecoder", red_states, make_red, {
        "fused": (make_redecoder_train_step, False, (24, 6)),
        "split": (make_redecoder_train_step_split, False, (36, 6)),
        "remat": (make_redecoder_train_step, True, (36, 6))})
    del red_states, codec, models
    torch.cuda.empty_cache()

    models = build_models(FLAGSHIP_TRAIN, 0, "cuda")
    codec_states = dict(init={k: {n: t.clone() for n, t in m.state_dict().items()}
                              for k, m in models.items()},
                        models=models, batch=train_batch(TRAIN_BATCH, TRAIN_FRAMES, 13, "cuda"))

    def make_codec(st):
        for k, m in st["models"].items():
            m.load_state_dict(st["init"][k])
        return st["models"], build_optimizers(st["models"])

    cod = variant_runs("codec", codec_states, make_codec, {
        "fused": (make_codec_train_step, False, (24, 6)),
        "split": (make_codec_train_step_split, False, (48, 12)),
        "remat": (make_codec_train_step, True, (48, 12))})
    del codec_states, models
    torch.cuda.empty_cache()
    return dict(redecoder=red, codec=cod)


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    with float32_exact():
        log(f"TF32 inside FACodec calls: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    log(f"TF32 outside (torch defaults, untouched): cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    codec = FACodec.from_fields(FLAGSHIP, seed=0, device="cuda")
    n_params = sum(p.numel() for m in (codec.encoder, codec.quantizer, codec.decoder)
                   for p in m.parameters())
    log(f"flagship codec: {n_params} parameters, seed 0, built in {time.perf_counter() - t0:.1f} s")

    w = sweep_wave(BATCH, SECONDS)
    ru = phase_resunit(
        f"phase 2a: fused_residual_unit vs plain on the main path's inputs (one reconstruct, "
        f"batch {BATCH} x {SECONDS:.0f} s)",
        unit_inputs((codec.encoder, codec.decoder), lambda: codec.reconstruct(w), 24))
    vqr = phase_vq(codec, w)
    main_path = phase_slice(codec, w)
    cpu = phase_cpu(codec)

    t0 = time.perf_counter()
    red = FARedecoder.from_fields(FLAGSHIP_REDECODER, seed=1, device="cuda")
    n_params = sum(p.numel() for m in (red.encoder, red.decoder) for p in m.parameters())
    log(f"flagship redecoder: {n_params} parameters, seed 1, built in "
        f"{time.perf_counter() - t0:.1f} s")
    codec_vc = FACodec(codec.encoder, codec.quantizer, codec.decoder, n_c=1)
    target = sweep_wave(BATCH, SECONDS, seed=1)
    vc_counts, codes, timbre = phase_vc(codec_vc, red, w, target, smi)
    ru_vc = phase_resunit(
        f"phase 5a: fused_residual_unit vs plain on the 12 non-causal decoder units of one "
        f"resynthesis (batch {BATCH} x {SECONDS:.0f} s)",
        unit_inputs((red.decoder,), lambda: red.resynthesize(codes, timbre), 12))
    ru["max_abs_err"] = max(ru["max_abs_err"], ru_vc["max_abs_err"])
    phase_vc_cpu(codec_vc, red)
    phase_fac(codec, w)

    hooks, captured, armed = stream_inputs(codec)
    st16 = phase_stream(codec, 1, 16, armed)
    st4 = phase_stream(codec, 4, 4, armed)
    for h in hooks:
        h.remove()
    halo = phase_halo(codec, captured)
    ru["max_abs_err"] = max(ru["max_abs_err"], halo.pop("max_abs_err"))
    phase_encode_streaming(codec)
    phase_stream_vc(codec_vc)

    codec_hy = FACodec(codec.encoder, codec.quantizer, codec.decoder, precision="hybrid")
    hy = phase_hybrid(codec, codec_hy, cpu, w)
    f32_codes = hy.pop("f")
    bf = phase_bf16(unit_inputs((codec_hy.decoder,), lambda: codec_hy.decode(f32_codes), 12))
    sv = phase_serve(codec_hy)
    live = phase_live(codec_hy)
    del codec, codec_hy, codec_vc, cpu, red
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_models = build_models(FLAGSHIP_TRAIN, 0, "cuda")
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in train_models.items()}
    log(f"flagship training modules (FLAGSHIP_TRAIN, seed 0): {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    tk = phase_train_kernels(train_models, train_batch(TRAIN_BATCH, TRAIN_FRAMES, 0, "cuda"))
    del train_models
    torch.cuda.empty_cache()
    ru["max_abs_err"] = max(ru["max_abs_err"], tk["max_abs_err"])
    tc = phase_train_cpu()
    tr = phase_train(smi)

    t0 = time.perf_counter()
    red_codec, red_models = red_setup("cuda")
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in (*red_codec.items(), *red_models.items())}
    log(f"redecoder training modules (FLAGSHIP_REDECODER_TRAIN: frozen codec seed 1, trained "
        f"modules seed 0): {n_params} parameters, built in {time.perf_counter() - t0:.1f} s")
    rk = phase_red_kernels(red_codec, red_models, red_batch(TRAIN_BATCH, TRAIN_FRAMES, 0, "cuda"))
    del red_codec, red_models
    torch.cuda.empty_cache()
    ru["max_abs_err"] = max(ru["max_abs_err"], rk["max_abs_err"])
    rc = phase_red_cpu()
    rt = phase_red_train(smi)
    va = phase_variants()

    # no single PyTorch call computes either function: library_ms is null
    kernels = [
        dict(name="fused_residual_unit", route="cuda", source="facodec_tpu_torch/csrc/resunit.cu",
             replaces="facodec_tpu/ops/pallas/resunit.py:273", launches=main_path["resunit"],
             vc_launches=vc_counts[0], stream_launches=st16["halo"],
             hybrid_launches=hy["launches"]["f32"], train_launches=tr["per_step"]["f32"],
             train_ms=tr["kernel_ms"]["residual-unit kernel"],
             train_grad_max_rel=tk["grad_max_rel"],
             redecoder_train_launches=rt["per_step"]["f32"],
             redecoder_train_ms=rt["kernel_ms"]["residual-unit kernel"],
             redecoder_grad_max_rel=rk["grad_max_rel"], bound_by="operations",
             library_ms=None, **ru, **halo),
        dict(name="nearest_code", route="cuda", source="facodec_tpu_torch/csrc/vq.cu",
             replaces="facodec_tpu/ops/pallas/vq.py:76", launches=main_path["vq"],
             vc_launches=vc_counts[1], stream_launches=st16["vq"],
             hybrid_launches=hy["launches"]["vq"], train_launches=tr["per_step"]["vq"],
             train_ms=tr["kernel_ms"]["VQ kernel"], train_grad_max_rel=tk["vq_grad_max_rel"],
             redecoder_train_launches=rt["per_step"]["vq"],
             redecoder_train_ms=rt["kernel_ms"]["VQ kernel"],
             bound_by="operations", library_ms=None, **vqr),
        # the bf16 entry (csrc/resunit_bf16.cu): its main path is the hybrid
        # round trip (the serve default), whose 12 decoder units it runs
        dict(name="fused_residual_unit_bf16", route="cuda",
             source="facodec_tpu_torch/csrc/resunit_bf16.cu",
             replaces="facodec_tpu/ops/pallas/resunit.py:273", launches=hy["launches"]["bf16"],
             hybrid_launches=hy["launches"]["bf16"], train_launches=0,
             redecoder_train_launches=0, decode_kernels=hy["decode_kernels"],
             decode_kernels_per_call_pack=hy["decode_kernels_per_call_pack"], library_ms=None,
             **bf),
    ]
    log(f"streaming: chunk 16 batch 1 p50 {st16['p50_ms']:.2f} ms ({st16['rtf']:.1f}x realtime, "
        f"device {st16['device_ms']:.2f} ms of a traced {st16['traced_wall_ms']:.2f} ms), "
        f"chunk 4 batch 4 p50 {st4['p50_ms']:.2f} ms ({st4['rtf']:.1f}x realtime, device "
        f"{st4['device_ms']:.2f} ms of a traced {st4['traced_wall_ms']:.2f} ms)")
    log(f"hybrid: round trip {hy['hybrid_s']:.3f} s (warm f32 {hy['f32_times']}, hybrid "
        f"{hy['hybrid_times']}); serve {sv['rps_concurrent']:.2f} requests/s concurrent, "
        f"{sv['rps_sequential']:.2f} sequential; live ticks "
        + ", ".join(f"{n} streams p50 {v['p50_ms']:.2f} p95 {v['p95_ms']:.2f} ms"
                    for n, v in live.items() if n != "group_alone"))
    log(f"training: step {tr['step_ms']:.1f} ms median, {tr['steps_s']:.2f} steps/s, "
        f"{tr['audio_s_per_s']:.2f} s of audio per s, peak {tr['peak_bytes'] / 2**30:.2f} GiB; "
        f"card vs CPU step {tc['step_max_rel']:.2e}; kernel gradients {tk['grad_max_rel']:.2e} "
        f"(resunit), {tk['vq_grad_max_rel']:.2e} (VQ) [{smi}]")
    log(f"redecoder training: step {rt['step_ms']:.1f} ms median, {rt['steps_s']:.2f} steps/s, "
        f"{rt['audio_s_per_s']:.2f} s of audio per s, peak {rt['peak_bytes'] / 2**30:.2f} GiB, "
        f"device kernels {rt['device_ms']:.1f} ms of a traced {rt['traced_wall_ms']:.1f} ms; "
        f"card vs CPU step {rc['step_max_rel']:.2e}; non-causal unit gradients "
        f"{rk['grad_max_rel']:.2e}; 12 units forward kernel {rk['fwd_ms']:.2f} ms plain "
        f"{rk['fwd_plain_ms']:.2f} ms, forward+backward kernel {rk['fwd_bwd_ms']:.2f} ms plain "
        f"{rk['fwd_bwd_plain_ms']:.2f} ms [{smi}]")
    for label, runs in va.items():
        log(f"{label} step variants: " + "; ".join(
            f"{v} peak {r['peak_bytes'] / 2**30:.2f} GiB, launches {r['launches']}, "
            f"step {r['ms']:.1f} ms"
            for v, r in runs.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
