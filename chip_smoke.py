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

The line before the last is the kernels' JSON summary; the last line is the
run's JSON result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from facodec_tpu_torch.api import FACodec, FARedecoder, convert_voice, float32_exact
from facodec_tpu_torch.codec_file import FACodecFile
from facodec_tpu_torch.config import FLAGSHIP, FLAGSHIP_REDECODER
from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.models.quantize import VectorQuantize
from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.kernels import build, resunit, vq
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
HBM_BYTES_S = 3.35e12


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
    vq.nearest_code.launches = 0


def counts() -> tuple:
    return resunit.fused_residual_unit.launches, vq.nearest_code.launches


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


def phase_cpu(codec: FACodec) -> None:
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
    phase_cpu(codec)

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

    # no single PyTorch call computes either function: library_ms is null
    kernels = [
        dict(name="fused_residual_unit", route="cuda", source="facodec_tpu_torch/csrc/resunit.cu",
             replaces="facodec_tpu/ops/pallas/resunit.py:273", launches=main_path["resunit"],
             vc_launches=vc_counts[0], bound_by="operations", library_ms=None, **ru),
        dict(name="nearest_code", route="cuda", source="facodec_tpu_torch/csrc/vq.cu",
             replaces="facodec_tpu/ops/pallas/vq.py:76", launches=main_path["vq"],
             vc_launches=vc_counts[1], bound_by="operations", library_ms=None, **vqr),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
