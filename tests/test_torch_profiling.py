"""The port's tracing and timing tools (facodec_tpu_torch/utils/profiling.py)
and the kinds `profile.py` sorts kernels into, on the CPU.

`aggregate_device_trace` reads a hand-written Chrome trace laid out as
torch.profiler writes one on the card: device kernels and copies, host
ops, the runtime's launch calls, nested annotation ranges and the device's
projection of them. It must count each device event once, and attribute
each to the innermost range around its launch.
"""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

from facodec_tpu_torch.profile import (KINDS, RESUNIT_BF16, RESUNIT_F32, RESUNIT_INT8, VQ,
                                       W8A8_GEMM, breakdown, kind_of)
from facodec_tpu_torch.utils.profiling import (NO_ATTRIBUTION, DeviceEvent, StepTimer,
                                               aggregate_device_trace, annotate, device_events,
                                               force_completion, trace)

HOST, DEV = 1234, 0  # the host process's pid, the device's


def _x(cat, name, ts, dur, pid=HOST, tid=7, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=pid, tid=tid, args=args)


def _trace_events():
    """outer [0, 100) > inner [10, 40) on thread 7: a launch inside inner
    (corr 1), one inside outer only (corr 2), one outside both (corr 3), one
    on thread 8 inside no range (corr 4), and a memcpy inside inner (corr 5)."""
    return [
        dict(ph="M", name="process_name", pid=DEV, args=dict(name="GPU 0")),
        _x("user_annotation", "outer", 0, 100),
        _x("user_annotation", "inner", 10, 30),
        _x("cpu_op", "aten::conv1d", 11, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 2, tid=8, correlation=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 30, 2, correlation=5),
        _x("gpu_user_annotation", "inner", 13, 300, pid=DEV, tid=9, correlation=1),
        _x("kernel", "void resunit_kernel<2, 4>(float const*)", 13, 1500, pid=DEV, tid=9,
           correlation=1),
        _x("kernel", "vq_search_kernel", 60, 250, pid=DEV, tid=9, correlation=2),
        _x("kernel", "vq_search_kernel", 160, 250, pid=DEV, tid=9, correlation=3),
        _x("kernel", "elementwise_kernel", 25, 1000, pid=DEV, tid=9, correlation=4),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 35, 500, pid=DEV, tid=10,
           correlation=5),
        dict(ph="s", id=1, pid=HOST, tid=7, ts=12, cat="ac2g", name="ac2g"),
    ]


def _write(d, events, name="host.1.1.pt.trace.json", gz=False):
    path = os.path.join(d, name + (".gz" if gz else ""))
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        json.dump(dict(traceEvents=events), f)
    return path


@pytest.mark.parametrize("gz", [False, True])
def test_aggregate_counts_device_events_once_by_name_and_range(tmp_path, gz):
    _write(tmp_path, _trace_events(), gz=gz)
    by_name, by_range, total = aggregate_device_trace(str(tmp_path), printout=False)
    assert dict(by_name) == {"void resunit_kernel<2, 4>(float const*)": 1.5,
                             "vq_search_kernel": 0.5, "elementwise_kernel": 1.0,
                             "Memcpy DtoH (Device -> Pinned)": 0.5}
    assert total == pytest.approx(3.5)  # no host op, launch row or range counted
    assert dict(by_range) == {"outer/inner": 2.0, "outer": 0.25, NO_ATTRIBUTION: 1.25}
    assert [name for name, _ in by_name[:2]] == ["void resunit_kernel<2, 4>(float const*)",
                                                 "elementwise_kernel"]  # the hottest first
    # the innermost range alone, at depth 1
    depth1 = dict(aggregate_device_trace(str(tmp_path), printout=False, group_depth=1)[1])
    assert depth1 == {"inner": 2.0, "outer": 0.25, NO_ATTRIBUTION: 1.25}


def test_aggregate_reads_the_newest_trace(tmp_path, capsys):
    _write(tmp_path, _trace_events(), name="a.1.1.pt.trace.json")
    time.sleep(0.01)
    newer = [_x("kernel", "vq_norm_kernel", 0, 2000, pid=DEV)]
    sub = tmp_path / "later"
    sub.mkdir()
    path = _write(sub, newer, name="b.1.2.pt.trace.json")
    os.utime(path, None)
    by_name, by_range, total = aggregate_device_trace(str(tmp_path))
    assert by_name == [("vq_norm_kernel", 2.0)] and by_range == [(NO_ATTRIBUTION, 2.0)]
    assert total == 2.0
    out = capsys.readouterr().out
    assert "top kernels by device time (total 2.0 ms)" in out and "vq_norm_kernel" in out


def test_aggregate_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        aggregate_device_trace(str(tmp_path))


def test_trace_and_annotate_write_a_trace_it_reads(tmp_path):
    with trace(str(tmp_path / "t")) as d:
        with annotate("outer"), annotate("inner"):
            y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(y[0, 0]) == 64.0
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= names
    # the CPU has no device: nothing to count, and nothing raises
    assert aggregate_device_trace(d, printout=False) == ([], [], 0.0)
    assert device_events(d) == []


def test_trace_makes_its_own_directory():
    with trace() as d:
        torch.zeros(3).sum()
    try:
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(d))
    finally:
        for f in os.listdir(d):
            os.unlink(os.path.join(d, f))
        os.rmdir(d)


def test_force_completion_reads_the_first_tensor():
    t = torch.tensor([[-1.0, 2.0], [3.0, -4.0]])
    assert force_completion({"a": [t, torch.ones(3)]}) == 10.0
    assert force_completion((None, "x")) == 0.0


def test_step_timer_percentiles_and_window(monkeypatch):
    clock = iter([0.0, 1.0, 10.0, 13.0, 20.0, 22.0, 30.0, 34.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer = StepTimer(window=3)
    assert np.isnan(timer.p50()) and np.isnan(timer.mean())
    for _ in range(4):
        with timer.step(torch.ones(2)) as box:
            box["result"] = torch.zeros(1)
    # the window keeps the last three steps: 3, 2 and 4 s
    assert timer.times == [3.0, 2.0, 4.0]
    assert timer.p50() == 3.0 and timer.mean() == 3.0
    assert timer.p99() == pytest.approx(np.percentile([3.0, 2.0, 4.0], 99))


def test_kind_of_the_kernels_of_the_port():
    names = {
        "void resunit_kernel<2, 4>(float const*, float const*, float*, Params)": RESUNIT_F32,
        "void resunit_bf16_kernel<128, 1, 64, false, 1>(CUtensorMap, CUtensorMap, Params)":
            RESUNIT_BF16,
        "void resunit_int8_kernel<128>(CUtensorMap, CUtensorMap, Params)": RESUNIT_INT8,
        "resunit_int8_amax(float const*, float const*, float const*, float*, int, int)":
            RESUNIT_INT8,
        "vq_norm_kernel(float const*, int, int, float4*, float4*, float*)": VQ,
        "vq_search_kernel(float const*, float4 const*, float4 const*, float const*)": VQ,
    }
    for name, kind in names.items():
        assert kind_of(name) == kind != "other"
    assert kind_of("some_unknown_kernel") == "other"
    # torch._int_mm's kernel on an H100 (the W8A8 convs), and a float32 GEMM's
    int_mm = ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>"
              "(cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16::Params)")
    assert kind_of(int_mm) == W8A8_GEMM
    assert kind_of("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3") == \
        "convolutions and GEMMs"
    assert len({k for k, _ in KINDS}) == len(KINDS)


def test_breakdown_by_kind():
    evs = [DeviceEvent("void resunit_kernel<2, 4>()", 2.0, "encode"),
           DeviceEvent("void resunit_kernel<2, 4>()", 1.0, "decode"),
           DeviceEvent("vq_search_kernel", 0.5, "quantize")]
    by_kind, by_name, count = breakdown(evs)
    assert by_kind == {RESUNIT_F32: 3.0, VQ: 0.5}
    assert count == {"void resunit_kernel<2, 4>()": 2, "vq_search_kernel": 1}
    assert by_name["vq_search_kernel"] == 0.5
