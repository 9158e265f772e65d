"""Tracing and timing (port of facodec_tpu/utils/profiling.py, on torch.profiler).

  * `trace(logdir)`: a context manager around `torch.profiler.profile`
    (CPU activity, and CUDA where torch sees a card) that writes a
    Chrome / Perfetto trace (`*.pt.trace.json`) into `logdir` when it ends;
  * `annotate(name)`: a named range in that trace
    (`torch.profiler.record_function`);
  * `force_completion(tensors)`: wait until the device has computed them
    and read one scalar;
  * `aggregate_device_trace(logdir)`: the device time of the newest trace,
    by kernel name and by the `annotate` range that launched each kernel;
  * `StepTimer`: a rolling wall-clock step timer with percentiles.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import socket
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

# Device-side event categories of a kineto trace: the kernels, and the
# copies and fills the stream runs between them. The device's projection of
# the annotation ranges ("gpu_user_annotation") spans kernels and is left
# out, as are the host's ops, runtime calls and ranges.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # the host calls that enqueue them
ANNOTATION_CAT = "user_annotation"
NO_ATTRIBUTION = "(no attribution)"


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[str]:
    """Trace the block; yields `logdir` (a new temporary directory where
    none is given), into which the trace is written when the block ends."""
    logdir = logdir or tempfile.mkdtemp(prefix="facodec_trace_")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Label a host-side region in the trace; the kernels it launches are
    attributed to it. Nothing while a program is being exported
    (utils/export.py), whose graph keeps no profiler ranges."""
    if torch.compiler.is_exporting():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def force_completion(tree: Any) -> float:
    """Wait until the device of the first tensor in `tree` (a tensor, or
    lists, tuples and dicts of them) has finished its queued work, then
    read one scalar of that tensor: executions on a stream are ordered, so
    one suffices. Returns the scalar (0.0 without a tensor)."""
    leaves = _tensors(tree)
    if not leaves:
        return 0.0
    x = leaves[0]
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.detach().float().abs().sum())


class DeviceEvent(NamedTuple):
    name: str
    ms: float
    attribution: str  # the enclosing `annotate` ranges, outermost first, "/"-joined


def newest_trace(logdir: str) -> str:
    files = [f for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for f in glob.glob(os.path.join(logdir, "**", pat), recursive=True)]
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    return max(files, key=os.path.getmtime)


def device_events(logdir: str, group_depth: int = 3) -> List[DeviceEvent]:
    """The device events of the newest trace under `logdir`, each attributed
    to the innermost `annotate` range that encloses the host call that
    launched it, shown with its enclosing ranges (the innermost
    `group_depth` of them, outermost first, "/"-joined): the launch is
    found through the trace's correlation id, and the ranges are those of
    its host thread. A kernel launched outside every range gets
    NO_ATTRIBUTION."""
    path = newest_trace(logdir)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        events = json.load(f).get("traceEvents", [])
    ranges: Dict[tuple, list] = defaultdict(list)
    launch_at: Dict[Any, tuple] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat == ANNOTATION_CAT:
            ranges[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", "?")))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_at[e["args"]["correlation"]] = (e.get("pid"), e.get("tid"), float(e["ts"]))

    def attribution(corr) -> str:
        if corr not in launch_at:
            return NO_ATTRIBUTION
        pid, tid, ts = launch_at[corr]
        inside = sorted((r for r in ranges[(pid, tid)] if r[0] <= ts <= r[1]),
                        key=lambda r: (r[0], -r[1]))
        if not inside:
            return NO_ATTRIBUTION
        return "/".join(r[2] for r in inside[-group_depth:])

    return [DeviceEvent(e.get("name", "?"), float(e.get("dur", 0)) / 1e3,
                        attribution(e.get("args", {}).get("correlation")))
            for e in device]


def aggregate_device_trace(logdir: str, top_k: int = 40, printout: bool = True,
                           group_depth: int = 3):
    """Aggregate the newest trace that `trace()` wrote under `logdir` by
    device kernel. Only device events are counted (DEVICE_CATS): the host's
    ops, its launch calls and the annotation ranges would count the same
    time twice. Two aggregations:
      * by kernel NAME: which kernel is hot;
      * by ATTRIBUTION: the innermost `annotate` range that launched each
        kernel, with its enclosing ranges (`device_events`): which part of
        the model is hot.
    Returns (by_name sorted [(name, ms)], by_attribution sorted, total_ms).
    Raises FileNotFoundError where `logdir` holds no trace."""
    by_name: Dict[str, float] = defaultdict(float)
    by_attr: Dict[str, float] = defaultdict(float)
    total = 0.0
    for ev in device_events(logdir, group_depth):
        by_name[ev.name] += ev.ms
        by_attr[ev.attribution] += ev.ms
        total += ev.ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    top_attr = sorted(by_attr.items(), key=lambda kv: -kv[1])
    if printout:
        print(f"\n== top kernels by device time (total {total:.1f} ms) ==")
        for name, ms in top[:top_k]:
            print(f"{ms:9.2f} ms  {100 * ms / max(total, 1e-9):5.1f}%  {name[:110]}")
        print("\n== by annotated range ==")
        for name, ms in top_attr[:top_k]:
            print(f"{ms:9.2f} ms  {100 * ms / max(total, 1e-9):5.1f}%  {name[:110]}")
    return top, top_attr, total


class StepTimer:
    """Rolling step timer: `with timer.step(result): ...` (or set
    `box["result"]` inside the block), then `timer.p50()`. The step ends
    once its result is computed (`force_completion`); the last `window`
    steps are kept."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self, result: Optional[Any] = None):
        t0 = time.perf_counter()
        box: Dict[str, Any] = {}
        yield box
        if "result" in box:
            force_completion(box["result"])
        elif result is not None:
            force_completion(result)
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    def p50(self) -> float:
        return float(np.percentile(self.times, 50)) if self.times else float("nan")

    def p99(self) -> float:
        return float(np.percentile(self.times, 99)) if self.times else float("nan")

    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")
