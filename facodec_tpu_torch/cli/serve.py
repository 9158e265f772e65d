"""HTTP inference server over the codec (port of facodec_tpu/cli/serve.py).

A dependency-free HTTP daemon (stdlib `http.server`) with the JAX
package's endpoints, status codes and wire formats:

  GET  /health            liveness, device, precision, batching counters
  GET  /metrics           Prometheus text: counters + per-op latency quantiles
  POST /reconstruct       WAV body        -> WAV   (codec round trip)
  POST /encode            WAV body        -> .fac  (factorized codes)
  POST /decode            .fac body       -> WAV   (?residual=0 drops r-codes)
  POST /convert           JSON {source_wav, target_wav} (base64 WAV)
                                          -> WAV   (zero-shot VC; 503 until
                                                    a redecoder is configured)

With --stream-port N a second TCP listener serves live duplex PCM streams
(cli/stream_serve.py), continuously batched.

Serving disciplines, as in the JAX package:
  * Length buckets: a request wave is zero-padded up to a multiple of
    --bucket-seconds, the timbre pools only its true length (masked
    `forward_v2`), codes and output are trimmed back to it.
  * Bounded memory: inputs past --stream-threshold-seconds go through the
    exact streaming route; every input is capped at --max-seconds, and a
    .fac claiming more frames is cut to that.
  * One device queue: device calls serialize on one lock.
  * Cross-request micro-batching: concurrent encode / reconstruct requests
    of one bucket that arrive within --batch-window-ms run as one device
    call, the batch padded to a power of two <= --max-batch.

The default precision is `hybrid`: a float32 encode (exact codes) and a
bf16-activation decode (ops/precision.py). The server runs on the card
unless given `--device cpu`.

With --artifact DIR (and --ckpt-path for the weights) it serves an AOT
export (`python -m facodec_tpu_torch export`, utils/export.py) through
`ArtifactService`: one pinned (batch, seconds) program per function, no
tracing at serving time.

With --shard-inference the codec (and redecoder) run batch-parallel over
every visible GPU (`FACodec.shard_inference`: one replica per card, each
stacked request batch split over them, rounded up to a multiple of the
replica count); live streams (--stream-port) stay on the first card, as in
the JAX package. An artifact (--artifact) is bound to the device it was
exported on, so --shard-inference with --artifact exits with an error.

Usage:
  python -m facodec_tpu_torch serve [--config-path cfg.yml] [--ckpt-path x.bin]
      [--port 8080] [--redecoder-config cfg.yml --redecoder-ckpt y.bin]
      [--precision hybrid] [--stream-port 8081] [--device cuda] [--shard-inference]
  python -m facodec_tpu_torch serve --artifact DIR --ckpt-path x.pth [--port 8080]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import collections
import dataclasses
import io
import json
import threading
import time

import numpy as np
import torch

SR = 24000
HOP = 300
MAX_BODY_BYTES = 64 * 1024 * 1024  # untrusted uploads (wav / .fac / JSON)


class _TooLarge(ValueError):
    """Request body over the serving cap (HTTP 413)."""


# ----------------------------------------------------------------- wav bytes


def read_wav_bytes(blob: bytes, sr: int = SR) -> np.ndarray:
    """WAV bytes -> mono float32 at `sr` (linear-resampled if needed)."""
    from scipy.io import wavfile

    file_sr, data = wavfile.read(io.BytesIO(blob))
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    elif data.dtype.kind == "u":
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if file_sr != sr:
        t = np.linspace(0.0, len(data) / file_sr, int(len(data) * sr / file_sr), endpoint=False)
        data = np.interp(t, np.arange(len(data)) / file_sr, data).astype(np.float32)
    return data


def write_wav_bytes(wave: np.ndarray, sr: int = SR) -> bytes:
    """The first row of `wave` as 16-bit PCM WAV bytes."""
    from scipy.io import wavfile

    wave = np.asarray(wave)
    if wave.ndim == 2:
        wave = wave[0]
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(wave, -1.0, 1.0) * 32767.0).astype(np.int16))
    return buf.getvalue()


# ------------------------------------------------------------------- service


class _MicroBatcher:
    """Stacks concurrent same-key submissions into one call to `run_batch`.

    `submit(key, payload)` blocks the calling (HTTP handler) thread until
    the worker thread has collected up to `max_batch` payloads of `key`
    (waiting `window_s` from the oldest for a burst to gather), run
    `run_batch(key, payloads)` once, and handed each payload its result."""

    def __init__(self, run_batch, window_s: float = 0.005, max_batch: int = 8):
        self._run = run_batch
        self.window_s = window_s
        self.max_batch = max_batch
        self._q = collections.defaultdict(collections.deque)
        self._cv = threading.Condition()
        self._stop = False
        self.calls = 0  # device calls issued
        self.max_seen = 0  # largest batch stacked
        self._worker = threading.Thread(target=self._loop, name="facodec-microbatch",
                                        daemon=True)
        self._worker.start()

    def submit(self, key, payload):
        item = {"payload": payload, "done": threading.Event(), "result": None,
                "error": None, "ts": time.monotonic()}
        with self._cv:
            if self._stop:
                raise RuntimeError("micro-batcher closed")
            self._q[key].append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _loop(self):
        while True:
            # FIFO by each queue's head age, so that a busy bucket does not
            # starve a sparse one; an item waits only what is left of its
            # window
            with self._cv:
                while not self._stop and not any(self._q.values()):
                    self._cv.wait()
                if self._stop:
                    for q in self._q.values():
                        for it in q:
                            it["error"] = RuntimeError("micro-batcher closed")
                            it["done"].set()
                    self._q.clear()
                    return
                key = min(self._q, key=lambda k: self._q[k][0]["ts"])
                head_ts = self._q[key][0]["ts"]
                ready = len(self._q[key])
            if ready < self.max_batch:
                remaining = self.window_s - (time.monotonic() - head_ts)
                if remaining > 0:
                    time.sleep(remaining)
            with self._cv:
                q = self._q.get(key)
                if not q:
                    continue
                items = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
                if not q:
                    del self._q[key]
            try:
                results = self._run(key, [it["payload"] for it in items])
                for it, r in zip(items, results):
                    it["result"] = r
            except Exception as e:  # noqa: BLE001 -- handed to every waiter
                for it in items:
                    it["error"] = e
            self.calls += 1
            self.max_seen = max(self.max_seen, len(items))
            for it in items:
                it["done"].set()

    def close(self):
        """Stop the worker; queued items fail with 'micro-batcher closed'."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()


class _Service:
    """What both services share: one device lock, the micro-batcher over
    `_run_batch`, and the request counters and latency windows that
    /health and /metrics read."""

    def __init__(self, max_batch: int, batch_window_ms: float):
        self.max_batch = max_batch
        self.lock = threading.Lock()
        self.started = time.time()
        self.requests = 0
        self.stream_port = None  # set when a live-stream server attaches
        self.streaming = None  # the StreamingService, for /metrics
        self._stats_lock = threading.Lock()
        self._lat = collections.defaultdict(lambda: collections.deque(maxlen=512))
        self._batcher = _MicroBatcher(self._run_batch, window_s=batch_window_ms / 1e3,
                                      max_batch=max_batch)

    def _count_request(self, op=None, t0=None):
        with self._stats_lock:
            self.requests += 1
            if op is not None:
                self._lat[op].append(time.perf_counter() - t0)

    def close(self) -> None:
        self._batcher.close()


def _device_name(dev: torch.device) -> str:
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return f"{dev.type}:{kind}"


class CodecService(_Service):
    """Bucketed, lock-serialized inference over a FACodec (and, for
    /convert, an FARedecoder). Independent of the HTTP layer."""

    def __init__(self, codec, redecoder=None, bucket_seconds: float = 1.0,
                 stream_threshold_seconds: float = 32.0, max_seconds: float = 120.0,
                 max_batch: int = 8, batch_window_ms: float = 5.0):
        self.codec = codec
        self.redecoder = redecoder
        self.bucket_frames = max(1, int(bucket_seconds * SR) // HOP)
        self.stream_threshold_frames = int(stream_threshold_seconds * SR) // HOP
        self.max_frames = int(max_seconds * SR) // HOP
        # a collected batch is padded up to a power of two, within the cap
        super().__init__(1 << (max(1, max_batch).bit_length() - 1), batch_window_ms)

    # -- shape management ----------------------------------------------------

    def _bucketed(self, wave: np.ndarray):
        """(T,) float32 -> (padded row (Tb,), true T, true frames)."""
        T = min(len(wave), self.max_frames * HOP) // HOP * HOP
        frames = T // HOP
        if frames == 0:
            raise ValueError(f"input shorter than one hop ({HOP} samples)")
        bf = self.bucket_frames
        frames_b = -(-frames // bf) * bf
        padded = np.zeros(frames_b * HOP, np.float32)
        padded[:T] = wave[:T]
        return padded, T, frames

    def _run_batch(self, key, payloads):
        """One device call for up to max_batch same-bucket requests: stack
        the padded rows, pad the batch to a power of two (zero rows of full
        length; over a sharded codec, then to a multiple of its replica
        count), run, split per request."""
        op, Tb = key
        n = len(payloads)
        nb = 1 << (n - 1).bit_length()
        if self.codec.replicas is not None:  # a whole share of rows per replica
            nd = len(self.codec.replicas)
            nb = -(-nb // nd) * nd
        waves = np.zeros((nb, Tb), np.float32)
        lens = np.full(nb, Tb, np.int64)
        for i, (row, T) in enumerate(payloads):
            waves[i] = row
            lens[i] = T
        dev = self.codec.device
        w, wl = torch.from_numpy(waves).to(dev), torch.from_numpy(lens).to(dev)
        with self.lock:
            if op == "reconstruct":
                out = self.codec.reconstruct_tensor(w, wave_lens=wl).cpu().numpy()
                return [out[i : i + 1] for i in range(n)]
            _, codes, timbre = self.codec.encode_tensor(w, wave_lens=wl)
            cp, cc, cr = (c.cpu().numpy() for c in codes)
            tm = timbre.cpu().numpy()
        return [(cp[i : i + 1], cc[i : i + 1], cr[i : i + 1], tm[i : i + 1]) for i in range(n)]

    # -- operations ----------------------------------------------------------

    def encode(self, wave: np.ndarray):
        """float wave -> FACodecFile (bucketed, or exact streaming)."""
        from facodec_tpu_torch.codec_file import FACodecFile

        t0 = time.perf_counter()
        frames = len(wave) // HOP
        if frames > self.stream_threshold_frames:
            with self.lock:
                return self.codec.encode_streaming(wave[: self.max_frames * HOP])
        row, T, true_frames = self._bucketed(np.asarray(wave, np.float32))
        cp, cc, cr, timbre = self._batcher.submit(("encode", len(row)), (row, T))
        cp, cc, cr = (c[..., :true_frames] for c in (cp, cc, cr))
        self._count_request("encode", t0)
        return FACodecFile(codes_p=cp.astype(np.uint16), codes_c=cc.astype(np.uint16),
                           codes_r=cr.astype(np.uint16), timbre=timbre, sample_rate=SR,
                           hop_length=HOP, original_length=true_frames * HOP)

    def decode(self, f, use_residual: bool = True) -> np.ndarray:
        t0 = time.perf_counter()
        frames = f.codes_p.shape[-1]
        if frames > self.max_frames:
            # the --max-seconds cap: a crafted .fac must not buy unbounded
            # decode compute or output
            f = dataclasses.replace(
                f, codes_p=f.codes_p[..., : self.max_frames],
                codes_c=f.codes_c[..., : self.max_frames],
                codes_r=None if f.codes_r is None else f.codes_r[..., : self.max_frames],
                original_length=min(f.original_length or 0, self.max_frames * HOP) or 0)
            frames = self.max_frames
        with self.lock:
            if frames > self.stream_threshold_frames:
                out = self.codec.decode_streaming(f, use_residual=use_residual)
            else:
                out = self.codec.decode(f, use_residual=use_residual)
        self._count_request("decode", t0)
        return out

    def reconstruct(self, wave: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        frames = len(wave) // HOP
        if frames > self.stream_threshold_frames:
            return self.decode(self.encode(wave))
        row, T, true_frames = self._bucketed(np.asarray(wave, np.float32))
        out = self._batcher.submit(("reconstruct", len(row)), (row, T))
        self._count_request("reconstruct", t0)
        return out[:, : true_frames * HOP]

    def convert(self, source: np.ndarray, target: np.ndarray) -> np.ndarray:
        """Zero-shot VC: the source's codes resynthesized in the target's
        timbre (from the bucketed masked encoder)."""
        if self.redecoder is None:
            raise RuntimeError("no redecoder configured (--redecoder-config)")
        t0 = time.perf_counter()
        f = self.encode(source)
        row, T, _ = self._bucketed(np.asarray(target, np.float32))
        _, _, _, timbre = self._batcher.submit(("encode", len(row)), (row, T))
        with self.lock:
            out = self.redecoder.resynthesize(f, timbre)
        self._count_request("convert", t0)
        return out

    def warmup(self) -> float:
        """Run the first bucket once (encode + decode); returns seconds."""
        t0 = time.time()
        self.reconstruct(np.zeros(self.bucket_frames * HOP, np.float32))
        return time.time() - t0

    def health(self) -> dict:
        return {
            "status": "ok",
            "device": _device_name(self.codec.device),
            "precision": self.codec.precision,
            "bucket_frames": self.bucket_frames,
            "sample_rate": SR,
            "vc_available": self.redecoder is not None,
            "uptime_s": round(time.time() - self.started, 1),
            "requests": self.requests,
            "max_batch": self.max_batch,
            "device_calls": self._batcher.calls,
            "max_batch_seen": self._batcher.max_seen,
            "stream_port": self.stream_port,
        }


class ArtifactService(_Service):
    """Serve from an AOT export (utils/export.py): no model code is traced
    at serving time, and the artifact pins ONE (batch, seconds) program per
    function. Requests zero-pad to the artifact's bucket (the masked
    functions pool the timbre over the true length) and micro-batch up to
    the artifact's batch, which is part of each program's signature, so
    every device call runs at exactly that batch. Codes and waves are
    trimmed back to the request.

    Not served from an artifact, as in the JAX package: inputs past the
    bucket (no streaming route), a decode without the residual stream, and
    voice conversion. `params` is the artifact's parameter dict, or a
    checkpoint path to read it from (`ExportedCodec.load_params`).
    Duck-types CodecService for the HTTP layer."""

    def __init__(self, artifact_dir: str, params, batch_window_ms: float = 5.0):
        from facodec_tpu_torch.utils.export import ExportedCodec

        self.exported = ExportedCodec(artifact_dir)
        m = self.exported.meta
        self.params = (self.exported.load_params(params) if isinstance(params, str)
                       else params)
        self.frames = int(m["frames"])
        self.precision = m["precision"]
        self.redecoder = None
        super().__init__(int(m["batch"]), batch_window_ms)

    def _bucketed(self, wave: np.ndarray):
        T = len(wave) // HOP * HOP
        frames = T // HOP
        if frames == 0:
            raise ValueError(f"input shorter than one hop ({HOP} samples)")
        if frames > self.frames:
            raise ValueError(f"input ({frames} frames) exceeds the artifact bucket "
                             f"({self.frames} frames); export a larger artifact")
        row = np.zeros(self.frames * HOP, np.float32)
        row[:T] = wave[:T]
        return row, T, frames

    def _run_batch(self, key, payloads):
        """One call of a masked function at the artifact's batch: the
        requests' rows, then zero rows of full length."""
        (op,) = key
        n = len(payloads)
        waves = np.zeros((self.max_batch, self.frames * HOP), np.float32)
        lens = np.full(self.max_batch, self.frames * HOP, np.int32)
        for i, (row, T) in enumerate(payloads):
            waves[i] = row
            lens[i] = T
        dev = self.exported.device
        w, wl = torch.from_numpy(waves).to(dev), torch.from_numpy(lens).to(dev)
        with self.lock:
            if op == "reconstruct":
                out = self.exported.reconstruct_masked(self.params, w, wl).cpu().numpy()
                return [out[i : i + 1] for i in range(n)]
            cp, cc, cr, tm = (t.cpu().numpy()
                              for t in self.exported.encode_masked(self.params, w, wl))
        return [(cp[i : i + 1], cc[i : i + 1], cr[i : i + 1], tm[i : i + 1]) for i in range(n)]

    def encode(self, wave: np.ndarray):
        from facodec_tpu_torch.codec_file import FACodecFile

        t0 = time.perf_counter()
        row, T, true_frames = self._bucketed(np.asarray(wave, np.float32))
        cp, cc, cr, timbre = self._batcher.submit(("encode",), (row, T))
        cp, cc, cr = (c[..., :true_frames] for c in (cp, cc, cr))
        self._count_request("encode", t0)
        return FACodecFile(codes_p=cp.astype(np.uint16), codes_c=cc.astype(np.uint16),
                           codes_r=cr.astype(np.uint16), timbre=timbre, sample_rate=SR,
                           hop_length=HOP, original_length=true_frames * HOP)

    def decode(self, f, use_residual: bool = True) -> np.ndarray:
        t0 = time.perf_counter()
        if not use_residual or f.codes_r is None:
            raise ValueError("the exported decode signature requires residual codes")
        B, frames = f.codes_p.shape[0], f.codes_p.shape[-1]
        if frames > self.frames or B > self.max_batch:
            raise ValueError(f"codes ({B}x{frames}) exceed the artifact signature "
                             f"({self.max_batch}x{self.frames})")
        dev = self.exported.device

        def pad(c):
            full = np.zeros((self.max_batch, c.shape[1], self.frames), np.int32)
            full[:B, :, :frames] = c
            return torch.from_numpy(full).to(dev)

        tm = np.zeros((self.max_batch, f.timbre.shape[-1]), np.float32)
        tm[:B] = f.timbre
        with self.lock:
            wave = self.exported.decode(self.params, pad(f.codes_p), pad(f.codes_c),
                                        pad(f.codes_r), torch.from_numpy(tm).to(dev))
            wave = wave.cpu().numpy()
        self._count_request("decode", t0)
        # causal decoder: the zero-padded tail frames cannot reach the kept prefix
        return wave[:B, : (f.original_length or frames * HOP)]

    def reconstruct(self, wave: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        row, T, true_frames = self._bucketed(np.asarray(wave, np.float32))
        out = self._batcher.submit(("reconstruct",), (row, T))
        self._count_request("reconstruct", t0)
        return out[:, : true_frames * HOP]

    def convert(self, source, target):
        raise RuntimeError("VC is not available when serving from an artifact (serve with "
                           "--config-path / --redecoder-config instead)")

    def warmup(self) -> float:
        """Run the bucket once (reconstruct); returns seconds."""
        t0 = time.time()
        self.reconstruct(np.zeros(self.frames * HOP, np.float32))
        return time.time() - t0

    def health(self) -> dict:
        return {
            "status": "ok",
            "device": _device_name(self.exported.device),
            "precision": self.precision,
            "artifact": True,
            "bucket_frames": self.frames,
            "sample_rate": SR,
            "vc_available": False,
            "uptime_s": round(time.time() - self.started, 1),
            "requests": self.requests,
            "max_batch": self.max_batch,
            "device_calls": self._batcher.calls,
            "max_batch_seen": self._batcher.max_seen,
        }


def render_metrics(service) -> str:
    """Prometheus text: request and device-call counters, and per-op
    latency quantiles over a 512-sample sliding window (CodecService and
    ArtifactService alike; an artifact's adds `facodec_artifact 1`)."""
    h = service.health()
    lines = [
        "# TYPE facodec_requests_total counter",
        f"facodec_requests_total {h['requests']}",
        "# TYPE facodec_device_calls_total counter",
        f"facodec_device_calls_total {h['device_calls']}",
        "# TYPE facodec_max_batch_seen gauge",
        f"facodec_max_batch_seen {h['max_batch_seen']}",
        "# TYPE facodec_uptime_seconds gauge",
        f"facodec_uptime_seconds {h['uptime_s']}",
    ]
    if h.get("artifact"):
        lines += ["# TYPE facodec_artifact gauge", "facodec_artifact 1"]
    lines.append("# TYPE facodec_request_latency_seconds summary")
    with service._stats_lock:
        snap = {op: list(d) for op, d in service._lat.items()}
    for op, xs in sorted(snap.items()):
        for q in (0.5, 0.9, 0.99):
            v = float(np.quantile(np.asarray(xs), q))
            lines.append(f'facodec_request_latency_seconds{{op="{op}",quantile="{q}"}} {v:.6f}')
        lines.append(f'facodec_request_latency_seconds_count{{op="{op}"}} {len(xs)}')
    streaming = getattr(service, "streaming", None)
    if streaming is not None and streaming.group_stats():
        lines += [
            "# TYPE facodec_stream_ticks_total counter",
            "# TYPE facodec_stream_tick_max_stacked gauge",
            "# TYPE facodec_stream_active_slots gauge",
            "# TYPE facodec_stream_group_capacity gauge",
        ]
        for C, g in sorted(streaming.group_stats().items()):
            lab = f'{{chunk_frames="{C}"}}'
            lines += [
                f"facodec_stream_ticks_total{lab} {g['ticks']}",
                f"facodec_stream_tick_max_stacked{lab} {g['max_stacked']}",
                f"facodec_stream_active_slots{lab} {g['active_slots']}",
                f"facodec_stream_group_capacity{lab} {g['capacity']}",
            ]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------- http


def make_handler(service: CodecService):
    from http.server import BaseHTTPRequestHandler

    from facodec_tpu_torch.codec_file import FACodecFile

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            if n > MAX_BODY_BYTES:
                raise _TooLarge(f"request body {n} bytes exceeds {MAX_BODY_BYTES}")
            return self.rfile.read(n)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/health":
                return self._json(200, service.health())
            if path == "/metrics":
                return self._send(200, render_metrics(service).encode(),
                                  "text/plain; version=0.0.4")
            return self._json(404, {"error": "unknown path"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            try:
                if path == "/reconstruct":
                    out = service.reconstruct(read_wav_bytes(self._body()))
                    return self._send(200, write_wav_bytes(out), "audio/wav")
                if path == "/encode":
                    blob = service.encode(read_wav_bytes(self._body())).to_bytes()
                    return self._send(200, blob, "application/octet-stream")
                if path == "/decode":
                    f = FACodecFile.from_bytes(self._body())
                    out = service.decode(f, use_residual="residual=0" not in query)
                    return self._send(200, write_wav_bytes(out), "audio/wav")
                if path == "/convert":
                    req = json.loads(self._body())
                    src = read_wav_bytes(base64.b64decode(req["source_wav"]))
                    tgt = read_wav_bytes(base64.b64decode(req["target_wav"]))
                    try:
                        out = service.convert(src, tgt)
                    except RuntimeError as e:
                        return self._json(503, {"error": str(e)})
                    return self._send(200, write_wav_bytes(out), "audio/wav")
                return self._json(404, {"error": "unknown path"})
            except _TooLarge as e:
                return self._json(413, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 -- serving boundary
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(service: CodecService, host: str = "127.0.0.1", port: int = 0):
    """Build (not start) the threading HTTP server; port 0 = ephemeral."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer((host, port), make_handler(service))


# ----------------------------------------------------------------------- cli


def add_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    from facodec_tpu_torch.cli import add_device_arg

    p.add_argument("--config-path", default=None,
                   help="reference-schema config.yml (needs pyyaml); default: the "
                        "published FLAGSHIP fields")
    p.add_argument("--ckpt-path", default=None)
    p.add_argument("--artifact", default=None,
                   help="serve an AOT export dir (python -m facodec_tpu_torch export): no "
                        "model tracing at serving time; requires --ckpt-path for the "
                        "weights, and --device the artifact's")
    p.add_argument("--redecoder-config", default=None, help="enable /convert")
    p.add_argument("--redecoder-ckpt", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--precision", default="hybrid",
                   choices=["float32", "hybrid", "bfloat16", "bfloat16_act"],
                   help="bfloat16 is not ported yet (ROADMAP item 6)")
    p.add_argument("--bucket-seconds", type=float, default=1.0)
    p.add_argument("--stream-threshold-seconds", type=float, default=32.0)
    p.add_argument("--max-seconds", type=float, default=120.0)
    p.add_argument("--max-batch", type=int, default=8,
                   help="cross-request micro-batch cap (rounded down to a power of two; "
                        "1 disables batching)")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="how long a request waits for same-bucket peers")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--shard-inference", action="store_true",
                   help="batch-parallel one-shot inference over every visible GPU (one "
                        "replica per card, request batches split over them); live streams "
                        "stay on the first card")
    p.add_argument("--stream-port", type=int, default=None,
                   help="also serve live duplex PCM streams on this TCP port "
                        "(cli/stream_serve.py)")
    p.add_argument("--stream-group-capacity", type=int, default=8,
                   help="continuous-batching slots per chunk size (0 = every stream "
                        "gets a dedicated batch-1 session)")
    p.add_argument("--stream-group-window-ms", type=float, default=5.0,
                   help="how long a tick waits, from its oldest pending chunk, for "
                        "peer streams")
    p.add_argument("--stream-idle-timeout", type=float, default=300.0,
                   help="drop live-stream connections silent this many seconds")
    add_device_arg(p)
    return p


def main(args) -> int:
    from facodec_tpu_torch.cli import load_codec, load_redecoder
    from facodec_tpu_torch.parallel.mesh import make_devices

    if args.artifact:
        if args.shard_inference:
            raise SystemExit("serve: --shard-inference does not apply to --artifact: an "
                             "exported program runs on the one device it was exported on; "
                             "serve the live model (--config-path / the FLAGSHIP fields) to "
                             "shard")
        return _serve_artifact(args)
    devices = make_devices() if args.shard_inference else None  # before any model is built
    codec = load_codec(args.config_path, args.ckpt_path, 2, args.device, args.precision)
    redecoder = (load_redecoder(args.redecoder_config, args.redecoder_ckpt, args.device)
                 if args.redecoder_config else None)
    if devices:
        codec.shard_inference(devices)
        if redecoder is not None:
            redecoder.shard_inference(devices)
        print(f"sharded one-shot inference over {len(devices)} devices", flush=True)
    service = CodecService(codec, redecoder, bucket_seconds=args.bucket_seconds,
                           stream_threshold_seconds=args.stream_threshold_seconds,
                           max_seconds=args.max_seconds, max_batch=args.max_batch,
                           batch_window_ms=args.batch_window_ms)
    if not args.no_warmup:
        print(f"warmup: first bucket ({service.bucket_frames} frames)...", flush=True)
        print(f"warmup done in {service.warmup():.1f}s", flush=True)
    server = make_server(service, args.host, args.port)
    stream_server = None
    if args.stream_port is not None:
        from facodec_tpu_torch.cli.stream_serve import StreamingService, make_stream_server

        stream_server = make_stream_server(
            StreamingService(service, group_capacity=args.stream_group_capacity,
                             group_window_ms=args.stream_group_window_ms),
            args.host, args.stream_port, idle_timeout_s=args.stream_idle_timeout)
        service.stream_port = stream_server.server_address[1]
        threading.Thread(target=stream_server.serve_forever, daemon=True,
                         name="facodec-stream-serve").start()
        print(f"facodec_tpu_torch live-streaming on tcp://{args.host}:{service.stream_port}",
              flush=True)
    print(f"facodec_tpu_torch serving on http://{args.host}:{server.server_address[1]}",
          flush=True)
    _serve(server, service, stream_server)
    return 0


def _serve_artifact(args) -> int:
    from facodec_tpu_torch.utils.export import read_meta

    if not args.ckpt_path:
        print("--artifact requires --ckpt-path (the weights)")
        return 2
    device = torch.device(read_meta(args.artifact)["device"])
    if torch.device(args.device).type != device.type:
        raise SystemExit(f"serve: the artifact was exported on {device}, and runs there "
                         f"only (--device {device.type})")
    service = ArtifactService(args.artifact, args.ckpt_path,
                              batch_window_ms=args.batch_window_ms)
    if not args.no_warmup:
        print(f"warmup: the artifact's bucket ({service.frames} frames)...", flush=True)
        print(f"warmup done in {service.warmup():.1f}s", flush=True)
    server = make_server(service, args.host, args.port)
    print(f"facodec_tpu_torch serving artifact on http://{args.host}:"
          f"{server.server_address[1]}", flush=True)
    _serve(server, service)
    return 0


def _serve(server, service, stream_server=None) -> None:
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if stream_server is not None:
            stream_server.shutdown()
            stream_server.server_close()
        service.close()
