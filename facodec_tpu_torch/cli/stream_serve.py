"""Live duplex streaming server (port of facodec_tpu/cli/stream_serve.py).

A TCP server that runs the exact streaming session
(models/streaming.StreamingFACodec) for each connection: a client pushes
PCM chunks and receives the reconstructed (or timbre-converted) audio one
chunk later. The protocol is the JAX package's, byte for byte, so either
package's client talks to either server.

Protocol (little-endian; audio is float32 PCM mono at 24 kHz):

  client -> server   one JSON header line ending in "\\n":
                       {"chunk_frames": 4,            # latent frames/chunk
                        "timbre_wav": "<base64 WAV>", # optional VC target
                        "vc_mode": "redecoder"}       # optional: VC through
                                                      # the redecoder
  server -> client   one JSON status line:
                       {"status": "ok", "chunk_frames": C,
                        "prime_samples": P, "sample_rate": 24000, "vc": bool}
                     (or {"status": "error", "error": ...} and close)
  client -> server   frames <u32 byte length><f32le PCM>; a zero-length
                     frame ends the stream
  server -> client   frames of output PCM as chunks are emitted (nothing
                     until the priming span has arrived), then the flush
                     frame, then a zero-length frame

Semantics:
  * With "timbre_wav", every chunk decodes under the target utterance's
    timbre (from the service's bucketed masked encoder). Without it, the
    timbre is estimated from the stream's own priming prefix.
  * "vc_mode": "redecoder" (needs "timbre_wav" and a server with a
    redecoder): source codes from the streaming encoder, re-chunked into a
    StreamingRedecoder under the target timbre; equal to one-shot
    `FARedecoder.resynthesize` on the one-shot codes.
  * Client frames may have any size; the server re-chunks. Input that is a
    whole number of chunks gives exactly the interactive session loop's
    output; otherwise the tail is zero-padded to a chunk and the output cut
    to the input's frames (exact, as every model on the path is causal).
    Streams shorter than the priming span are zero-padded up to it.

Continuous batching: concurrent connections of one chunk size join slots of
a `models/stream_batch.BatchedStreamGroup`, and a tick dispatcher advances
every slot with a pending chunk in one masked batched step. Streams beyond
the group's capacity get a dedicated batch-1 session. Device calls
serialize on the CodecService's lock; per-chunk or per-tick latency lands
in its /metrics window as op="stream_chunk". Streams run in float32 under
every codec precision, as the JAX package's sessions do.
"""

from __future__ import annotations

import base64
import collections
import json
import socketserver
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

SR = 24000
HOP = 300
MAX_HEADER_BYTES = 32 * 1024 * 1024  # a base64 timbre wav rides in the header
MAX_FRAME_BYTES = 16 * 1024 * 1024
MAX_CHUNK_FRAMES = 64


# ---------------------------------------------------------------- framing


def read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = rfile.read(n - len(buf))
        if not part:
            raise ConnectionError("peer closed mid-frame")
        buf += part
    return buf


def read_frame(rfile) -> Optional[np.ndarray]:
    """One <u32 len><f32le PCM> frame; None is the end-of-stream marker."""
    (n,) = struct.unpack("<I", read_exact(rfile, 4))
    if n == 0:
        return None
    if n > MAX_FRAME_BYTES or n % 4:
        raise ValueError(f"bad frame length {n}")
    return np.frombuffer(read_exact(rfile, n), np.float32)


def write_frame(wfile, wave: Optional[np.ndarray]) -> None:
    if wave is None:
        wfile.write(struct.pack("<I", 0))
        return
    payload = np.ascontiguousarray(wave, np.float32).tobytes()
    wfile.write(struct.pack("<I", len(payload)) + payload)


# ---------------------------------------------------------------- service


class _GroupDispatcher:
    """Tick scheduler over a BatchedStreamGroup: connection threads
    `submit(slot, chunk)` and block; a worker takes at most one pending
    chunk per slot, advances the whole group in one step and hands out the
    outputs. A tick waits for peers until every active slot has a chunk
    pending, or until `window_s` has passed since the later of the oldest
    pending chunk's arrival and the previous tick's hand-out, whichever
    comes first. The JAX package's dispatcher waits out `window_s` from the
    oldest pending chunk only: streams that sent their next chunk while a
    tick ran have waited longer than that by its end, so the next tick fires
    at once, without the streams it just answered, and N streams settle
    into ticks of N / 2 that alternate. join and flush serialize with ticks
    on the group lock."""

    def __init__(self, svc, group, window_s: float = 0.005):
        self.svc = svc  # the CodecService: device lock and /metrics stats
        self.group = group
        self.window_s = window_s
        self._glock = threading.Lock()  # group-state mutations
        self._cv = threading.Condition()
        self._pending: Dict[int, collections.deque] = {}
        self._stop = False
        self.ticks = 0
        self.max_stacked = 0  # most slots advanced by one tick
        self.tick_s: collections.deque = collections.deque(maxlen=4096)  # (seconds, slots)
        self._handed_out = 0.0  # when the previous tick's outputs were handed out
        threading.Thread(target=self._loop, name="facodec-stream-ticks", daemon=True).start()

    def try_join(self, prime_wave, timbre):
        """(slot, first emission), or None when the group is full."""
        with self._glock:
            if self.group.free_slots() == 0:
                return None
            with self.svc.lock:
                slot, first, _ = self.group.join(prime_wave, timbre)
        return slot, first

    def submit(self, slot: int, chunk: np.ndarray) -> np.ndarray:
        item = {"chunk": chunk, "done": threading.Event(), "result": None, "error": None,
                "ts": time.monotonic()}
        with self._cv:
            if self._stop:
                raise RuntimeError("stream dispatcher closed")
            self._pending.setdefault(slot, collections.deque()).append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def finish(self, slot: int) -> np.ndarray:
        """Flush the slot's final frame and free the slot."""
        with self._glock:
            with self.svc.lock:
                wave = self.group.flush(slot)
            self.group.leave(slot)
        return wave

    def release(self, slot: int) -> None:
        with self._glock:
            self.group.leave(slot)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def _loop(self):
        while True:
            with self._cv:
                while not self._stop and not any(self._pending.values()):
                    self._cv.wait()
                if not self._stop:
                    oldest = min(q[0]["ts"] for q in self._pending.values() if q)
                    deadline = max(oldest, self._handed_out) + self.window_s
                while not self._stop:
                    waiting = sum(1 for q in self._pending.values() if q)
                    remaining = deadline - time.monotonic()
                    if waiting >= self.group.capacity - self.group.free_slots() or remaining <= 0:
                        break
                    self._cv.wait(remaining)
                if self._stop:  # queued chunks fail instead of hanging their streams
                    for q in self._pending.values():
                        for it in q:
                            it["error"] = RuntimeError("stream dispatcher closed")
                            it["done"].set()
                    self._pending.clear()
                    return
                batch = {}
                for slot, q in list(self._pending.items()):
                    if q:
                        batch[slot] = q.popleft()
                    if not q:
                        del self._pending[slot]
            if not batch:
                continue
            t0 = time.perf_counter()
            try:
                with self._glock, self.svc.lock:
                    outs = self.group.tick({s: it["chunk"] for s, it in batch.items()})
                for slot, it in batch.items():
                    it["result"] = outs[slot]
            except Exception as e:  # noqa: BLE001 -- handed to every waiter
                for it in batch.values():
                    it["error"] = e
            dt = time.perf_counter() - t0
            with self.svc._stats_lock:
                self.svc._lat["stream_chunk"].append(dt)
            self.tick_s.append((dt, len(batch)))
            self.ticks += 1
            self.max_stacked = max(self.max_stacked, len(batch))
            for it in batch.values():
                it["done"].set()
            self._handed_out = time.monotonic()


class _ConnEngine:
    """Per-connection engine: buffers the priming span, then runs in a group
    slot (one shared step per tick) or, when the group is full or disabled,
    a dedicated batch-1 session."""

    def __init__(self, streaming: "StreamingService", chunk_frames: int):
        self.streaming = streaming
        self.sess = streaming.session(chunk_frames)
        self.device = streaming.device
        self._buffered = []
        self.mode = None  # None (priming) | "group" | "solo" | "done"
        self._slot = None
        self._est = None
        self._dst = None

    @property
    def primed(self) -> bool:
        return self.mode is not None

    def _solo_step(self, wave: torch.Tensor, timbre) -> np.ndarray:
        t0 = time.perf_counter()
        with self.streaming.service.lock:
            self._est, self._dst, out, _ = self.sess.roundtrip_chunk(self._est, self._dst,
                                                                     wave, timbre)
            out = out.cpu().numpy()[0]
        self.streaming._record_chunk(time.perf_counter() - t0)
        return out

    def feed(self, chunk: np.ndarray, timbre) -> Optional[np.ndarray]:
        """chunk: exactly chunk_frames * HOP samples. Returns the emitted wave
        ((T,) numpy), or None while priming. `timbre` must be set by the
        time the priming span is complete."""
        sess = self.sess
        if self.mode is None:
            self._buffered.append(chunk)
            if sum(len(c) for c in self._buffered) < sess.prime_frames * HOP:
                return None
            prime = torch.from_numpy(np.concatenate(self._buffered))[None].to(self.device)
            self._buffered = []
            disp = self.streaming.dispatcher(sess.chunk_frames)
            if disp is not None:
                joined = disp.try_join(prime, timbre)
                if joined is not None:
                    self._slot, first = joined
                    self.mode = "group"
                    return first.cpu().numpy()[0]
            # the group is full or disabled: a dedicated session
            self.mode = "solo"
            self._est = sess.init_encode_state(1)
            self._dst = sess.init_decode_state(1)
            return self._solo_step(prime, timbre)
        if self.mode == "group":
            return self.streaming.dispatcher(sess.chunk_frames).submit(self._slot, chunk)
        return self._solo_step(torch.from_numpy(chunk)[None].to(self.device), timbre)

    def finish(self, timbre) -> Optional[np.ndarray]:
        """The final (end-reflect) frame, (HOP,) numpy, or None if never
        primed. Frees any group slot."""
        if self.mode == "group":
            wave = self.streaming.dispatcher(self.sess.chunk_frames).finish(self._slot)
            self._slot = None
            self.mode = "done"
            return wave
        if self.mode == "solo":
            with self.streaming.service.lock:
                outs_t, _ = self.sess.flush_encode(self._est, timbre)
                self._dst, wave_t = self.sess.decode_chunk(self._dst, outs_t)
                wave_t = wave_t.cpu().numpy()[0]
            self.mode = "done"
            return wave_t
        return None

    def close(self) -> None:
        """Idempotent slot release: after `finish` a no-op; for a peer that
        vanished mid-stream it frees the group slot without a flush."""
        if self.mode == "group" and self._slot is not None:
            self.streaming.dispatcher(self.sess.chunk_frames).release(self._slot)
            self._slot = None
        self.mode = "done"

    def needs_tail(self, emitted: int, target: int) -> bool:
        """Zero chunks are fed until only the flush frame remains (emission
        is frame-synchronous with the input)."""
        return emitted + HOP < target


class _RedecoderVCEngine:
    """Live VC through the redecoder: source chunks -> the streaming codec
    encoder (codes equal to one-shot) -> a host-side code FIFO cut into
    chunk_frames slices -> StreamingRedecoder under the target timbre.
    Runs as a dedicated batch-1 session (redecoder streams do not join the
    codec's group)."""

    def __init__(self, streaming: "StreamingService", chunk_frames: int,
                 use_p_code: bool = False):
        self.streaming = streaming
        self.device = streaming.device
        self.sess = streaming.session(chunk_frames)
        self.red = streaming.redecoder_session(chunk_frames, use_p_code)
        self._est = self.sess.init_encode_state(1)
        self._rst = self.red.init_state(1)
        self._cp: Optional[np.ndarray] = None  # pending (1, n_p, t) codes
        self._cc: Optional[np.ndarray] = None  # pending (1, n_cc, t) codes

    @property
    def primed(self) -> bool:
        return self._est.primed

    def needs_tail(self, emitted: int, target: int) -> bool:
        return False  # finish() drains what is pending

    def _push(self, codes) -> None:
        cp = codes[0].cpu().numpy().astype(np.int32)
        cc = codes[1].cpu().numpy().astype(np.int32)
        self._cp = cp if self._cp is None else np.concatenate([self._cp, cp], axis=-1)
        self._cc = cc if self._cc is None else np.concatenate([self._cc, cc], axis=-1)

    def _vc_slice(self, cp: np.ndarray, cc: np.ndarray, timbre):
        t0 = time.perf_counter()
        with self.streaming.service.lock:
            self._rst, wave = self.red.vc_chunk(
                self._rst, torch.from_numpy(cp).to(self.device),
                torch.from_numpy(cc).to(self.device), timbre)
            wave = None if wave is None else wave.cpu().numpy()[0]
        if wave is not None:
            self.streaming._record_chunk(time.perf_counter() - t0)
        return wave

    def _drain(self, timbre) -> list:
        """Feed every whole chunk_frames code slice; the emitted waves."""
        C = self.sess.chunk_frames
        parts = []
        while self._cp is not None and self._cp.shape[-1] >= C:
            cp, self._cp = self._cp[..., :C], self._cp[..., C:]
            cc, self._cc = self._cc[..., :C], self._cc[..., C:]
            wave = self._vc_slice(cp, cc, timbre)
            if wave is not None:
                parts.append(wave)
        return parts

    def feed(self, chunk: np.ndarray, timbre) -> Optional[np.ndarray]:
        t0 = time.perf_counter()
        with self.streaming.service.lock:
            self._est, _, codes = self.sess.encode_chunk(
                self._est, torch.from_numpy(chunk)[None].to(self.device), timbre)
        if codes is None:
            return None
        self.streaming._record_chunk(time.perf_counter() - t0)
        self._push(codes)
        parts = self._drain(timbre)
        return np.concatenate(parts) if parts else None

    def finish(self, timbre) -> Optional[np.ndarray]:
        """Flush the encoder's final frame, zero-pad the code FIFO to a chunk
        (causal: padded frames cannot change the kept samples; the caller
        trims) and feed zero chunks until the redecoder has primed and
        drained."""
        with self.streaming.service.lock:
            _, codes_t = self.sess.flush_encode(self._est, timbre)
        self._push(codes_t)
        C = self.sess.chunk_frames
        pad = -self._cp.shape[-1] % C
        if pad:
            self._cp = np.concatenate(
                [self._cp, np.zeros(self._cp.shape[:-1] + (pad,), np.int32)], axis=-1)
            self._cc = np.concatenate(
                [self._cc, np.zeros(self._cc.shape[:-1] + (pad,), np.int32)], axis=-1)
        parts = self._drain(timbre)
        guard = self.red.prime_frames // C + 2
        while not self._rst.primed and guard:  # a very short stream: prime it
            guard -= 1
            wave = self._vc_slice(np.zeros((1, self._cp.shape[1], C), np.int32),
                                  np.zeros((1, self._cc.shape[1], C), np.int32), timbre)
            if wave is not None:
                parts.append(wave)
        return np.concatenate(parts) if parts else None

    def close(self) -> None:
        pass  # a dedicated session holds no shared slot


class StreamingService:
    """Session factory and timbre plumbing over a CodecService: the cached
    StreamingFACodec sessions and, when group_capacity >= 1, one
    BatchedStreamGroup per chunk size; it shares the CodecService's codec,
    device lock, masked encoder (for timbre vectors) and /metrics."""

    def __init__(self, service, group_capacity: int = 8, group_window_ms: float = 5.0):
        self.service = service
        self.device = service.codec.device
        self.group_capacity = group_capacity
        self.group_window_s = group_window_ms / 1e3
        self._sessions: Dict = {}
        self._dispatchers: Dict[int, Optional[_GroupDispatcher]] = {}
        self._cache_lock = threading.Lock()
        service.streaming = self  # /metrics reads the group gauges

    def group_stats(self) -> Dict[int, dict]:
        """Per-chunk-size continuous-batching stats for /metrics."""
        with self._cache_lock:
            disps = dict(self._dispatchers)
        return {C: {"ticks": d.ticks, "max_stacked": d.max_stacked,
                    "active_slots": d.group.capacity - d.group.free_slots(),
                    "capacity": d.group.capacity}
                for C, d in disps.items() if d is not None}

    def dispatcher(self, chunk_frames: int) -> Optional[_GroupDispatcher]:
        """The shared tick dispatcher of this chunk size (None when grouping
        is off)."""
        if self.group_capacity < 1:
            return None
        with self._cache_lock:
            disp = self._dispatchers.get(chunk_frames)
        if disp is None:
            from facodec_tpu_torch.models.stream_batch import BatchedStreamGroup

            sess = self.session(chunk_frames)
            with self._cache_lock:
                disp = self._dispatchers.get(chunk_frames)
                if disp is None:
                    disp = _GroupDispatcher(self.service,
                                            BatchedStreamGroup(sess, self.group_capacity),
                                            window_s=self.group_window_s)
                    self._dispatchers[chunk_frames] = disp
        return disp

    def session(self, chunk_frames: int):
        from facodec_tpu_torch.models.streaming import StreamingFACodec

        with self._cache_lock:
            sess = self._sessions.get(chunk_frames)
            if sess is None:
                codec = self.service.codec
                sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder,
                                        chunk_frames=chunk_frames, n_c=codec.n_c)
                self._sessions[chunk_frames] = sess
            return sess

    def redecoder_session(self, chunk_frames: int, use_p_code: bool = False):
        """Cached StreamingRedecoder over the service's FARedecoder; raises
        when none is configured or it is not causal."""
        from facodec_tpu_torch.models.streaming import StreamingRedecoder

        red = self.service.redecoder
        if red is None:
            raise ValueError("redecoder VC requires --redecoder-config on the server")
        key = ("redecoder", chunk_frames, use_p_code)
        with self._cache_lock:
            sess = self._sessions.get(key)
            if sess is None:
                # n_c = 1, as the one-shot /convert endpoint
                sess = StreamingRedecoder(red.encoder, red.decoder, chunk_frames=chunk_frames,
                                          use_p_code=use_p_code, n_c=1)
                self._sessions[key] = sess
            return sess

    def timbre_from_wave(self, wave: np.ndarray) -> np.ndarray:
        """(1, d) timbre through the service's bucketed masked encoder."""
        return self.service.encode(wave).timbre

    def _timbre_tensor(self, wave: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self.timbre_from_wave(wave), np.float32)
                                ).to(self.device)

    def _record_chunk(self, dt: float) -> None:
        with self.service._stats_lock:
            self.service._lat["stream_chunk"].append(dt)

    def close(self) -> None:
        with self._cache_lock:
            disps = list(self._dispatchers.values())
        for d in disps:
            if d is not None:
                d.close()

    # ------------------------------------------------------------ one stream
    def run_connection(self, rfile, wfile) -> None:
        """One whole protocol exchange on an open socket pair."""
        try:
            header = json.loads(rfile.readline(MAX_HEADER_BYTES))
            C = int(header.get("chunk_frames", 4))
            if not 1 <= C <= MAX_CHUNK_FRAMES:
                raise ValueError(f"chunk_frames must be in [1, {MAX_CHUNK_FRAMES}]")
            vc_mode = header.get("vc_mode")
            if vc_mode not in (None, "timbre_swap", "redecoder"):
                raise ValueError(f"unknown vc_mode {vc_mode!r}")
            timbre = None
            if header.get("timbre_wav"):
                from facodec_tpu_torch.cli.serve import read_wav_bytes

                timbre = self._timbre_tensor(
                    read_wav_bytes(base64.b64decode(header["timbre_wav"])))
            sess = self.session(C)
            if vc_mode == "redecoder":
                if timbre is None:
                    raise ValueError("vc_mode=redecoder requires timbre_wav")
                engine = _RedecoderVCEngine(self, C,
                                            use_p_code=bool(header.get("use_p_code", False)))
            else:
                engine = _ConnEngine(self, C)
        except Exception as e:  # noqa: BLE001 -- protocol boundary
            wfile.write(json.dumps({"status": "error",
                                    "error": f"{type(e).__name__}: {e}"}).encode() + b"\n")
            return
        status = {"status": "ok", "chunk_frames": C, "prime_samples": sess.prime_frames * HOP,
                  "sample_rate": SR, "vc": timbre is not None}
        if vc_mode == "redecoder":
            status["vc_mode"] = "redecoder"
            status["redecoder_prime_frames"] = engine.red.prime_frames
        wfile.write(json.dumps(status).encode() + b"\n")
        wfile.flush()

        step = C * HOP
        max_samples = self.service.max_frames * HOP
        buf = np.zeros(0, np.float32)
        prefix_fed = []  # chunks fed before the timbre exists (self-timbre)
        accepted = 0  # samples accepted into the stream (capped)
        emitted = 0  # samples written back

        def target_out() -> int:
            return accepted // HOP * HOP

        def emit(wave) -> None:
            nonlocal emitted
            if wave is None:
                return
            chunk = np.asarray(wave).reshape(-1)
            take = min(len(chunk), target_out() - emitted)
            if take > 0:
                write_frame(wfile, chunk[:take])
                wfile.flush()
                emitted += take

        def process(chunk_np: np.ndarray) -> None:
            nonlocal timbre
            if timbre is None:
                # a live stream cannot pool the whole utterance: the timbre
                # comes from its prefix once the priming span is complete
                prefix_fed.append(chunk_np)
                if sum(len(p) for p in prefix_fed) >= sess.prime_frames * HOP:
                    timbre = self._timbre_tensor(np.concatenate(prefix_fed))
                    prefix_fed.clear()
            emit(engine.feed(chunk_np, timbre))

        try:
            # live phase: client frames re-chunked into whole steps
            while True:
                frame = read_frame(rfile)
                if frame is None:
                    break
                room = max(0, max_samples - accepted)
                if room:
                    buf = np.concatenate([buf, frame[:room]])
                    accepted += min(len(frame), room)
                while len(buf) >= step:
                    process(buf[:step])
                    buf = buf[step:]

            # tail phase: zero-pad a partial chunk (and, for a stream
            # shorter than the priming span, whole zero chunks) until every
            # kept frame has been emitted; causality keeps them exact
            guard = sess.prime_frames // C + 2
            while emitted < target_out() and (
                    len(buf) > 0 or not engine.primed
                    or engine.needs_tail(emitted, target_out())):
                if guard == 0:
                    break
                guard -= 1
                process(np.concatenate([buf, np.zeros(step - len(buf), np.float32)]))
                buf = buf[:0]

            # flush: the final end-reflect frame
            if engine.primed and emitted < target_out():
                emit(engine.finish(timbre))
            write_frame(wfile, None)
            wfile.flush()
            self.service._count_request()  # one request per stream session
        finally:
            engine.close()  # idempotent; frees a group slot on every exit


def make_stream_server(streaming: StreamingService, host: str = "127.0.0.1", port: int = 0,
                       idle_timeout_s: float = 300.0):
    """Build (not start) the threaded TCP server; port 0 = ephemeral. A
    connection silent for idle_timeout_s is dropped, and its handler thread
    and any group slot reclaimed."""

    class Handler(socketserver.StreamRequestHandler):
        timeout = idle_timeout_s  # socketserver applies it to the socket

        def handle(self):
            try:
                streaming.run_connection(self.rfile, self.wfile)
            except (ConnectionError, BrokenPipeError, ValueError, OSError):
                pass  # the peer vanished or stalled; its state dies with it

    class Server(socketserver.ThreadingTCPServer):
        daemon_threads = True
        allow_reuse_address = True

    return Server((host, port), Handler)


# ----------------------------------------------------------------- client


def stream_wav(host: str, port: int, wave: np.ndarray, chunk_frames: int = 4,
               send_samples: Optional[int] = None, timbre_wav_bytes: Optional[bytes] = None,
               vc_mode: Optional[str] = None) -> Tuple[np.ndarray, dict]:
    """Reference client: stream `wave` to a live server in `send_samples`
    frames (default one chunk) and collect the whole output. Returns
    (output wave, the server's status line)."""
    import socket

    header: dict = {"chunk_frames": chunk_frames}
    if timbre_wav_bytes is not None:
        header["timbre_wav"] = base64.b64encode(timbre_wav_bytes).decode()
    if vc_mode is not None:
        header["vc_mode"] = vc_mode
    step = send_samples or chunk_frames * HOP
    wave = np.asarray(wave, np.float32).reshape(-1)

    with socket.create_connection((host, port)) as sock:
        rfile = sock.makefile("rb")
        wfile = sock.makefile("wb")
        wfile.write(json.dumps(header).encode() + b"\n")
        wfile.flush()
        status = json.loads(rfile.readline(MAX_HEADER_BYTES))
        if status.get("status") != "ok":
            raise RuntimeError(f"server rejected stream: {status}")

        out_parts = []
        recv_done = threading.Event()

        def reader():
            # drain concurrently so that neither side blocks on full buffers
            try:
                while True:
                    frame = read_frame(rfile)
                    if frame is None:
                        break
                    out_parts.append(frame)
            finally:
                recv_done.set()

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for i in range(0, len(wave), step):
            write_frame(wfile, wave[i : i + step])
        write_frame(wfile, None)
        wfile.flush()
        recv_done.wait()
        t.join()
    out = np.concatenate(out_parts) if out_parts else np.zeros(0, np.float32)
    return out, status
