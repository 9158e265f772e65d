"""The port's continuous batching of live streams
(facodec_tpu_torch/models/stream_batch.py) and its live streaming server
(cli/stream_serve.py) on the CPU, at the tiny config's widths.

The group is held to independent batch-1 sessions (codes equal, waves
within 1e-5: the batched step sums in another order), a straggler's state
to itself bit for bit. The server is held to the interactive session loop
(bit-exact on the dedicated-session path), to the JAX package's protocol
(the JAX package's own `stream_wav` client against the port's server), and
to its lifecycle rules: capacity overflow, disconnects, idle timeouts.
"""

import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from facodec_tpu.cli import stream_serve as jstream_serve
from facodec_tpu_torch.api import FACodec, FARedecoder
from facodec_tpu_torch.cli.serve import CodecService, read_wav_bytes, render_metrics
from facodec_tpu_torch.cli.serve import write_wav_bytes
from facodec_tpu_torch.cli.stream_serve import StreamingService, make_stream_server, stream_wav
from facodec_tpu_torch.models.stream_batch import BatchedStreamGroup, tree_leaves
from facodec_tpu_torch.models.streaming import StreamingFACodec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
SR, HOP = 24000, 300
C = 4  # chunk frames


def tone(seconds, hz=220.0, seed=0):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def codec():
    return FACodec.from_config(TINY, device="cpu", n_c=1)


@pytest.fixture(scope="module")
def sess(codec):
    return StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder, chunk_frames=C,
                            n_c=1)


# --------------------------------------------------------------- the group
def make_stream(sess, seed, n_chunks):
    rng = np.random.default_rng(seed)
    wave = (0.2 * rng.standard_normal((1, n_chunks * C * HOP))).astype(np.float32)
    timbre = (0.5 * rng.standard_normal((1, sess.quantizer.in_dim))).astype(np.float32)
    return torch.from_numpy(wave), torch.from_numpy(timbre)


def solo_run(sess, wave, timbre):
    """An independent batch-1 session over the whole stream, flush included:
    (wave, codes [p, c, r])."""
    est, dst = sess.init_encode_state(1), sess.init_decode_state(1)
    step = C * HOP
    parts, codes = [], []
    for i in range(0, wave.shape[1], step):
        est, outs, c = sess.encode_chunk(est, wave[:, i : i + step], timbre)
        dst, out = sess.decode_chunk(dst, outs)
        if out is not None:
            parts.append(out.numpy()[0])
            codes.append([x.numpy()[0] for x in c])
    outs_t, c = sess.flush_encode(est, timbre)
    dst, out_t = sess.decode_chunk(dst, outs_t)
    parts.append(out_t.numpy()[0])
    codes.append([x.numpy()[0] for x in c])
    return np.concatenate(parts), [np.concatenate([c[j] for c in codes], -1) for j in range(3)]


def group_run_staggered(sess, streams, capacity):
    """Stream k joins once the earlier ones have ticked; each flushes and
    leaves when its input runs out; later joins reuse freed slots."""
    group = BatchedStreamGroup(sess, capacity)
    step, P = C * HOP, sess.prime_frames
    outs, codes, slots, cursor = {}, {}, {}, {}
    pending, live = list(range(len(streams))), []
    while pending or live:
        if pending and group.free_slots() > 0:
            k = pending.pop(0)
            wave, timbre = streams[k]
            slot, first, c = group.join(wave[:, : P * HOP], timbre)
            outs[k], codes[k] = [first.numpy()[0]], [[x.numpy()[0] for x in c]]
            slots[k], cursor[k] = slot, P * HOP
            live.append(k)
        chunks = {}
        for k in live:
            wave = streams[k][0]
            if cursor[k] < wave.shape[1]:
                chunks[slots[k]] = wave.numpy()[0, cursor[k] : cursor[k] + step]
                cursor[k] += step
        got, got_codes = group.tick(chunks, with_codes=True)
        for k in list(live):
            if slots[k] in got:
                outs[k].append(got[slots[k]])
                codes[k].append(got_codes[slots[k]])
            if cursor[k] >= streams[k][0].shape[1]:
                outs[k].append(group.flush(slots[k]))
                group.leave(slots[k])
                live.remove(k)
    return {k: np.concatenate(v) for k, v in outs.items()}, codes


def test_group_matches_solo_sessions(sess):
    """Four streams through a 2-slot group (slots reused), staggered joins:
    each stream's waves and codes match its independent session."""
    n_prime = sess.prime_frames // C
    streams = [make_stream(sess, seed, n_prime + 2 + seed % 2) for seed in range(4)]
    got, got_codes = group_run_staggered(sess, streams, capacity=2)
    for k, (wave, timbre) in enumerate(streams):
        want, want_codes = solo_run(sess, wave, timbre)
        assert got[k].shape == want.shape
        np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-5)
        # the flush frame's codes come from the solo run only
        for j in range(3):
            np.testing.assert_array_equal(
                np.concatenate([c[j] for c in got_codes[k]], -1), want_codes[j][..., :-1])


def test_straggler_slot_is_bit_frozen(sess):
    """A tick that advances only one of two live streams leaves the other's
    state bit for bit, so its later chunks match its solo session."""
    P, step = sess.prime_frames, C * HOP
    a_wave, a_timbre = make_stream(sess, 21, P // C + 3)
    b_wave, b_timbre = make_stream(sess, 22, P // C + 3)
    group = BatchedStreamGroup(sess, 2)
    sa, _, _ = group.join(a_wave[:, : P * HOP], a_timbre)
    sb, _, _ = group.join(b_wave[:, : P * HOP], b_timbre)
    axes = tree_leaves(group._enc_axes) + tree_leaves(group._dec_axes)
    frozen = [x.clone() for x in tree_leaves(group.enc_core) + tree_leaves(group.dec_core)]
    group.tick({sa: a_wave.numpy()[0, P * HOP : P * HOP + step]})
    after = tree_leaves(group.enc_core) + tree_leaves(group.dec_core)
    assert len(after) == len(frozen) == len(axes)
    for before, now, ax in zip(frozen, after, axes):
        assert torch.equal(before.narrow(ax, sb, 1), now.narrow(ax, sb, 1))
    changed = [not torch.equal(b.narrow(ax, sa, 1), n.narrow(ax, sa, 1))
               for b, n, ax in zip(frozen, after, axes)]
    assert any(changed)

    est, dst = sess.init_encode_state(1), sess.init_decode_state(1)
    est, outs, _ = sess.encode_chunk(est, b_wave[:, : P * HOP], b_timbre)
    dst, _ = sess.decode_chunk(dst, outs)
    for i in range(P * HOP, b_wave.shape[1], step):
        est, outs, _ = sess.encode_chunk(est, b_wave[:, i : i + step], b_timbre)
        dst, w = sess.decode_chunk(dst, outs)
        got = group.tick({sb: b_wave.numpy()[0, i : i + step]})
        np.testing.assert_allclose(got[sb], w.numpy()[0], rtol=1e-5, atol=1e-5)


def test_group_capacity_and_errors(sess):
    P = sess.prime_frames
    group = BatchedStreamGroup(sess, 1)
    wave, timbre = make_stream(sess, 31, P // C + 1)
    slot, _, _ = group.join(wave[:, : P * HOP], timbre)
    assert group.free_slots() == 0
    with pytest.raises(RuntimeError, match="full"):
        group.join(wave[:, : P * HOP], timbre)
    group.leave(slot)
    with pytest.raises(ValueError, match="priming"):
        group.join(wave[:, :HOP], timbre)
    assert group.tick({}) == {}
    with pytest.raises(ValueError, match="not active"):
        group.tick({0: np.zeros(C * HOP, np.float32)})
    with pytest.raises(ValueError, match="capacity"):
        BatchedStreamGroup(sess, 0)


# -------------------------------------------------------------- the server
def _live_pair(group_capacity, redecoder=False, idle_timeout_s=300.0):
    codec = FACodec.from_config(TINY, device="cpu", n_c=2)
    red = FARedecoder.from_config(TINY, device="cpu") if redecoder else None
    service = CodecService(codec, red, bucket_seconds=0.5)
    streaming = StreamingService(service, group_capacity=group_capacity)
    server = make_stream_server(streaming, port=0, idle_timeout_s=idle_timeout_s)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return streaming, server


def _close(streaming, server):
    server.shutdown()
    server.server_close()
    streaming.close()
    streaming.service.close()


@pytest.fixture(scope="module")
def live():
    """Grouping off: every stream a dedicated session."""
    streaming, server = _live_pair(group_capacity=0)
    yield streaming, server.server_address[1]
    _close(streaming, server)


@pytest.fixture(scope="module")
def live_grouped():
    """Continuous batching on."""
    streaming, server = _live_pair(group_capacity=4)
    yield streaming, server.server_address[1]
    _close(streaming, server)


def session_loop_reference(streaming, wave, timbre):
    """The interactive session loop (roundtrip_chunk, then the flush) that
    the server's dedicated-session path must match bit for bit."""
    sess = streaming.session(C)
    est, dst = sess.init_encode_state(1), sess.init_decode_state(1)
    w = torch.from_numpy(wave)[None]
    t = torch.from_numpy(np.asarray(timbre, np.float32))
    parts = []
    for i in range(0, w.shape[1], C * HOP):
        est, dst, out, _ = sess.roundtrip_chunk(est, dst, w[:, i : i + C * HOP], t)
        if out is not None:
            parts.append(out.numpy()[0])
    outs_t, _ = sess.flush_encode(est, t)
    dst, out_t = sess.decode_chunk(dst, outs_t)
    parts.append(out_t.numpy()[0])
    return np.concatenate(parts)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_stream_exact_multiple_matches_session(live, client):
    """Whole-chunk input: the server's output equals the session loop with
    the server's own self-timbre, bit for bit with the flush frame; the JAX
    package's client gets the same bytes (the protocol is the same)."""
    streaming, port = live
    sess = streaming.session(C)
    n_chunks = sess.prime_frames // C + 2
    wave = tone(n_chunks * C * HOP / SR, seed=3)
    client_fn = stream_wav if client == "port" else jstream_serve.stream_wav
    out, status = client_fn("127.0.0.1", port, wave, chunk_frames=C)
    assert status["prime_samples"] == sess.prime_frames * HOP and status["vc"] is False
    assert out.shape == wave.shape
    timbre = streaming.timbre_from_wave(wave[: sess.prime_frames * HOP])
    np.testing.assert_array_equal(out, session_loop_reference(streaming, wave, timbre))


def test_stream_vc_target_timbre(live):
    """With timbre_wav the stream decodes under the target's masked timbre."""
    streaming, port = live
    sess = streaming.session(C)
    source = tone((sess.prime_frames // C + 2) * C * HOP / SR, hz=196.0, seed=5)
    blob = write_wav_bytes(tone(0.45, hz=330.0, seed=6))
    out, status = stream_wav("127.0.0.1", port, source, chunk_frames=C, timbre_wav_bytes=blob)
    assert status["vc"] is True
    timbre = streaming.timbre_from_wave(read_wav_bytes(blob))
    np.testing.assert_array_equal(out, session_loop_reference(streaming, source, timbre))
    out_self, _ = stream_wav("127.0.0.1", port, source, chunk_frames=C)
    assert not np.array_equal(out, out_self)


def test_stream_ragged_frames_and_tail(live):
    """Off-chunk client frames and a partial last chunk: the output has the
    input's frame span, and every sample before the last frame equals the
    same stream extended to whole chunks."""
    streaming, port = live
    sess = streaming.session(C)
    frames = sess.prime_frames + 2 * C + 2
    wave = tone(frames * HOP / SR, seed=7)
    out, _ = stream_wav("127.0.0.1", port, wave, chunk_frames=C, send_samples=777)
    assert out.shape == (frames * HOP,) and np.isfinite(out).all()
    full = tone((sess.prime_frames + 3 * C) * HOP / SR, seed=7)
    full[: len(wave)] = wave
    out_full, _ = stream_wav("127.0.0.1", port, full, chunk_frames=C)
    np.testing.assert_array_equal(out[: (frames - 1) * HOP], out_full[: (frames - 1) * HOP])


def test_stream_shorter_than_priming(live):
    _, port = live
    out, _ = stream_wav("127.0.0.1", port, tone(2 * HOP / SR, seed=9), chunk_frames=C)
    assert out.shape == (2 * HOP,) and np.isfinite(out).all()


@pytest.mark.parametrize("header", [{"chunk_frames": 9999}, {"chunk_frames": 4, "vc_mode": "x"},
                                    {"chunk_frames": 4, "vc_mode": "redecoder"}])
def test_stream_rejects_bad_header(live, header):
    """A bad header, or redecoder VC on a server without a redecoder."""
    _, port = live
    with socket.create_connection(("127.0.0.1", port)) as sock:
        sock.sendall(json.dumps(header).encode() + b"\n")
        line = sock.makefile("rb").readline()
    assert json.loads(line)["status"] == "error"


def test_grouped_streams_batch_and_match_solo(live_grouped, live):
    """Concurrent connections share ticks, and each stream's output matches
    the dedicated-session server's within 1e-5."""
    streaming, port = live_grouped
    _, solo_port = live
    sess = streaming.session(C)
    n_chunks = sess.prime_frames // C + 4
    waves = [tone(n_chunks * C * HOP / SR, hz=180.0 + 50 * i, seed=40 + i) for i in range(3)]
    results = [None] * 3

    def worker(i):
        results[i] = stream_wav("127.0.0.1", port, waves[i], chunk_frames=C)[0]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    disp = streaming.dispatcher(C)
    assert disp.max_stacked >= 2, "concurrent streams never shared a tick"
    metrics = render_metrics(streaming.service)
    assert f'facodec_stream_ticks_total{{chunk_frames="{C}"}}' in metrics
    assert "facodec_stream_tick_max_stacked" in metrics
    assert 'op="stream_chunk"' in metrics
    assert disp.group.free_slots() == disp.group.capacity  # every slot released
    for i in range(3):
        want, _ = stream_wav("127.0.0.1", solo_port, waves[i], chunk_frames=C)
        assert results[i].shape == want.shape
        np.testing.assert_allclose(results[i], want, rtol=1e-5, atol=1e-5)


class _SlowGroup:
    """A stand-in group of `capacity` active slots: a tick echoes each
    slot's chunk after 40 ms."""

    def __init__(self, capacity):
        self.capacity = capacity

    def free_slots(self):
        return 0

    def tick(self, chunks):
        time.sleep(0.04)
        return dict(chunks)


def test_dispatcher_ticks_stack_every_stream():
    """Four streams that send each next chunk as soon as the last one is
    answered; two of them start while the first tick runs. A tick waits for
    every active slot (within the 5 ms window, counted from the previous
    tick's hand-out), so after the first ticks all four share each tick.
    Counted from the oldest pending chunk alone (the JAX package's rule),
    the late pair's chunks are older than the window when a tick ends, the
    next tick fires without the pair it just answered, and the streams
    alternate in ticks of two."""
    from facodec_tpu_torch.cli.stream_serve import _GroupDispatcher

    n, chunks = 4, 20

    class _Svc:
        lock, _stats_lock = threading.Lock(), threading.Lock()
        _lat = {"stream_chunk": []}

    disp = _GroupDispatcher(_Svc(), _SlowGroup(n), window_s=0.005)
    results = {}

    def stream(slot):
        results[slot] = [disp.submit(slot, np.full(3, 10 * slot + i, np.float32))[0]
                         for i in range(chunks)]

    threads = [threading.Thread(target=stream, args=(s,)) for s in range(n)]
    try:
        for i, t in enumerate(threads):
            if i == n // 2:
                time.sleep(0.015)
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        disp.close()
    assert all(results[s] == [10 * s + i for i in range(chunks)] for s in range(n))
    slots = [k for _, k in disp.tick_s]
    assert disp.ticks == len(slots) and sum(slots) == n * chunks
    assert np.mean(slots) >= 3.0, slots


def test_grouped_overflow_falls_back_to_solo():
    """More concurrent streams than slots: the overflow stream gets a
    dedicated session, and both match the solo path."""
    streaming, server = _live_pair(group_capacity=1)
    port = server.server_address[1]
    try:
        sess = streaming.session(C)
        n_chunks = sess.prime_frames // C + 3
        waves = [tone(n_chunks * C * HOP / SR, hz=200.0 + 60 * i, seed=50 + i)
                 for i in range(2)]
        results = [None] * 2
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, stream_wav("127.0.0.1", port, waves[i], chunk_frames=C)[0])) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, out in enumerate(results):
            timbre = streaming.timbre_from_wave(waves[i][: sess.prime_frames * HOP])
            np.testing.assert_allclose(out, session_loop_reference(streaming, waves[i], timbre),
                                       rtol=1e-5, atol=1e-5)
        assert streaming.dispatcher(C).group.free_slots() == 1
    finally:
        _close(streaming, server)


def test_stream_redecoder_vc_matches_oneshot():
    """vc_mode=redecoder: the live stream equals one-shot
    `FARedecoder.resynthesize` of the one-shot codes; a stream shorter than
    both priming spans still comes back whole."""
    streaming, server = _live_pair(group_capacity=0, redecoder=True)
    port = server.server_address[1]
    try:
        sess, rsess = streaming.session(C), streaming.redecoder_session(C)
        n_chunks = (sess.prime_frames + rsess.prime_frames) // C + 3
        source = tone(n_chunks * C * HOP / SR, hz=196.0, seed=7)
        blob = write_wav_bytes(tone(0.45, hz=330.0, seed=8))
        out, status = stream_wav("127.0.0.1", port, source, chunk_frames=C,
                                 timbre_wav_bytes=blob, vc_mode="redecoder")
        assert status["vc_mode"] == "redecoder"
        assert status["redecoder_prime_frames"] == rsess.prime_frames
        assert out.shape == source.shape
        codec, red = streaming.service.codec, streaming.service.redecoder
        timbre = streaming.timbre_from_wave(read_wav_bytes(blob))
        want = red.resynthesize(codec.encode(source), timbre)[0]
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
        short = tone(2 * C * HOP / SR, hz=250.0, seed=9)
        out, _ = stream_wav("127.0.0.1", port, short, chunk_frames=C, timbre_wav_bytes=blob,
                            vc_mode="redecoder")
        assert out.shape == short.shape and np.isfinite(out).all()
    finally:
        _close(streaming, server)


def _wait_for(cond, timeout_s=60.0, what=""):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _open_and_prime(port, sess, seed, extra_chunks):
    """A raw connection that sends its header, the priming span and
    `extra_chunks` chunks, and no end marker."""
    sock = socket.create_connection(("127.0.0.1", port))
    wfile, rfile = sock.makefile("wb"), sock.makefile("rb")
    wfile.write(json.dumps({"chunk_frames": C}).encode() + b"\n")
    wfile.flush()
    assert json.loads(rfile.readline())["status"] == "ok"
    step = C * HOP
    wave = tone((sess.prime_frames * HOP + extra_chunks * step) / SR, seed=seed)
    for i in range(0, len(wave), step):
        payload = np.ascontiguousarray(wave[i : i + step], np.float32).tobytes()
        wfile.write(struct.pack("<I", len(payload)) + payload)
    wfile.flush()
    return sock, wfile, rfile


def test_grouped_slot_released_on_abrupt_disconnect(live_grouped):
    streaming, port = live_grouped
    sess, disp = streaming.session(C), streaming.dispatcher(C)
    free_before = disp.group.free_slots()
    sock, wfile, rfile = _open_and_prime(port, sess, 60, 2)
    _wait_for(lambda: disp.group.free_slots() < free_before, what="a slot to be taken")
    for f in (wfile, rfile, sock):  # every handle, so that the server sees EOF
        f.close()
    _wait_for(lambda: disp.group.free_slots() == free_before, what="the slot's release")


def test_stream_idle_timeout_reclaims_connection():
    streaming, server = _live_pair(group_capacity=2, idle_timeout_s=1.0)
    port = server.server_address[1]
    try:
        sess, disp = streaming.session(C), streaming.dispatcher(C)
        free_before = disp.group.free_slots()
        sock, wfile, rfile = _open_and_prime(port, sess, 70, 0)
        _wait_for(lambda: disp.group.free_slots() < free_before, what="a slot to be taken")
        _wait_for(lambda: disp.group.free_slots() == free_before,
                  what="the idle timeout to reclaim the slot")
        for f in (wfile, rfile, sock):
            f.close()
    finally:
        _close(streaming, server)


def test_stream_counts_requests(live):
    streaming, port = live
    svc = streaming.service
    before = svc.requests
    wave = tone((streaming.session(C).prime_frames + C) * HOP / SR, seed=11)
    stream_wav("127.0.0.1", port, wave, chunk_frames=C)
    assert svc.requests > before
