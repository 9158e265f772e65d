"""The port's HTTP serving front end (facodec_tpu_torch/cli/serve.py) on the
CPU, against the JAX package's cli/serve.py where both compute the same
thing: the masked timbre of a bucket-padded batch, WAV bytes, bucketing,
cross-request micro-batching, every endpoint of a live server on port 0,
and the caps on hostile input. The tiny config's widths; weights from the
JAX package's init (`load_jax_params`) where JAX is compared, seeded random
otherwise.
"""

import base64
import http.client
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from facodec_tpu.cli import serve as jserve
from facodec_tpu.models.builder import build_model, init_params
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch import __main__ as port_main
from facodec_tpu_torch.api import FACodec, FARedecoder
from facodec_tpu_torch.cli import serve
from facodec_tpu_torch.codec_file import FACodecFile
from facodec_tpu_torch.models.builder import build_codec
from facodec_tpu_torch.utils.weights import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
CODEC = ("encoder", "quantizer", "decoder")
SR, HOP = 24000, 300
TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX package's golden tolerance


def tone(seconds=0.6, hz=220.0, seed=0):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def service():
    codec = FACodec.from_config(TINY, device="cpu", precision="hybrid")
    # 0.5 s buckets, so that a 0.6 s tone is padded and trimmed
    svc = serve.CodecService(codec, bucket_seconds=0.5, stream_threshold_seconds=4.0)
    yield svc
    svc.close()


@pytest.fixture
def http_server(service):
    server = serve.make_server(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server.server_address[1]
    server.shutdown()
    server.server_close()


def _post(url, data):
    return urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"))


# ---------------------------------------------------------- against JAX
def test_masked_forward_v2_matches_jax():
    """A ragged batch zero-padded to one bucket: the timbre pools only each
    row's true length, in both packages."""
    cfg = load_config(TINY)
    jm = build_model(cfg.model_params, "codec")
    jm = {k: jm[k] for k in CODEC}
    params = init_params(jm, jax.random.PRNGKey(0), seg_frames=4)
    port = build_codec(cfg.model_params)
    for k in CODEC:
        load_jax_params(port[k], params[k])
    codec = FACodec(*(port[k] for k in CODEC))
    Tb = 12 * HOP
    lens = np.array([12 * HOP, 7 * HOP, 3 * HOP + 120])
    waves = np.zeros((3, Tb), np.float32)
    for i, n in enumerate(lens):
        waves[i, :n] = tone(n / SR, hz=170.0 + 60 * i, seed=i)

    enc, qt = jm["encoder"], jm["quantizer"]

    def jencode(p, w, wl):
        z = enc.apply({"params": p["encoder"]}, w[:, :, None])
        outs, _, _, _, timbre, codes = qt.apply({"params": p["quantizer"]}, z, w, n_c=2,
                                                full_waves=w, wave_lens=wl, return_codes=True)
        return outs, codes, timbre

    jouts, jcodes, jtimbre = jax.jit(jencode)(params, jnp.asarray(waves),
                                              jnp.asarray(lens, jnp.int32))
    outs, codes, timbre = codec.encode_tensor(torch.from_numpy(waves),
                                              wave_lens=torch.from_numpy(lens))
    for got, want in zip(codes, jcodes):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(timbre.numpy(), np.asarray(jtimbre), **TOL)
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), **TOL)
    # the mask matters: unmasked pooling gives another timbre for short rows
    _, _, unmasked = codec.encode_tensor(torch.from_numpy(waves))
    assert not np.allclose(unmasked.numpy()[2], timbre.numpy()[2], **TOL)
    np.testing.assert_allclose(unmasked.numpy()[0], timbre.numpy()[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float32", "stereo", "16k"])
def test_wav_bytes_match_jax(kind):
    rng = np.random.default_rng(5)
    sr = 16000 if kind == "16k" else SR
    w = (0.5 * np.sin(np.arange(4000) / 7.0)).astype(np.float32)
    data = {"int16": (w * 32767).astype(np.int16), "int32": (w * 2**31 * 0.99).astype(np.int32),
            "uint8": (w * 127 + 128).astype(np.uint8), "float32": w,
            "stereo": np.stack([w, -0.5 * w], 1).astype(np.float32),
            "16k": (w * 32767).astype(np.int16)}[kind]
    buf = io.BytesIO()
    wavfile.write(buf, sr, data)
    blob = buf.getvalue()
    np.testing.assert_array_equal(serve.read_wav_bytes(blob), jserve.read_wav_bytes(blob))
    wave = (0.9 * rng.standard_normal((1, 1000))).astype(np.float32)
    assert serve.write_wav_bytes(wave) == jserve.write_wav_bytes(wave)


# ------------------------------------------------------------- bucketing
def test_service_bucketing_shapes(service):
    """A 0.6 s request on 0.5 s buckets runs padded to 1.0 s; codes and
    output come back at the request's own length."""
    w = tone(0.6)
    true_frames = len(w) // HOP
    f = service.encode(w)
    assert f.codes_p.shape[-1] == true_frames
    assert f.original_length == true_frames * HOP
    out = service.reconstruct(w)
    assert out.shape == (1, true_frames * HOP) and out.dtype == np.float32
    assert np.isfinite(out).all()


def test_service_bucketed_codes_prefix_match(service):
    """Causal config: the bucket's zero pad reaches only the trailing mel
    reflect span (5 frames); every code frame before it equals the unpadded
    one-shot encode's."""
    w = tone(0.6)
    f_b, f_1 = service.encode(w), service.codec.encode(w)
    guard = 5
    for a, b in ((f_b.codes_p, f_1.codes_p), (f_b.codes_c, f_1.codes_c),
                 (f_b.codes_r, f_1.codes_r)):
        np.testing.assert_array_equal(a[..., :-guard], b[..., :-guard])


def test_service_decode_matches_api(service):
    f = service.codec.encode(tone(0.6))
    np.testing.assert_array_equal(service.decode(f), service.codec.decode(f))


def test_microbatching_stacks_concurrent_requests():
    """4 concurrent same-bucket reconstructs run as one device call (a
    window long enough for the burst), and each result equals the request
    run alone (float32, as the JAX package's test)."""
    codec = FACodec.from_config(TINY, device="cpu")
    svc = serve.CodecService(codec, bucket_seconds=0.5, max_batch=4, batch_window_ms=300.0)
    try:
        waves = [tone(0.4, hz=180.0 + 40 * i, seed=i) for i in range(4)]
        seq = [svc.reconstruct(w) for w in waves]
        calls_before = svc._batcher.calls
        results = [None] * 4

        def worker(i):
            results[i] = svc.reconstruct(waves[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert svc._batcher.calls == calls_before + 1
        assert svc._batcher.max_seen == 4
        for got, want in zip(results, seq):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # a bad payload fails its submitter and does not wedge the worker
        with pytest.raises(Exception):
            svc._batcher.submit(("encode", 123), (np.zeros(7, np.float32), 7))
        assert svc.reconstruct(waves[0]).shape == seq[0].shape
    finally:
        svc.close()


# ------------------------------------------------------------------ http
def test_http_endpoints(service, http_server):
    base, _ = http_server
    health = json.loads(urllib.request.urlopen(f"{base}/health").read())
    assert health["status"] == "ok" and health["vc_available"] is False
    assert health["precision"] == "hybrid" and health["device"] == "cpu:cpu"
    metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
    assert "facodec_requests_total" in metrics and "facodec_device_calls_total" in metrics

    blob = serve.write_wav_bytes(tone(0.6))
    resp = _post(f"{base}/reconstruct", blob)
    assert resp.status == 200 and resp.headers["Content-Type"] == "audio/wav"
    assert len(resp.read()) > 44
    fac = _post(f"{base}/encode", blob).read()
    assert FACodecFile.from_bytes(fac).codes_c.shape[-1] == len(tone(0.6)) // HOP
    assert _post(f"{base}/decode", fac).read()[:4] == b"RIFF"
    assert _post(f"{base}/decode?residual=0", fac).read()[:4] == b"RIFF"
    metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
    assert 'facodec_request_latency_seconds{op="reconstruct",quantile="0.5"}' in metrics
    assert 'facodec_request_latency_seconds{op="decode",quantile="0.99"}' in metrics

    body = json.dumps({"source_wav": base64.b64encode(blob).decode(),
                       "target_wav": base64.b64encode(blob).decode()}).encode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/convert", body)
    assert e.value.code == 503  # no redecoder
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base}/decode", b"not a fac file")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/nowhere")
    assert e.value.code == 404


def test_http_convert_with_redecoder():
    codec = FACodec.from_config(TINY, device="cpu", n_c=1, precision="hybrid")
    red = FARedecoder.from_config(TINY, device="cpu")
    svc = serve.CodecService(codec, red, bucket_seconds=0.5)
    server = serve.make_server(svc, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        blob = serve.write_wav_bytes(tone(0.6))
        target = tone(0.6, hz=330, seed=1)
        body = json.dumps({"source_wav": base64.b64encode(blob).decode(),
                           "target_wav": base64.b64encode(serve.write_wav_bytes(target)).decode()
                           }).encode()
        got = serve.read_wav_bytes(_post(f"http://127.0.0.1:{port}/convert", body).read())
        # the server's VC: the source's codes in the target's masked timbre
        src = serve.read_wav_bytes(blob)
        timbre = svc.encode(serve.read_wav_bytes(serve.write_wav_bytes(target))).timbre
        want = red.resynthesize(svc.encode(src), timbre)
        np.testing.assert_array_equal(got, serve.read_wav_bytes(serve.write_wav_bytes(want)))
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/health").read())
        assert health["vc_available"] is True
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


# ---------------------------------------------------------- hostile input
def test_fac_validation_rejects_malformed():
    rng = np.random.default_rng(2)

    def make(**kw):
        base = dict(codes_p=rng.integers(0, 32, (1, 1, 7)).astype(np.uint16),
                    codes_c=rng.integers(0, 32, (1, 2, 7)).astype(np.uint16), codes_r=None,
                    timbre=rng.standard_normal((1, 16)).astype(np.float32), original_length=2100)
        base.update(kw)
        return FACodecFile(**base)

    with pytest.raises(ValueError, match="codes_c"):
        FACodecFile.from_bytes(make(codes_c=rng.integers(0, 32, (2, 7)).astype(np.uint16)
                                    ).to_bytes())
    with pytest.raises(ValueError, match="codes_c"):
        FACodecFile.from_bytes(make(codes_c=rng.integers(0, 32, (1, 2, 9)).astype(np.uint16)
                                    ).to_bytes())
    with pytest.raises(ValueError, match="timbre"):
        FACodecFile.from_bytes(make(timbre=np.zeros((2, 16), np.float32)).to_bytes())
    with pytest.raises(ValueError, match="original_length"):
        FACodecFile.from_bytes(make(original_length=-1).to_bytes())
    FACodecFile.from_bytes(make(codes_p=rng.integers(0, 32, (1, 1, 7)).astype(np.int64)
                                ).to_bytes())


def test_decode_caps_hostile_length(service):
    """A .fac claiming more frames than --max-seconds decodes at most
    max_frames of audio."""
    rng = np.random.default_rng(3)
    svc = serve.CodecService(service.codec, bucket_seconds=0.5, stream_threshold_seconds=4.0,
                             max_seconds=0.5)
    try:
        frames = svc.max_frames + 64
        f = FACodecFile(codes_p=rng.integers(0, 32, (1, 1, frames)).astype(np.uint16),
                        codes_c=rng.integers(0, 32, (1, 2, frames)).astype(np.uint16),
                        codes_r=rng.integers(0, 32, (1, 3, frames)).astype(np.uint16),
                        timbre=rng.standard_normal((1, 64)).astype(np.float32),
                        original_length=frames * HOP)
        out = svc.decode(f)
        assert out.shape[-1] == svc.max_frames * HOP
    finally:
        svc.close()


def test_http_body_cap(http_server):
    """An over-cap Content-Length is answered 413 from the header alone."""
    _, port = http_server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.putrequest("POST", "/reconstruct")
    conn.putheader("Content-Length", str(serve.MAX_BODY_BYTES + 1))
    conn.endheaders()
    assert conn.getresponse().status == 413
    conn.close()


# ------------------------------------------------------------------- cli
def test_serve_cli_defaults_and_device(monkeypatch):
    """`serve` defaults to the card and to hybrid, and raises where torch
    sees no CUDA device; `--artifact` needs `--ckpt-path` (exit 2, as the
    JAX package's); `--shard-inference` raises where there is no GPU to shard
    over (it never serves from the CPU alone); `--precision bfloat16`, once
    refused, serves: the command's server (port 0) answers a reconstruct
    with the bfloat16 codec's wave and reports the policy in /health."""
    import argparse

    args = serve.add_args(argparse.ArgumentParser()).parse_args([])
    assert args.device == "cuda" and args.precision == "hybrid"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        port_main.main(["serve", "--config-path", TINY, "--no-warmup"])
    assert port_main.main(["serve", "--artifact", "x", "--device", "cpu"]) == 2
    with pytest.raises(RuntimeError, match="replica GPU"):
        port_main.main(["serve", "--shard-inference", "--device", "cpu"])
    started = {}
    monkeypatch.setattr(serve, "_serve", lambda server, service, stream_server:
                        started.update(server=server, service=service))
    assert port_main.main(["serve", "--config-path", TINY, "--device", "cpu", "--precision",
                           "bfloat16", "--no-warmup", "--port", "0"]) == 0
    server, service = started["server"], started["service"]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        health = json.loads(urllib.request.urlopen(f"{base}/health").read())
        assert health["precision"] == "bfloat16" and service.codec.precision == "bfloat16"
        w = tone(0.5)
        got = serve.read_wav_bytes(_post(f"{base}/reconstruct", serve.write_wav_bytes(w)).read())
        want = service.reconstruct(serve.read_wav_bytes(serve.write_wav_bytes(w)))
        assert got.size == len(w) // HOP * HOP and np.isfinite(got).all()
        np.testing.assert_array_equal(got, serve.read_wav_bytes(serve.write_wav_bytes(want))
                                      .reshape(got.shape))
    finally:
        server.shutdown()
        server.server_close()
        service.close()
