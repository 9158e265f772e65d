"""The port's exact chunked streaming against the JAX package, on the CPU.

Streamed convs and residual units, the `StreamingFACodec` session (chunk
by chunk, states included), `StreamingRedecoder`, `encode_streaming` /
`decode_streaming`, the `encode` / `decode` CLIs' streaming route and the
latency report, each against its JAX counterpart on the same numpy inputs
and the same weights (`load_jax_params`), and each chunked result against
the port's own one-shot path. Codes must be bit-exact, tensors and states
within the JAX package's golden tolerance (tests/test_model_parity.py).
The JAX package streams a residual unit unfused; the port's CPU route is
the kernel wrapper's plain version.
"""

import argparse
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from facodec_tpu.api import FACodec as JFACodec
from facodec_tpu.cli import codec as j_codec_cli
from facodec_tpu.codec_file import FACodecFile as JFACodecFile
from facodec_tpu.models import streaming as jstreaming
from facodec_tpu.models.builder import build_model, init_params
from facodec_tpu.models.dac import Decoder as JDecoder
from facodec_tpu.models.dac import ResidualUnit as JResidualUnit
from facodec_tpu.models.latency import codec_latency as j_codec_latency
from facodec_tpu.models.redecoder import Redecoder as JRedecoder
from facodec_tpu.nn.conv import SConv1d as JSConv1d
from facodec_tpu.nn.conv import SConvTranspose1d as JSConvTranspose1d
from facodec_tpu.utils.checkpoint import export_state_dict
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch.api import FACodec, FARedecoder
from facodec_tpu_torch.cli import codec as codec_cli
from facodec_tpu_torch.codec_file import FACodecFile
from facodec_tpu_torch.config import FLAGSHIP
from facodec_tpu_torch.models import streaming
from facodec_tpu_torch.models.builder import build_codec
from facodec_tpu_torch.models.dac import Decoder, ResidualUnit
from facodec_tpu_torch.models.latency import codec_latency
from facodec_tpu_torch.models.redecoder import Redecoder
from facodec_tpu_torch.nn.conv import SConv1d, SConvTranspose1d
from facodec_tpu_torch.ops.kernels import resunit
from facodec_tpu_torch.utils.signals import sweep_wave
from facodec_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
CODEC = ("encoder", "quantizer", "decoder")
HOP = 300


def _flat(tree, prefix=()):
    """Nested dicts / tuples of arrays or tensors -> {path: numpy array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, prefix + (k,)))
    return out


def _assert_trees_close(got, want):
    """Same structure and names, same shapes, values within TOL."""
    got, want = _flat(got), _flat(want)
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_allclose(got[path], w, err_msg=str(path), **TOL)


# ------------------------------------------------------ (a) streamed convs
@pytest.mark.parametrize("k,s,d", [(7, 1, 1), (7, 1, 9), (4, 2, 1), (10, 5, 1)])
def test_sconv1d_stream_matches_jax(k, s, d):
    """Chunk by chunk, the output and the carried context, with later chunks
    both longer and shorter than the context; chunked equals one-shot."""
    jmod = JSConv1d(3, 5, k, stride=s, dilation=d, causal=True)
    first = max(60, 2 * s)
    sizes = [first, 7 * s, s, 2 * s, first]
    x = np.random.default_rng(k + d).standard_normal((2, sum(sizes), 3)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mod = SConv1d(3, 5, k, stride=s, dilation=d, causal=True)
    load_jax_params(mod, params["params"])
    jstate, state, outs, i = jmod.init_state(2), mod.init_state(2), [], 0
    assert tuple(state.shape) == tuple(jstate.shape) == (2, (k - 1) * d + 1 - s, 3)
    with torch.no_grad():
        for n in sizes:
            chunk = x[:, i : i + n]
            jy, jstate = jmod.apply(params, jnp.asarray(chunk), jstate, first=i == 0)
            y, state = mod(torch.from_numpy(chunk), state, first=i == 0)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
            np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)
            outs.append(y)
            i += n
        full = mod(torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("k,s", [(4, 2), (10, 5), (12, 6)])
def test_sconvtranspose1d_stream_matches_jax(k, s):
    jmod = JSConvTranspose1d(3, 5, k, stride=s, causal=True)
    sizes = [5, 1, 5, 9]
    x = np.random.default_rng(k).standard_normal((2, sum(sizes), 3)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    mod = SConvTranspose1d(3, 5, k, stride=s, causal=True)
    load_jax_params(mod, params["params"])
    jstate, state, outs, i = jmod.init_state(2), mod.init_state(2), [], 0
    with torch.no_grad():
        for n in sizes:
            chunk = x[:, i : i + n]
            jy, jstate = jmod.apply(params, jnp.asarray(chunk), jstate)
            y, state = mod(torch.from_numpy(chunk), state)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
            np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)
            outs.append(y)
            i += n
        full = mod(torch.from_numpy(x))
    assert tuple(state.shape) == (2, k - s, 5)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **TOL)


# ------------------------------------------------ (b) streamed residual unit
@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_residual_unit_stream_matches_jax(dilation):
    """The port's streamed unit (the halo entry's plain version) against the
    JAX package's unfused streamed unit, with chunks shorter than, equal to
    and longer than the 6d-row halo (T in 1, 6, 24, 53, 54, 55 at d = 9)."""
    C, H = 32, 6 * dilation
    sizes = [H + 6, 1, 6, 24, 53, 54, 55, 2]
    x = (0.5 * np.random.default_rng(dilation).standard_normal((2, sum(sizes), C))
         ).astype(np.float32)
    junit = JResidualUnit(C, dilation=dilation, causal=True)
    jstate = {"block_1": jnp.zeros((2, H, C)), "block_3": jnp.zeros((2, 0, C))}
    # initialised through the streamed (unfused) call, as it is applied below
    params = junit.init(jax.random.PRNGKey(dilation), jnp.asarray(x[:, : sizes[0]]), jstate,
                        first=True)
    unit = ResidualUnit(C, dilation=dilation, causal=True)
    load_jax_params(unit, params["params"])
    state = {"block_1": torch.zeros(2, H, C), "block_3": torch.zeros(2, 0, C)}
    outs, i = [], 0
    with torch.no_grad():
        for n in sizes:
            chunk = x[:, i : i + n]
            jy, jstate = junit.apply(params, jnp.asarray(chunk), jstate, first=i == 0)
            y, state = unit(torch.from_numpy(chunk), state, first=i == 0)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
            _assert_trees_close(state, jstate)
            outs.append(y)
            i += n
        full = unit(torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **TOL)


def test_residual_unit_stream_first_chunk_must_cover_the_halo():
    """A first chunk of at most 6d rows would need the one-shot reflect's
    short-input extension, which a stream never takes: it raises."""
    C, d = 32, 9
    unit = ResidualUnit(C, dilation=d, causal=True)
    state = {"block_1": torch.zeros(1, 6 * d, C), "block_3": torch.zeros(1, 0, C)}
    before = resunit.fused_residual_unit_stream.launches
    with torch.no_grad(), pytest.raises(ValueError, match="T > 6d"):
        unit(torch.zeros(1, 6 * d, C), state, first=True)
    with torch.no_grad(), pytest.raises(ValueError, match="halo"):
        unit(torch.zeros(1, 10, C), {"block_1": torch.zeros(1, 5, C)}, first=False)
    assert resunit.fused_residual_unit_stream.launches == before


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once: eight spinning threads each thrash
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------- (c) codec sessions
@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(TINY)
    jm = build_model(cfg.model_params, "codec")
    jm = {k: jm[k] for k in CODEC}
    params = init_params(jm, jax.random.PRNGKey(0))
    port = build_codec(cfg.model_params)
    for k in CODEC:
        load_jax_params(port[k], params[k])
        port[k].eval()
    return dict(jm=jm, params=params, port=port)


def _session_outputs(step_fn, n_chunks):
    """Concatenate (outs, codes, wave) over the emitted chunks."""
    outs, codes, waves = [], [], []
    for i in range(n_chunks):
        got = step_fn(i)
        if got is None:
            continue
        o, c, w = got
        outs.append(o)
        codes.append(c)
        waves.append(w)
    return outs, codes, waves


@pytest.mark.parametrize("chunk", [4, 8, 12])
def test_streaming_codec_matches_jax_and_one_shot(tiny, chunk):
    """One session of each package on the same wave and timbre: after every
    chunk the codes are bit-exact, and outs, waves and every carried state
    (encoder, prosody WN, wave tail, held-back latent, decoder) agree. The
    port's chunked output also equals its one-shot forward_v2 + decode.
    chunk < 11 primes; chunk 4 gives the d = 9 units 24-row chunks, fewer
    than their 54-row halo."""
    jm, params, port = tiny["jm"], tiny["params"], tiny["port"]
    frames = 36
    rng = np.random.default_rng(7)
    wave = (0.2 * rng.standard_normal((2, frames * HOP))).astype(np.float32)
    codec = FACodec(port["encoder"], port["quantizer"], port["decoder"], n_c=1)
    outs_full, codes_full, timbre = codec.encode_tensor(torch.from_numpy(wave))
    wave_full = codec.decode_latent(outs_full)

    jsess = jstreaming.StreamingFACodec(jm["encoder"], jm["quantizer"], jm["decoder"], params,
                                        chunk_frames=chunk, n_c=1)
    sess = streaming.StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder,
                                      chunk_frames=chunk, n_c=1)
    assert sess.prime_frames == jsess.prime_frames
    jt = jnp.asarray(timbre.numpy())
    jest, jdst = jsess.init_encode_state(2), jsess.init_decode_state(2)
    est, dst = sess.init_encode_state(2), sess.init_decode_state(2)
    _assert_trees_close(est.core, jest.core)
    _assert_trees_close(dst, jdst)
    step = chunk * HOP
    outs, codes, waves = [], [], []
    for i in range(0, frames * HOP, step):
        jest, jo, jc = jsess.encode_chunk(jest, jnp.asarray(wave[:, i : i + step]), jt)
        jdst, jw = jsess.decode_chunk(jdst, jo)
        est, o, c = sess.encode_chunk(est, torch.from_numpy(wave[:, i : i + step]), timbre)
        dst, w = sess.decode_chunk(dst, o)
        assert est.primed == jest.primed and est.n_pending == jest.n_pending
        if jo is None:
            assert o is None and w is None
            continue
        for a, b in zip(c, jc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
        _assert_trees_close(est.core, jest.core)
        _assert_trees_close(dst, jdst)
        outs.append(o)
        codes.append(c)
        waves.append(w)
    jo, jc = jsess.flush_encode(jest, jt)
    o, c = sess.flush_encode(est, timbre)
    jdst, jw = jsess.decode_chunk(jdst, jo)
    dst, w = sess.decode_chunk(dst, o)
    for a, b in zip(c, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    _assert_trees_close(dst, jdst)
    outs.append(o)
    codes.append(c)
    waves.append(w)

    assert torch.cat(outs, 1).shape == outs_full.shape
    for j in range(3):
        np.testing.assert_array_equal(torch.cat([cc[j] for cc in codes], -1).numpy(),
                                      codes_full[j].numpy())
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), outs_full.numpy(), **TOL)
    np.testing.assert_allclose(torch.cat(waves, 1).numpy(), wave_full.numpy(), **TOL)


# ------------------------------------------- (d) fused step and whole wave
def _port_session(tiny, chunk):
    port = tiny["port"]
    return streaming.StreamingFACodec(port["encoder"], port["quantizer"], port["decoder"],
                                      chunk_frames=chunk, n_c=1)


def _chunk_loop(sess, wave, timbre, flush=True):
    """encode_chunk + decode_chunk over the wave: (waves, codes) per emission."""
    step = sess.chunk_frames * HOP
    est, dst = sess.init_encode_state(wave.shape[0]), sess.init_decode_state(wave.shape[0])
    waves, codes = [], []
    for i in range(0, wave.shape[1], step):
        est, o, c = sess.encode_chunk(est, wave[:, i : i + step], timbre)
        dst, w = sess.decode_chunk(dst, o)
        if o is not None:
            waves.append(w)
            codes.append(c)
    if flush:
        o, c = sess.flush_encode(est, timbre)
        dst, w = sess.decode_chunk(dst, o)
        waves.append(w)
        codes.append(c)
    return waves, codes


@pytest.mark.parametrize("chunk", [6, 12])
def test_roundtrip_chunk_matches_separate_calls(tiny, chunk):
    sess = _port_session(tiny, chunk)
    wave = torch.from_numpy((0.2 * np.random.default_rng(11).standard_normal(
        (1, 48 * HOP))).astype(np.float32))
    timbre = torch.zeros(1, 64)
    waves, codes = _chunk_loop(sess, wave, timbre, flush=False)
    est, dst = sess.init_encode_state(1), sess.init_decode_state(1)
    fused_w, fused_c = [], []
    for i in range(0, wave.shape[1], chunk * HOP):
        est, dst, w, c = sess.roundtrip_chunk(est, dst, wave[:, i : i + chunk * HOP], timbre)
        if w is not None:
            fused_w.append(w)
            fused_c.append(c)
    assert len(fused_w) == len(waves)
    for a, b in zip(fused_c, codes):
        for j in range(3):
            assert torch.equal(a[j], b[j])
    assert torch.equal(torch.cat(fused_w, 1), torch.cat(waves, 1))


@pytest.mark.parametrize("chunk,n_chunks", [(12, 3), (6, 5)])
def test_run_scan_matches_chunk_loop(tiny, chunk, n_chunks):
    sess = _port_session(tiny, chunk)
    wave = torch.from_numpy((0.2 * np.random.default_rng(9).standard_normal(
        (1, n_chunks * chunk * HOP))).astype(np.float32))
    timbre = torch.zeros(1, 64)
    waves, codes = _chunk_loop(sess, wave, timbre)
    scan_wave, scan_codes = sess.run_scan(wave, timbre)
    assert scan_wave.shape == wave.shape
    assert torch.equal(scan_wave, torch.cat(waves, 1))
    for j in range(3):
        assert torch.equal(scan_codes[j], torch.cat([c[j] for c in codes], -1))


# -------------------------------------------------- (e) streamed redecoder
def _redecoder_pair(causal=True):
    red_f = dict(n_p_codebooks=1, n_c_codebooks=2, codebook_size=32, embed_dim=16,
                 n_layers=4, causal=causal, gin_channels=48, out_dim=64)
    dec_f = dict(input_channel=64, channels=32, rates=(6, 5, 5, 2), causal=causal, lstm=1)
    return (JRedecoder(p_dropout=0.0, **red_f), JDecoder(**dec_f),
            Redecoder(**red_f), Decoder(**dec_f))


def test_streaming_redecoder_matches_jax_and_resynthesize():
    jred, jdec, red, dec = _redecoder_pair()
    params = init_params(dict(encoder=jred, decoder=jdec), jax.random.PRNGKey(3),
                         seg_frames=12)
    load_jax_params(red, params["encoder"])
    load_jax_params(dec, params["decoder"])
    frames, chunk = 24, 4
    rng = np.random.default_rng(5)
    cp = rng.integers(0, 32, (1, 1, frames)).astype(np.int32)
    cc = rng.integers(0, 32, (1, 2, frames)).astype(np.int32)
    timbre = (0.3 * rng.standard_normal((1, 48))).astype(np.float32)

    jsess = jstreaming.StreamingRedecoder(jred, jdec, params, chunk_frames=chunk, n_c=1)
    sess = streaming.StreamingRedecoder(red.eval(), dec.eval(), chunk_frames=chunk, n_c=1)
    assert sess.prime_frames == jsess.prime_frames == 12
    jstate, state = jsess.init_state(1), sess.init_state(1)
    _assert_trees_close(state.core, jstate.core)
    waves = []
    for i in range(0, frames, chunk):
        sl = slice(i, i + chunk)
        jstate, jw = jsess.vc_chunk(jstate, jnp.asarray(cp[..., sl]), jnp.asarray(cc[..., sl]),
                                    jnp.asarray(timbre))
        state, w = sess.vc_chunk(state, torch.from_numpy(cp[..., sl]),
                                 torch.from_numpy(cc[..., sl]), torch.from_numpy(timbre))
        assert (w is None) == (jw is None)
        if w is None:
            continue
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
        _assert_trees_close(state.core, jstate.core)
        waves.append(w.numpy())
    got = np.concatenate(waves, axis=1)

    f = FACodecFile(codes_p=cp.astype(np.uint16), codes_c=cc.astype(np.uint16), codes_r=None,
                    timbre=timbre, original_length=frames * HOP)
    vc = FARedecoder(red, dec)
    want = vc.resynthesize(f, timbre, n_c=1)
    assert got.shape == want.shape == (1, frames * HOP)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(vc.resynthesize_streaming(f, timbre, chunk_frames=chunk),
                               got, rtol=0, atol=0)


def test_streaming_redecoder_rejects_noncausal():
    _, _, red, dec = _redecoder_pair(causal=False)
    with pytest.raises(ValueError, match="causal"):
        streaming.StreamingRedecoder(red, dec, chunk_frames=4)


# ---------------------------------------- (f) encode / decode_streaming
def _codecs(tiny, n_c=2):
    port = tiny["port"]
    return (JFACodec(models=tiny["jm"], params=tiny["params"], n_c=n_c),
            FACodec(port["encoder"], port["quantizer"], port["decoder"], n_c=n_c))


def _assert_same_codes(got, want):
    for name in ("codes_p", "codes_c", "codes_r"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.original_length == want.original_length


def test_encode_decode_streaming_match_jax(tiny):
    """44 frames at 8-frame chunks (a 4-frame last chunk), the timbre from the
    first 0.2 s: the codes equal JAX's and the port's one-shot encode's, the
    timbre JAX's; decode_streaming equals JAX's and the port's decode."""
    jc, pc = _codecs(tiny)
    wave = sweep_wave(1, 44 * HOP / 24000, seed=21)
    jf = jc.encode_streaming(wave, chunk_frames=8, timbre_seconds=0.2)
    pf = pc.encode_streaming(wave, chunk_frames=8, timbre_seconds=0.2)
    _assert_same_codes(pf, jf)
    np.testing.assert_allclose(pf.timbre, jf.timbre, **TOL)
    _assert_same_codes(pf, pc.encode(wave))
    np.testing.assert_allclose(pf.timbre, pc.timbre_of(wave[:, : 16 * HOP]), **TOL)

    jw = jc.decode_streaming(jf, chunk_frames=11)
    pw = pc.decode_streaming(pf, chunk_frames=11)
    assert pw.shape == jw.shape == wave.shape
    np.testing.assert_allclose(pw, jw, **TOL)
    np.testing.assert_allclose(pw, pc.decode(pf), **TOL)
    with pytest.raises(ValueError, match="chunk_frames"):
        pc.decode_streaming(pf, chunk_frames=9)


def test_encode_streaming_short_input_is_one_shot(tiny):
    """Too short to prime (or shorter than two chunks): the one-shot encode."""
    _, pc = _codecs(tiny)
    wave = sweep_wave(1, 30 * HOP / 24000, seed=22)
    f, g = pc.encode_streaming(wave, chunk_frames=16), pc.encode(wave)
    _assert_same_codes(f, g)
    np.testing.assert_array_equal(f.timbre, g.timbre)


# ----------------------------------------------- (g) the CLIs' long route
def _write_wav(path, wave):
    wavfile.write(path, 24000, (np.clip(wave, -1, 1) * 32767).astype(np.int16))
    return str(path)


def _args(add, argv):
    p = argparse.ArgumentParser()
    add(p)
    return p.parse_args(argv)


@pytest.fixture(scope="module")
def cli_env(tiny, tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_cli")
    ckpt = str(d / "codec.bin")
    torch.save({k: {n: torch.tensor(np.array(v)) for n, v in export_state_dict(
        tiny["params"][k], list(tiny["port"][k].state_dict())).items()} for k in CODEC}, ckpt)
    return dict(dir=d, ckpt=ckpt)


def test_cli_long_input_matches_jax(tiny, cli_env, monkeypatch):
    """A 35 s input, over the default --streaming-threshold of 30 s, encodes
    and decodes through the streaming route in both CLIs: the port's `.fac`
    equals the JAX CLI's (codes bit-exact, and the timbre of the first 10 s,
    which differs from the whole input's by far more than the tolerance at
    these weights), and so do the decoded wavs, within 8 LSB."""
    seconds = 35.0
    jc = JFACodec(models=tiny["jm"], params=tiny["params"])

    def from_config(cls, config_path, ckpt_path=None, rng_seed=0, n_c=2, precision="float32"):
        assert (config_path, ckpt_path, n_c) == (TINY, cli_env["ckpt"], 2)
        return jc

    monkeypatch.setattr(JFACodec, "from_config", classmethod(from_config))
    d, tag = cli_env["dir"], f"{seconds:g}"
    src = _write_wav(d / f"long{tag}.wav", 0.5 * sweep_wave(1, seconds, seed=23)[0])
    model = ["--config-path", TINY, "--ckpt-path", cli_env["ckpt"]]
    jfac = j_codec_cli.main_encode(_args(j_codec_cli.add_encode_args, [
        "--input", src, "--output", str(d / f"jax{tag}.fac")] + model))
    pfac = codec_cli.main_encode(_args(codec_cli.add_encode_args, [
        "--input", src, "--output", str(d / f"port{tag}.fac"), "--device", "cpu"] + model))
    jf, pf = JFACodecFile.load(jfac), FACodecFile.load(pfac)
    _assert_same_codes(pf, jf)
    np.testing.assert_allclose(pf.timbre, jf.timbre, **TOL)
    assert pf.metadata["input_db"] == pytest.approx(jf.metadata["input_db"], abs=1e-4)

    want = j_codec_cli.main_decode(_args(j_codec_cli.add_decode_args, [
        "--input", jfac, "--output", str(d / f"jax{tag}.wav")] + model))
    got = codec_cli.main_decode(_args(codec_cli.add_decode_args, [
        "--input", pfac, "--output", str(d / f"port{tag}.wav"), "--device", "cpu"] + model))
    (sra, wa), (srb, wb) = wavfile.read(got), wavfile.read(want)
    assert sra == srb == 24000 and wa.shape == wb.shape == (int(seconds * 24000),)
    assert int(np.abs(wa.astype(np.int32) - wb.astype(np.int32)).max()) <= 8


# ------------------------------------------------------------ (h) latency
@pytest.mark.parametrize("chunk", [None, 1, 4, 16])
@pytest.mark.parametrize("which", ["flagship", "tiny"])
def test_latency_matches_jax(tiny, which, chunk):
    if which == "flagship":
        enc, dec = FLAGSHIP["encoder"], FLAGSHIP["decoder"]
        strides, rates, causal = enc["strides"], dec["rates"], enc["causal"]
        got = codec_latency(strides, rates, causal=causal, chunk_frames=chunk)
    else:
        port = tiny["port"]
        codec = FACodec(port["encoder"], port["quantizer"], port["decoder"])
        strides, rates, causal = codec.encoder.strides, codec.decoder.rates, True
        got = codec.latency(chunk_frames=chunk)
    j_want = j_codec_latency(tuple(strides), tuple(rates), causal=causal, chunk_frames=chunk)
    assert got.as_dict() == j_want.as_dict()
    assert str(got) == str(j_want)
