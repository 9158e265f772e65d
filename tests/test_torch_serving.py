"""The port's serving surface against the JAX package, on the CPU: torch
checkpoints, `.fac` files, stream subsets, voice conversion, the host-side
copies (loudness, config, wav), the four CLIs and the `evaluate` scorecard.

One torch checkpoint file per stage is written from JAX parameters of the
tiny config with the JAX package's own `export_state_dict`, under the port's
keys; both packages then read tests/tiny_config.yml and that file.
Codes must be bit-exact, tensors within the JAX package's golden tolerance
(tests/test_model_parity.py), and 16-bit wav files within 8 LSB (2e-4 of
full scale, plus rounding).
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

import facodec_tpu.native
from facodec_tpu.api import FACodec as JFACodec
from facodec_tpu.api import FARedecoder as JFARedecoder
from facodec_tpu.api import convert_voice as j_convert_voice
from facodec_tpu.api import load_inference_params
from facodec_tpu.cli import codec as j_codec_cli
from facodec_tpu.cli import convert as j_convert_cli
from facodec_tpu.cli import reconstruct as j_reconstruct_cli
from facodec_tpu.codec_file import FACodecFile as JFACodecFile
from facodec_tpu.ops import loudness as j_loudness
from facodec_tpu.train.data import load_wav as j_load_wav
from facodec_tpu.utils.checkpoint import export_state_dict
from facodec_tpu.utils.config import load_config as j_load_config
from facodec_tpu_torch import __main__ as port_main
from facodec_tpu_torch.api import FACodec, FARedecoder, convert_voice
from facodec_tpu_torch.cli import codec as codec_cli
from facodec_tpu_torch.cli import reconstruct as reconstruct_cli
from facodec_tpu_torch.codec_file import FACodecFile
from facodec_tpu_torch.models.builder import build_codec, build_redecoder, codec_fields
from facodec_tpu_torch.ops import loudness
from facodec_tpu_torch.utils.audio import load_wav
from facodec_tpu_torch.utils.config import load_config
from facodec_tpu_torch.utils.signals import sweep_wave
from facodec_tpu_torch.utils.weights import init_random_

TOL = dict(rtol=2e-4, atol=2e-4)
WAV_LSB = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
CODEC = ("encoder", "quantizer", "decoder")
REDECODER = ("encoder", "decoder")
SUBSETS = [(p, c, r) for p in (True, False) for c in (True, False) for r in (True, False)
           if p or c or r]


def _wrapped(key: str) -> str:
    """A key in the form a DDP training checkpoint with parametrized weight
    norm writes it."""
    key = key.replace("weight_g", "parametrizations.weight.original0")
    return "module." + key.replace("weight_v", "parametrizations.weight.original1")


def _save_ckpt(path, params, port_models, names, rename=lambda k: k):
    torch.save({name: {rename(k): torch.tensor(np.array(v)) for k, v in export_state_dict(
        params[name], list(port_models[name].state_dict())).items()} for name in names}, path)
    return str(path)


def _write_wav(path, wave, sr=24000):
    wavfile.write(path, sr, (np.clip(wave, -1, 1) * 32767).astype(np.int16))
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once: eight spinning threads each thrash
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """JAX `from_config` builds each stage with random weights, which are
    written to torch files; JAX reads them back through its checkpoint
    loader (`load_inference_params`, the body of `from_config` for a `.bin`
    path, with the random weights as its templates) and the port through
    `from_config`."""
    d = tmp_path_factory.mktemp("serving")
    cfg = load_config(TINY)
    jc0, jr0 = JFACodec.from_config(TINY, rng_seed=1), JFARedecoder.from_config(TINY, rng_seed=2)
    port_codec, port_red = build_codec(cfg.model_params), build_redecoder(cfg.model_params)
    ckpt = dict(
        codec=_save_ckpt(d / "codec.bin", jc0.params, port_codec, CODEC),
        codec_wrapped=_save_ckpt(d / "codec_wrapped.bin", jc0.params, port_codec, CODEC,
                                 _wrapped),
        redecoder=_save_ckpt(d / "redecoder.bin", jr0.params, port_red, REDECODER),
    )
    params = load_inference_params(ckpt["codec"], CODEC, templates=jc0.params)
    jc = JFACodec(models=jc0.models, params=params)
    jr = JFARedecoder(models=jr0.models, params=load_inference_params(
        ckpt["redecoder"], REDECODER, templates=jr0.params))
    pc = FACodec.from_config(TINY, ckpt["codec"], device="cpu")
    pr = FARedecoder.from_config(TINY, ckpt["redecoder"], device="cpu")
    # the CLIs' inputs: their one-second waves, written and read back, are
    # the waves of the API tests too, so that both share JAX's compiles
    src_wav = _write_wav(d / "src.wav", 0.5 * sweep_wave(1, 1.0, seed=4)[0])
    tgt_wav = _write_wav(d / "tgt.wav", 0.3 * sweep_wave(1, 1.0, seed=5)[0])
    wave, target = j_load_wav(src_wav)[None], j_load_wav(tgt_wav)[None]
    jf, pf = jc.encode(wave), pc.encode(wave)
    return dict(dir=d, ckpt=ckpt, params=params, jc=jc, pc=pc, jr=jr, pr=pr, wave=wave,
                target=target, jf=jf, pf=pf, src_wav=src_wav, tgt_wav=tgt_wav,
                jc1=JFACodec(models=jc.models, params=jc.params, n_c=1),
                pc1=FACodec(pc.encoder, pc.quantizer, pc.decoder, n_c=1))


@pytest.fixture
def jax_cli_models(env, monkeypatch):
    """The JAX CLIs build their models with `from_config` from the same
    config and checkpoint files as the fixture did; hand them the fixture's
    instances, whose compiles are warm, after checking the arguments."""
    def codec(cls, config_path, ckpt_path=None, rng_seed=0, n_c=2, precision="float32"):
        assert (config_path, ckpt_path, precision) == (TINY, env["ckpt"]["codec"], "float32")
        return env["jc"] if n_c == 2 else env["jc1"]

    def redecoder(cls, config_path, ckpt_path=None, rng_seed=0):
        assert (config_path, ckpt_path) == (TINY, env["ckpt"]["redecoder"])
        return env["jr"]

    monkeypatch.setattr(JFACodec, "from_config", classmethod(codec))
    monkeypatch.setattr(JFARedecoder, "from_config", classmethod(redecoder))


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("stream", ["codes_p", "codes_c", "codes_r"])
def test_checkpoint_codes_bit_exact(env, stream):
    """One torch checkpoint read by both packages' from_config."""
    got, want = getattr(env["pf"], stream), getattr(env["jf"], stream)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(env["pf"].timbre, env["jf"].timbre, **TOL)


def test_checkpoint_decode_matches_jax(env):
    np.testing.assert_allclose(env["pc"].decode(env["jf"]), env["jc"].decode(env["jf"]), **TOL)
    np.testing.assert_allclose(env["pc"].reconstruct(env["wave"]),
                               env["jc"].reconstruct(env["wave"]), **TOL)


def test_checkpoint_wrapped_keys(env):
    """`module.` prefixes and parametrized weight-norm keys load to the same
    weights in both packages."""
    path = env["ckpt"]["codec_wrapped"]
    pc = FACodec.from_config(TINY, path, device="cpu")
    for name in CODEC:
        for (k, a), b in zip(getattr(pc, name).state_dict().items(),
                             getattr(env["pc"], name).state_dict().values()):
            assert torch.equal(a, b), k
    jparams = load_inference_params(path, CODEC, templates=env["params"])
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(env["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fault", ["missing_key", "extra_key", "missing_module", "shape"])
def test_checkpoint_rejects(env, fault):
    ckpt = torch.load(env["ckpt"]["codec"], weights_only=True)
    if fault == "missing_key":
        del ckpt["decoder"][next(iter(ckpt["decoder"]))]
    elif fault == "extra_key":
        ckpt["decoder"]["model.0.extra"] = torch.zeros(3)
    elif fault == "missing_module":
        del ckpt["quantizer"]
    else:
        key = next(iter(ckpt["encoder"]))
        ckpt["encoder"][key] = torch.zeros(1, 2, 3)
    path = env["dir"] / f"bad_{fault}.bin"
    torch.save(ckpt, path)
    with pytest.raises(ValueError, match="load_torch_checkpoint"):
        FACodec.from_config(TINY, str(path), device="cpu")


def test_init_random_draws_embeddings_normal():
    """Code embeddings and codebooks are N(0, 1) tables, as the JAX
    `Embedding` initialiser draws them, not uniform conv weights."""
    red = build_redecoder(load_config(TINY).model_params)["encoder"]
    init_random_(red, torch.Generator().manual_seed(0))
    for table in (red.prosody_embed[0].weight.detach(), red.content_embed[1].weight.detach()):
        assert abs(float(table.std()) - 1.0) < 0.1 and float(table.abs().max()) > 2.0


# -------------------------------------------------------- stream subsets
@pytest.mark.parametrize("subset", SUBSETS, ids=["".join("pcr"[i] for i in range(3) if s[i])
                                                 for s in SUBSETS])
def test_decode_subset_matches_jax(env, subset):
    got = env["pc"].decode_subset(env["jf"], *subset)
    want = env["jc"].decode_subset(env["jf"], *subset)
    assert got.shape == want.shape == env["wave"].shape
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_without_residual_matches_jax(env):
    got = env["pc"].decode(env["jf"], use_residual=False)
    np.testing.assert_allclose(got, env["jc"].decode(env["jf"], use_residual=False), **TOL)
    np.testing.assert_array_equal(got, env["pc"].decode_subset(env["jf"], True, True, False))


def test_decode_empty_subset_raises(env):
    with pytest.raises(ValueError, match="at least one stream"):
        env["pc"].decode_subset(env["jf"], False, False, False)


def test_decode_rejects_codes_out_of_range(env):
    f = dataclasses.replace(env["pf"], codes_c=env["pf"].codes_c + 32)
    with pytest.raises(ValueError, match="out of range"):
        env["pc"].decode(f)


# ------------------------------------------------------------ .fac files
def _fields(f):
    return (f.codes_p, f.codes_c, f.codes_r, f.timbre, f.sample_rate, f.hop_length,
            f.original_length, f.metadata)


def _assert_same_file(a, b, timbre_tol=None):
    """Equal fields; the timbre within `timbre_tol` where given (files of
    two encoders)."""
    for name, x, y in zip(("codes_p", "codes_c", "codes_r", "timbre"), _fields(a), _fields(b)):
        if x is None or y is None:
            assert x is None and y is None, name
        elif name == "timbre" and timbre_tol:
            np.testing.assert_allclose(x, y, **timbre_tol)
        else:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y)
    assert _fields(a)[4:] == _fields(b)[4:]


def test_fac_from_jax_decodes_in_port(env):
    jf = dataclasses.replace(env["jf"], metadata={"input_db": -23.5})
    path = jf.save(str(env["dir"] / "from_jax"))
    f = FACodecFile.load(path)
    _assert_same_file(f, JFACodecFile.load(path))
    np.testing.assert_allclose(env["pc"].decode(f), env["jc"].decode(jf), **TOL)
    _assert_same_file(FACodecFile.from_bytes(jf.to_bytes()), f)


@pytest.mark.parametrize("residual", [True, False], ids=["with_r", "without_r"])
def test_fac_from_port_loads_in_jax(env, residual):
    pf = dataclasses.replace(env["pf"], metadata={"input_db": -19.25},
                             codes_r=env["pf"].codes_r if residual else None)
    path = pf.save(str(env["dir"] / f"from_port_{residual}.fac"))
    _assert_same_file(JFACodecFile.load(path), pf)
    _assert_same_file(JFACodecFile.from_bytes(pf.to_bytes()), pf)


def _malformed(case):
    B, T = 2, 10
    f = dict(codes_p=np.zeros((B, 1, T), np.uint16), codes_c=np.zeros((B, 2, T), np.uint16),
             codes_r=np.zeros((B, 3, T), np.uint16), timbre=np.zeros((B, 64), np.float32))
    if case == "rank":
        f["codes_c"] = np.zeros((B, T), np.uint16)
    elif case == "frames":
        f["codes_r"] = np.zeros((B, 3, T + 1), np.uint16)
    elif case == "float_codes":
        f["codes_c"] = np.zeros((B, 2, T), np.float32)
    elif case == "timbre":
        f["timbre"] = np.zeros((B + 1, 64), np.float32)
    elif case == "length":
        f["original_length"] = -1
    return f


@pytest.mark.parametrize("case", ["rank", "frames", "float_codes", "timbre", "length"])
def test_fac_validate_rejects_as_jax(case):
    for cls in (JFACodecFile, FACodecFile):
        with pytest.raises(ValueError):
            cls(**_malformed(case)).validate()


def test_fac_rejects_foreign_file(env):
    path = str(env["dir"] / "foreign.npz")
    np.savez(path, __header__=np.asarray([repr(dict(magic="other"))]))
    with pytest.raises(ValueError, match="not a facodec-tpu code file"):
        FACodecFile.load(path)


# ------------------------------------------------------- voice conversion
def test_convert_voice_matches_jax(env):
    want = j_convert_voice(env["jc1"], env["jr"], env["wave"], env["target"])
    got = convert_voice(env["pc1"], env["pr"], env["wave"], env["target"])
    assert got.shape == want.shape == env["wave"].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_default_device_raises_without_cuda(env, monkeypatch):
    """Without a device argument the entry points build on the card; where
    torch sees none they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields = codec_fields(load_config(TINY).model_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FARedecoder.from_config(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FACodec.from_config(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FACodec.from_fields(fields, ckpt_path=env["ckpt"]["codec"])
    for argv in (["reconstruct", "--source", env["src_wav"]],
                 ["convert", "--source", env["src_wav"], "--target", env["tgt_wav"]]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_main.main(argv + ["--config-path" if argv[0] == "reconstruct"
                                   else "--codec-config", TINY])


# ------------------------------------------------------ host-side copies
def _loudness_cases():
    rng = np.random.default_rng(0)
    t = np.arange(48000) / 24000
    return dict(
        sine=0.3 * np.sin(2 * np.pi * 440 * t),
        noise=0.05 * rng.standard_normal(72000),
        quiet=1e-3 * rng.standard_normal(24000),
        silence=np.zeros(24000),
        short=0.5 * rng.standard_normal(5000),
        stereo=0.2 * rng.standard_normal((2, 30000)),
        loud=np.clip(3.0 * np.sin(2 * np.pi * 100 * t), -1, 1),
    )


@pytest.mark.parametrize("case", list(_loudness_cases()))
def test_loudness_matches_jax(case):
    x = _loudness_cases()[case].astype(np.float32)
    want, got = j_loudness.integrated_loudness(x, 24000), loudness.integrated_loudness(x, 24000)
    assert got == want or (np.isneginf(got) and np.isneginf(want))
    if x.ndim == 1:
        (gw, gl), (ww, wl) = (loudness.normalize_loudness(x, 24000, -16.0),
                              j_loudness.normalize_loudness(x, 24000, -16.0))
        np.testing.assert_array_equal(gw, ww)
        assert gl == wl or (np.isneginf(gl) and np.isneginf(wl))


def test_load_config_matches_jax(monkeypatch):
    got, want = load_config(TINY), j_load_config(TINY)
    assert got == want
    assert got.model_params.DAC.decoder_rates == want.model_params.DAC.decoder_rates
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        load_config(TINY)


@pytest.mark.parametrize("channels", [1, 2])
def test_load_wav_scales_int16(env, channels):
    """int16 samples are divided by 32768 and stereo is averaged, whatever
    reader the JAX package has."""
    data = np.array([-32768, -16384, -1, 0, 1, 16384, 32767], np.int16)
    frames = np.stack([data, data[::-1]], axis=1) if channels > 1 else data
    path = str(env["dir"] / f"scale{channels}.wav")
    wavfile.write(path, 24000, frames)
    got = load_wav(path)
    want = frames.astype(np.float32) / 32768.0
    want = want.mean(axis=1) if channels > 1 else want
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2])
def test_load_wav_matches_jax(env, channels):
    """The JAX CLI's reader is the native one where it builds (int16 / 32768)."""
    if not facodec_tpu.native.available():
        pytest.skip("the JAX package's native wav reader did not build (needs g++)")
    rng = np.random.default_rng(channels)
    data = rng.integers(-32768, 32768, (24000, channels) if channels > 1 else 24000)
    path = str(env["dir"] / f"pcm{channels}.wav")
    wavfile.write(path, 24000, data.astype(np.int16))
    got, want = load_wav(path), j_load_wav(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(got).max()) <= 1.0


# the JAX CLI's reader resamples other rates on the fly; odd lengths, so the
# last output position falls past the last input sample and is clamped
RESAMPLE_CASES = [(16000, 16001), (22050, 22053), (44100, 44103), (48000, 48007)]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("file_sr,n_in", RESAMPLE_CASES)
def test_load_wav_resamples_as_jax(tmp_path, file_sr, n_in, channels):
    """At another rate the port reads what the JAX CLI's native reader reads,
    within 1e-6 (its float64 positions and clamp, copied in numpy)."""
    if not facodec_tpu.native.available():
        pytest.skip("the JAX package's native wav reader did not build (needs g++)")
    rng = np.random.default_rng(file_sr + channels)
    data = rng.integers(-32768, 32768, (n_in, channels) if channels > 1 else n_in)
    path = str(tmp_path / f"sr{file_sr}_{channels}.wav")
    wavfile.write(path, file_sr, data.astype(np.int16))
    got, want = load_wav(path), facodec_tpu.native.load_wav_native(path, 24000)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("file_sr,n_in", RESAMPLE_CASES)
def test_load_wav_resample_rule(tmp_path, file_sr, n_in):
    """floor(n_in * 24000 / file_sr) samples; sample i is the linear
    interpolation at i * file_sr / 24000, clamped at the last input sample."""
    data = (np.arange(n_in) % 2000 - 1000).astype(np.int16) * 16
    path = str(tmp_path / f"rule{file_sr}.wav")
    wavfile.write(path, file_sr, data)
    got = load_wav(path)
    assert len(got) == n_in * 24000 // file_sr
    x = data.astype(np.float64) / 32768.0
    pos = np.arange(len(got)) * (file_sr / 24000)
    j = pos.astype(np.int64)
    a, b = x[np.minimum(j, n_in - 1)], x[np.minimum(j + 1, n_in - 1)]
    want = a + (b - a) * (pos - j)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ CLIs
def _args(add, argv):
    p = argparse.ArgumentParser()
    add(p)
    return p.parse_args(argv)


def _assert_wavs_close(a, b):
    (sra, wa), (srb, wb) = wavfile.read(a), wavfile.read(b)
    assert sra == srb == 24000 and wa.dtype == wb.dtype == np.int16 and wa.shape == wb.shape
    assert int(np.abs(wa.astype(np.int32) - wb.astype(np.int32)).max()) <= WAV_LSB


def test_cli_reconstruct_matches_jax(env, jax_cli_models):
    d, model = env["dir"], ["--config-path", TINY, "--ckpt-path", env["ckpt"]["codec"]]
    argv = ["--source", env["src_wav"]] + model
    want = j_reconstruct_cli.main(_args(j_reconstruct_cli.add_args,
                                        argv + ["--output", str(d / "rec_jax.wav")]))
    got = reconstruct_cli.main(_args(reconstruct_cli.add_args,
                                     argv + ["--output", str(d / "rec.wav"), "--device", "cpu"]))
    _assert_wavs_close(got, want)


@pytest.mark.parametrize("residual", [True, False], ids=["with_r", "no_residual"])
def test_cli_encode_decode_match_jax(env, jax_cli_models, residual):
    d, model = env["dir"], ["--config-path", TINY, "--ckpt-path", env["ckpt"]["codec"]]
    enc = ["--input", env["src_wav"]] + model
    jfac = j_codec_cli.main_encode(_args(j_codec_cli.add_encode_args,
                                         enc + ["--output", str(d / "jax.fac")]))
    pfac = codec_cli.main_encode(_args(codec_cli.add_encode_args,
                                       enc + ["--output", str(d / "port.fac"), "--device", "cpu"]))
    jf, pf = JFACodecFile.load(jfac), FACodecFile.load(pfac)
    _assert_same_file(pf, jf, timbre_tol=TOL)
    assert np.isfinite(pf.metadata["input_db"])
    dec = model + (["--no-residual"] if not residual else [])
    want = j_codec_cli.main_decode(_args(j_codec_cli.add_decode_args, dec + [
        "--input", jfac, "--output", str(d / f"dec_jax_{residual}.wav")]))
    got = codec_cli.main_decode(_args(codec_cli.add_decode_args, dec + [
        "--input", pfac, "--output", str(d / f"dec_{residual}.wav"), "--device", "cpu"]))
    _assert_wavs_close(got, want)
    # decode restored the input's loudness
    restored = load_wav(got)
    assert abs(loudness.integrated_loudness(restored, 24000) - pf.metadata["input_db"]) < 1.5


@pytest.mark.parametrize("flags", [[], ["--use-p-code"]], ids=["plain", "use_p_code"])
def test_cli_convert_matches_jax(env, jax_cli_models, flags):
    """Every command line of the JAX CLI gives its wave, `--use-p-code`
    (accepted there and without effect) included."""
    d, tag = env["dir"], "".join(flags)
    argv = ["--source", env["src_wav"], "--target", env["tgt_wav"],
            "--codec-config", TINY, "--codec-ckpt", env["ckpt"]["codec"],
            "--redecoder-config", TINY, "--redecoder-ckpt", env["ckpt"]["redecoder"]] + flags
    want = j_convert_cli.main(_args(j_convert_cli.add_args,
                                    argv + ["--output", str(d / f"vc_jax{tag}.wav")]))
    got = port_main.main(["convert"] + argv + ["--output", str(d / f"vc{tag}.wav"),
                                               "--device", "cpu"])
    _assert_wavs_close(got, want)


# ------------------------------------------------------------ evaluate
# Scorecard metrics, port against JAX: the decodes agree within the golden
# tolerance (above), and the metrics computed from them (dB, STOI, the
# losses) within 1e-4, absolute and relative; NaN where JAX's is NaN.
EVAL_TOL = dict(rtol=1e-4, atol=1e-4)


def _assert_scorecards_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):  # code_usage: counts of distinct codes, exact
            assert got[k] == v, k
        elif isinstance(v, str):  # the wav's path
            assert os.path.basename(got[k]) == os.path.basename(v), k
        elif v is None or np.isnan(v):
            assert got[k] is None or np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **EVAL_TOL)


@pytest.fixture(scope="module")
def j_scorecard(env):
    """JAX's scorecard of the fixture's wave (its compiles are warm)."""
    from facodec_tpu.cli.evaluate import evaluate_utterance as j_evaluate_utterance

    return j_evaluate_utterance(env["jc"], env["wave"][0])


def test_evaluate_utterance_matches_jax(env, j_scorecard):
    from facodec_tpu_torch.cli.evaluate import evaluate_utterance

    got = evaluate_utterance(env["pc"], env["wave"][0])
    assert "f0_corr_prosody" in got and np.isfinite(got["si_sdr_db"])
    _assert_scorecards_close(got, j_scorecard)


def test_cli_evaluate_matches_jax(env, j_scorecard):
    """`evaluate.main` on tests/tiny_config.yml with --device cpu, on a
    two-row manifest: the JSON row of the fixture's wave is JAX's scorecard
    (NaN as null), and the aggregate is the NaN-skipping mean of the rows."""
    from facodec_tpu.cli.evaluate import jsonsafe as j_jsonsafe
    from facodec_tpu_torch.cli import evaluate

    d = env["dir"]
    manifest = d / "eval.txt"
    manifest.write_text(f"{env['src_wav']}\t1\ten\tx\ty\n{env['tgt_wav']}\t2\ten\tx\ty\n")
    assert evaluate.main(["--manifest", str(manifest), "--config-path", TINY, "--ckpt-path",
                          env["ckpt"]["codec"], "--json", str(d / "eval.json"),
                          "--device", "cpu"]) == 0
    out = json.loads((d / "eval.json").read_text())
    rows = out["utterances"]
    assert len(rows) == 2 and rows[0]["path"] == env["src_wav"]
    _assert_scorecards_close({k: v for k, v in rows[0].items() if k != "path"},
                             j_jsonsafe(j_scorecard))
    assert set(out["aggregate"]) == set(evaluate.AGG_KEYS)
    for k, v in out["aggregate"].items():
        vals = [r[k] for r in rows if r[k] is not None]
        if vals:
            np.testing.assert_allclose(v, np.mean(vals), rtol=1e-12, err_msg=k)
        else:
            assert v is None, k
