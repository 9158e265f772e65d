"""The port's codec round trip against the JAX package, on the CPU.

One JAX codec is built from tests/tiny_config.yml with `build_model` +
`init_params`; its parameters move into the port by key name with
`load_jax_params`; both run the same numpy wave. Codes must be bit-exact and
tensors within the JAX package's golden tolerance (tests/test_model_parity.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.models.builder import build_model, init_params
from facodec_tpu.ops.spectral import _mel_filterbank_np as j_mel_filterbank_np
from facodec_tpu.ops.spectral import hann_window as j_hann_window
from facodec_tpu.utils.checkpoint import torch_key_to_path as j_torch_key_to_path
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.models.builder import build_codec, build_from_fields, codec_fields
from facodec_tpu_torch.ops.spectral import _mel_filterbank_np, hann_window_np
from facodec_tpu_torch.utils.signals import sweep_wave
from facodec_tpu_torch.utils.weights import flatten_tree, load_jax_params, torch_key_to_path

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("encoder", "quantizer", "decoder")


def _jax_codec(models, n_c=2):
    enc, qt, dec = (models[k] for k in NAMES)

    def encode(params, wave):
        z = enc.apply({"params": params["encoder"]}, wave[:, :, None])
        outs, _, _, _, timbre, codes = qt.apply(
            {"params": params["quantizer"]}, z, wave, n_c=n_c, return_codes=True)
        return z, outs, codes, timbre

    def decode_codes(params, cp, cc, cr, timbre):
        outs = qt.apply({"params": params["quantizer"]}, cp, cc, cr, timbre,
                        method=qt.decode_from_codes_v2)
        return dec.apply({"params": params["decoder"]}, outs)[:, :, 0]

    def decode_outs(params, outs):
        return dec.apply({"params": params["decoder"]}, outs)[:, :, 0]

    return jax.jit(encode), jax.jit(decode_codes), jax.jit(decode_outs)


def _run_both(jmodels, port_models, wave):
    params = init_params({k: jmodels[k] for k in NAMES}, jax.random.PRNGKey(0))
    for k in NAMES:
        load_jax_params(port_models[k], params[k])
    encode, decode_codes, decode_outs = _jax_codec(jmodels)
    w = jnp.asarray(wave)
    z, outs, codes, timbre = encode(params, w)
    jax_out = dict(
        z=np.asarray(z), outs=np.asarray(outs), timbre=np.asarray(timbre),
        codes=[np.asarray(c) for c in codes],
        decode=np.asarray(decode_codes(params, *codes, timbre)),
        reconstruct=np.asarray(decode_outs(params, outs)),
    )
    codec = FACodec(*(port_models[k] for k in NAMES))
    wt = torch.from_numpy(wave)
    with torch.no_grad():
        p_z = codec.encoder(wt[:, :, None])
    p_outs, p_codes, p_timbre = codec.encode_tensor(wt)
    jcodes = [torch.from_numpy(np.array(c)) for c in jax_out["codes"]]
    port_out = dict(
        z=p_z.numpy(), outs=p_outs.numpy(), timbre=p_timbre.numpy(),
        codes=[c.numpy() for c in p_codes],
        decode=codec.decode_tensor(*jcodes, torch.from_numpy(np.array(jax_out["timbre"]))).numpy(),
        reconstruct=codec.reconstruct(wave),
    )
    return params, jax_out, port_out


@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(os.path.join(ROOT, "tests", "tiny_config.yml"))
    jmodels = build_model(cfg.model_params, "codec")
    port_models = build_codec(cfg.model_params)
    params, jax_out, port_out = _run_both(jmodels, port_models, sweep_wave(2, 0.5))
    return dict(params=params, port=port_models, jax=jax_out, out=port_out)


@pytest.mark.parametrize("name", ["z", "timbre", "outs", "decode", "reconstruct"])
def test_tensors_match_jax(tiny, name):
    got, want = tiny["out"][name], tiny["jax"][name]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stream", [0, 1, 2], ids=["prosody", "content", "residual"])
def test_codes_bit_exact(tiny, stream):
    got, want = tiny["out"]["codes"][stream], tiny["jax"]["codes"][stream]
    assert got.shape == want.shape == (2, (1, 2, 3)[stream], 40)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_key_bijection(tiny, name):
    """Every JAX parameter path is reached by exactly one port key."""
    keys = list(tiny["port"][name].state_dict())
    paths = [torch_key_to_path(k) for k in keys]
    assert len(set(paths)) == len(paths)
    assert set(paths) == set(flatten_tree(tiny["params"][name]))


def test_rehomed_torch_key_to_path(tiny):
    keys = [k for n in NAMES for k in tiny["port"][n].state_dict()] + [
        "module.block.0.conv.conv.weight_v", "block.2.filter", "to_mel.mel_scale.fb",
        "x.to_mel.spectrogram.window", "model.3.block.1.convtr.convtr.weight_g",
        "model.0.parametrizations.weight.original0",
        "model.0.parametrizations.weight.original1",
    ]
    for k in keys:
        assert torch_key_to_path(k) == j_torch_key_to_path(k), k


@pytest.mark.parametrize("n_mels,f_max,norm", [(80, None, None), (20, 8000.0, "slaney")])
def test_rehomed_mel_filterbank(n_mels, f_max, norm):
    got = _mel_filterbank_np(1025, n_mels, 24000, 0.0, f_max, norm)
    want = j_mel_filterbank_np(1025, n_mels, 24000, 0.0, f_max, norm)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hann_window_np(1200), np.asarray(j_hann_window(1200)))


def test_from_fields_defaults_to_the_card(monkeypatch):
    """Without a device argument the codec is built on the card; where torch
    sees none, it raises instead of building on the CPU."""
    cfg = load_config(os.path.join(ROOT, "tests", "tiny_config.yml"))
    fields = codec_fields(cfg.model_params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FACodec.from_fields(fields)
    assert FACodec.from_fields(fields, device="cpu").device.type == "cpu"


def test_import_leaves_jax_out():
    code = ("import sys, facodec_tpu_torch.api, facodec_tpu_torch.ops.kernels.resunit, "
            "facodec_tpu_torch.ops.kernels.vq, facodec_tpu_torch.codec_file, "
            "facodec_tpu_torch.cli.reconstruct, facodec_tpu_torch.cli.codec, "
            "facodec_tpu_torch.cli.convert, facodec_tpu_torch.__main__, "
            "facodec_tpu_torch.models.redecoder, facodec_tpu_torch.utils.config, "
            "facodec_tpu_torch.utils.audio, facodec_tpu_torch.ops.loudness, "
            "facodec_tpu_torch.models.streaming, facodec_tpu_torch.models.latency, "
            "facodec_tpu_torch.cli.stream, facodec_tpu_torch.ops.precision, "
            "facodec_tpu_torch.models.stream_batch, facodec_tpu_torch.cli.serve, "
            "facodec_tpu_torch.cli.stream_serve, facodec_tpu_torch.cli.train, "
            "facodec_tpu_torch.train.loop, facodec_tpu_torch.train.step, "
            "facodec_tpu_torch.train.data, facodec_tpu_torch.models.discriminator, "
            "facodec_tpu_torch.losses, facodec_tpu_torch.ops.gradrev, "
            "facodec_tpu_torch.nn.alias_free, facodec_tpu_torch.profile, "
            "facodec_tpu_torch.ops.resample, facodec_tpu_torch.train.probes, "
            "facodec_tpu_torch.train.redecoder_step, facodec_tpu_torch.train.redecoder_loop, "
            "facodec_tpu_torch.models.jdc, facodec_tpu_torch.ops.metrics, "
            "facodec_tpu_torch.cli.evaluate, facodec_tpu_torch.cli.extract_targets, "
            "facodec_tpu_torch.cli.assemble_data, facodec_tpu_torch.ops.kernels.ops, "
            "facodec_tpu_torch.ops.kernels.build, facodec_tpu_torch.nn.conv, "
            "facodec_tpu_torch.utils.export, facodec_tpu_torch.cli.export_model, "
            "facodec_tpu_torch.bench, facodec_tpu_torch.bench_streaming, "
            "facodec_tpu_torch.bench_train, facodec_tpu_torch.utils.profiling, "
            "facodec_tpu_torch.utils.flops, facodec_tpu_torch.parallel.sharding, "
            "facodec_tpu_torch.cli.validate, facodec_tpu_torch.webui, "
            "facodec_tpu_torch.ops.kernels.lstm, facodec_tpu_torch.nn.lstm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'facodec_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.slow
def test_flagship_parity():
    """Flagship widths (latent 1024, style hidden 512, decoder 1536), 0.5 s."""
    sys.path.insert(0, ROOT)
    from __graft_entry__ import FLAGSHIP as J_FLAGSHIP
    from facodec_tpu.models.dac import Decoder, Encoder
    from facodec_tpu.models.fa_quantizer import FAquantizer
    from facodec_tpu_torch.config import FLAGSHIP

    assert FLAGSHIP == J_FLAGSHIP
    jmodels = dict(encoder=Encoder(**J_FLAGSHIP["encoder"]),
                   quantizer=FAquantizer(**J_FLAGSHIP["quantizer"]),
                   decoder=Decoder(**J_FLAGSHIP["decoder"]))
    _, want, got = _run_both(jmodels, build_from_fields(FLAGSHIP), sweep_wave(1, 0.5))
    for c_got, c_want in zip(got["codes"], want["codes"]):
        np.testing.assert_array_equal(c_got, c_want)
    for name in ("outs", "decode", "reconstruct"):
        np.testing.assert_allclose(got[name], want[name], **TOL)
