"""AOT export and serving from an artifact in the port (facodec_tpu_torch/
utils/export.py, cli/export_model.py, cli/serve.py `ArtifactService`), on
the CPU at the tiny config's widths: each exported function against the
port's live codec (bit for bit), against the JAX package's own artifacts
and `ArtifactService` on the same weights (`load_jax_params`), the kernels'
custom ops under `torch.library.opcheck`, and the exported graphs' nodes.
"""

import json
import os
import subprocess
import sys
import urllib.request
import zipfile
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.api import FACodec as JaxFACodec
from facodec_tpu.cli import serve as jserve
from facodec_tpu.models.builder import build_model, init_params
from facodec_tpu.utils import export as jexport
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch import __main__ as port_main
from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.cli import load_codec, serve
from facodec_tpu_torch.models.builder import build_codec
from facodec_tpu_torch.ops import precision as port_precision
from facodec_tpu_torch.ops.kernels import resunit
from facodec_tpu_torch.utils import export
from facodec_tpu_torch.utils.weights import init_random_, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
CODEC = ("encoder", "quantizer", "decoder")
SR, HOP = 24000, 300
BATCH, SECONDS = 2, 0.6
T = int(SECONDS * SR) // HOP * HOP
TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX package's golden tolerance
# the bf16 decoder against JAX's (tests/test_torch_precision.py): err / scale
HYBRID_RMS, HYBRID_WORST = 2e-2, 8e-2


def tone(seconds=SECONDS, hz=220.0, seed=0):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))
            ).astype(np.float32)


def waves():
    """(BATCH, T) float32 waves, and their ragged true lengths (int32)."""
    w = np.stack([tone(hz=170.0 + 90 * i, seed=i)[:T] for i in range(BATCH)])
    lens = np.array([T, 7 * HOP + 120], np.int32)
    w[1, lens[1]:] = 0.0
    return w, lens


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    cfg = load_config(TINY)
    models = build_model(cfg.model_params, "codec")
    models = {k: models[k] for k in CODEC}
    return models, init_params(models, jax.random.PRNGKey(0), seg_frames=4)


@pytest.fixture(scope="module")
def live(jax_params):
    """The port's live codec on the JAX weights: {precision: FACodec}."""
    port = build_codec(load_config(TINY).model_params)
    params = jax.tree.map(np.asarray, jax_params[1])
    for k in CODEC:
        load_jax_params(port[k], params[k])
    return {p: FACodec(*(port[k] for k in CODEC), precision=p) for p in ("float32", "hybrid")}


@pytest.fixture(scope="module")
def ckpt(live, tmp_path_factory):
    """The JAX weights as a port checkpoint, one state dict per module."""
    path = str(tmp_path_factory.mktemp("ckpt") / "codec.pth")
    torch.save({k: getattr(live["float32"], k).state_dict() for k in CODEC}, path)
    return path


@pytest.fixture(scope="module")
def artifacts(ckpt, tmp_path_factory):
    """{precision: artifact dir}, each made by `python -m facodec_tpu_torch
    export` from the checkpoint."""
    dirs = {}
    for p in ("float32", "hybrid"):
        dirs[p] = str(tmp_path_factory.mktemp(f"artifact_{p}"))
        assert port_main.main(["export", "--out", dirs[p], "--config-path", TINY,
                               "--ckpt-path", ckpt, "--batch", str(BATCH), "--seconds",
                               str(SECONDS), "--precision", p, "--device", "cpu"]) == 0
    return dirs


@pytest.fixture(scope="module")
def exported(artifacts):
    """{precision: ExportedCodec}: each program loads once for the module."""
    return {p: export.ExportedCodec(d) for p, d in artifacts.items()}


@pytest.fixture(scope="module")
def jax_artifacts(jax_params, tmp_path_factory):
    models, params = jax_params
    dirs = {}
    for p in ("float32", "hybrid"):
        dirs[p] = str(tmp_path_factory.mktemp(f"jax_artifact_{p}"))
        codec = JaxFACodec(models=models, params=params, n_c=2, precision=p)
        jexport.export_codec(codec, dirs[p], batch=BATCH, seconds=SECONDS)
    return dirs


# ------------------------------------------------- against the live port
@pytest.mark.parametrize("precision", ["float32", "hybrid"])
def test_artifact_functions_equal_live(live, exported, precision):
    """All five functions, bit for bit the live codec's."""
    codec, exp = live[precision], exported[precision]
    meta = exp.meta
    assert meta["format"] == "facodec-torch-export" and meta["device"] == "cpu"
    assert (meta["precision"], meta["batch"], meta["frames"]) == (precision, BATCH, T // HOP)
    params = export.codec_params(codec)
    w, lens = (torch.from_numpy(a) for a in waves())
    _, codes, timbre = codec.encode_tensor(w)
    got = exp.encode(params, w)
    for a, b in zip(got, (*codes, timbre)):
        assert torch.equal(a, b)
    assert torch.equal(exp.decode(params, *got), codec.decode_tensor(*codes, timbre))
    assert torch.equal(exp.reconstruct(params, w), codec.decode_latent(codec.encode_tensor(w)[0]))
    outs, codes, timbre = codec.encode_tensor(w, lens)
    for a, b in zip(exp.encode_masked(params, w, lens), (*codes, timbre)):
        assert torch.equal(a, b)
    assert torch.equal(exp.reconstruct_masked(params, w, lens), codec.decode_latent(outs))


def test_artifact_takes_the_weights_as_input(live, artifacts, exported):
    """The artifact stores no parameter: each program's archive holds no
    weights and no constant but the mel window and filterbank (the decode
    none), and a second, different seeded state dict gives that codec's
    output."""
    for p in ("float32", "hybrid"):
        for name in export.FUNCTIONS:
            with zipfile.ZipFile(os.path.join(artifacts[p], f"{name}.pt2")) as z:
                stored = {i.filename: i.file_size for i in z.infolist()}
            tensors = {f: n for f, n in stored.items() if "/data/" in f and n
                       and not f.endswith("_config.json")}
            assert sorted(tensors.values()) == ([] if name == "decode" else
                                                [2048 * 4, 1025 * 80 * 4]), tensors
            assert all("/data/constants/" in f for f in tensors), tensors
    other = build_codec(load_config(TINY).model_params)
    gen = torch.Generator().manual_seed(7)
    for k in CODEC:
        init_random_(other[k], gen)
    codec2 = FACodec(*(other[k] for k in CODEC), precision="hybrid")
    exp = exported["hybrid"]
    w, lens = (torch.from_numpy(a) for a in waves())
    got = exp.reconstruct_masked(export.codec_params(codec2), w, lens)
    assert torch.equal(got, codec2.decode_latent(codec2.encode_tensor(w, lens)[0]))
    first = exp.reconstruct_masked(export.codec_params(live["hybrid"]), w, lens)
    assert not torch.allclose(got, first)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_artifact_rejects_bad_params(live, exported, fault):
    params = dict(export.codec_params(live["float32"]))
    if fault == "missing":
        del params["decoder.model.0.bias"]
    elif fault == "extra":
        params["decoder.extra"] = torch.zeros(1)
    else:
        params["encoder.block.0.bias"] = torch.zeros(3)
    w, _ = waves()
    match = {"missing": "missing", "extra": "left over", "shape": "shape"}[fault]
    with pytest.raises(ValueError, match=match):
        exported["float32"].reconstruct(params, torch.from_numpy(w))


def test_load_params_from_checkpoint(live, exported, ckpt, tmp_path):
    """`load_params` reads a port checkpoint by the artifact's keys, with
    `load_torch_checkpoint`'s checks."""
    exp = exported["float32"]
    params = exp.load_params(ckpt)
    want = export.codec_params(live["float32"])
    assert list(params) == list(want)
    assert all(torch.equal(params[k], want[k]) for k in want)
    state = torch.load(ckpt, weights_only=True)
    del state["decoder"]["model.0.bias"]
    bad = str(tmp_path / "bad.pth")
    torch.save(state, bad)
    with pytest.raises(ValueError, match="without a checkpoint parameter"):
        exp.load_params(bad)


def test_jax_artifact_rejected(jax_artifacts, tmp_path):
    with pytest.raises(ValueError, match="not a facodec-torch export"):
        export.ExportedCodec(jax_artifacts["float32"])
    (tmp_path / "meta.json").write_text('{"format": "something-else"}')
    with pytest.raises(ValueError, match="not a facodec-torch export"):
        export.ExportedCodec(str(tmp_path))


def test_export_cli_refuses_unported_policy(jax_params, ckpt, monkeypatch, tmp_path):
    """`export --precision bfloat16`, once refused, hands `export_codec` the
    bfloat16 codec it loads. Its artifact (here of the two functions
    `ArtifactService` encodes and decodes with, exported from the codec the
    CLI loads) holds the float32-in/out residual-unit op (12 each) and
    computes the live bfloat16 codec's bits; against JAX's bfloat16
    artifact its codes are equal and its decode within the bf16 decode's
    recorded departure; `ArtifactService` serves it. `hybrid_int8` is
    refused as the JAX package's export refuses it (its policy() does not
    know the name)."""
    models, params = jax_params
    d = str(tmp_path / "bf16")
    seen = {}
    with monkeypatch.context() as m:
        m.setattr(export, "export_codec",
                  lambda codec, out, **kw: seen.update(precision=codec.precision, out=out, **kw)
                  or {})
        assert port_main.main(["export", "--out", d, "--config-path", TINY, "--ckpt-path",
                               ckpt, "--batch", str(BATCH), "--seconds", str(SECONDS),
                               "--precision", "bfloat16", "--device", "cpu"]) == 0
    assert seen == dict(precision="bfloat16", out=d, batch=BATCH, seconds=SECONDS)
    codec = load_codec(TINY, ckpt, 2, "cpu", "bfloat16")
    export.export_codec(codec, d, batch=BATCH, seconds=SECONDS,
                        functions=("encode_masked", "decode"))
    port = export.ExportedCodec(d)
    assert port.meta["precision"] == "bfloat16"
    assert sorted(port.meta["functions"]) == ["decode", "encode_masked"]
    for name in ("encode_masked", "decode"):
        counts = Counter(str(n.target) for n in port.program(name).graph.nodes
                         if n.op == "call_function")
        assert {k: v for k, v in counts.items() if "resunit" in k} == {
            "facodec.resunit_bf16_f32io.default": 12}, name
    tparams = export.codec_params(codec)
    w, lens = waves()
    tw, tl = torch.from_numpy(w), torch.from_numpy(lens)
    got = port.encode_masked(tparams, tw, tl)
    _, codes, timbre = codec.encode_tensor(tw, tl)
    for a, b in zip(got, (*codes, timbre)):
        assert torch.equal(a, b)
    y = port.decode(tparams, *got)
    assert torch.equal(y, codec.decode_tensor(*codes, timbre))

    jd = str(tmp_path / "jax_bf16")
    jexport.export_codec(JaxFACodec(models=models, params=params, n_c=2, precision="bfloat16"),
                         jd, batch=BATCH, seconds=SECONDS)
    jexp = jexport.ExportedCodec(jd)
    want = jexp.encode_masked(params, jnp.asarray(w), jnp.asarray(lens))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    yj = np.asarray(jexp.decode(params, *(jnp.asarray(a.numpy()) for a in got)))
    scale = np.abs(yj).max()
    rms = np.sqrt(np.mean((y.numpy() - yj) ** 2)) / scale
    worst = np.abs(y.numpy() - yj).max() / scale
    assert rms <= HYBRID_RMS and worst < HYBRID_WORST, (rms, worst)

    svc = serve.ArtifactService(d, tparams, batch_window_ms=1.0)
    try:
        assert svc.health()["precision"] == "bfloat16"
        f = svc.encode(w[0])
        np.testing.assert_array_equal(f.codes_c, got[1][:1].numpy())
        assert svc.decode(f).shape == (1, T)
    finally:
        svc.close()

    with pytest.raises(ValueError, match="unknown precision policy 'hybrid_int8'"):
        jexport.export_codec(JaxFACodec(models=models, params=params, n_c=2,
                                        precision="hybrid_int8"),
                             str(tmp_path / "jax_no"), batch=BATCH, seconds=SECONDS)
    with pytest.raises(ValueError, match="unknown precision policy 'hybrid_int8'"):
        export.export_codec(FACodec(codec.encoder, codec.quantizer, codec.decoder,
                                    precision="hybrid_int8"),
                            str(tmp_path / "no"), batch=BATCH, seconds=SECONDS)


def test_int8_decode_artifact_equals_live(live, monkeypatch, tmp_path):
    """`export_codec` under `int8` (the JAX package's API takes it; its CLI
    offers no int8 choice), with INT8_MIN_FANIN at 7 x the decoder's widest
    unit so that the tiny decode runs every form: its first conv and first
    two transposed convs W8A8, block 0's units the int8 unit (two ops each),
    block 1's (float32 x) the float32-in/out act form, the rest the bf16
    entry. The decode program computes the live int8 codec's bits. The
    encoder is not exported at this threshold: its C = 16 units take a
    bf16 x into a quantizing conv7, which no kernel form runs (ROADMAP item
    6's departures); the live codec's plain CPU path encodes."""
    monkeypatch.setattr(port_precision, "INT8_MIN_FANIN", 7 * 16)
    f = live["float32"]
    codec = FACodec(f.encoder, f.quantizer, f.decoder, precision="int8")
    d = str(tmp_path / "int8")
    export.export_codec(codec, d, batch=BATCH, seconds=SECONDS, functions=("decode",))
    port = export.ExportedCodec(d)
    assert port.meta["precision"] == "int8"
    counts = Counter(str(n.target) for n in port.program("decode").graph.nodes
                     if n.op == "call_function")
    assert {k: v for k, v in counts.items() if "resunit" in k} == {
        "facodec.resunit_int8_amax.default": 3, "facodec.resunit_int8.default": 3,
        "facodec.resunit_bf16_f32io.default": 3, "facodec.resunit_bf16.default": 6}
    w, lens = waves()
    _, codes, timbre = codec.encode_tensor(torch.from_numpy(w), torch.from_numpy(lens))
    y = port.decode(export.codec_params(codec), *codes, timbre)
    assert y.dtype == torch.float32 and torch.equal(y, codec.decode_tensor(*codes, timbre))


# ---------------------------------------------------------- against JAX
def test_float32_artifact_matches_jax_artifact(jax_params, live, exported, jax_artifacts):
    params = jax_params[1]
    jexp = jexport.ExportedCodec(jax_artifacts["float32"])
    port, tparams = exported["float32"], export.codec_params(live["float32"])
    w, lens = waves()
    jw = jnp.asarray(w)
    got = port.encode(tparams, torch.from_numpy(w))
    want = jexp.encode(params, jw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **TOL)
    np.testing.assert_allclose(port.decode(tparams, *got).numpy(),
                               np.asarray(jexp.decode(params, *want)), **TOL)
    np.testing.assert_allclose(port.reconstruct(tparams, torch.from_numpy(w)).numpy(),
                               np.asarray(jexp.reconstruct(params, jw)), **TOL)
    np.testing.assert_allclose(
        port.reconstruct_masked(tparams, torch.from_numpy(w), torch.from_numpy(lens)).numpy(),
        np.asarray(jexp.reconstruct_masked(params, jw, jnp.asarray(lens))), **TOL)


def test_hybrid_artifact_matches_jax_artifact(jax_params, live, exported, jax_artifacts):
    """Codes equal; the bf16 decode within the recorded departure from
    JAX's (2e-2 of the peak in RMS, under 8e-2 at the worst sample)."""
    jexp = jexport.ExportedCodec(jax_artifacts["hybrid"])
    port, tparams = exported["hybrid"], export.codec_params(live["hybrid"])
    w, lens = waves()
    got = port.encode_masked(tparams, torch.from_numpy(w), torch.from_numpy(lens))
    want = jexp.encode_masked(jax_params[1], jnp.asarray(w), jnp.asarray(lens))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = port.reconstruct_masked(tparams, torch.from_numpy(w), torch.from_numpy(lens)).numpy()
    yj = np.asarray(jexp.reconstruct_masked(jax_params[1], jnp.asarray(w), jnp.asarray(lens)))
    scale = np.abs(yj).max()
    rms = np.sqrt(np.mean((y - yj) ** 2)) / scale
    worst = np.abs(y - yj).max() / scale
    assert rms <= HYBRID_RMS and worst < HYBRID_WORST, (rms, worst)


def test_artifact_service_matches_jax(jax_params, live, artifacts, jax_artifacts):
    """The port's ArtifactService against the JAX package's on the same
    weights: encode, decode, reconstruct; a shorter request padded into the
    bucket and trimmed back; the past-bucket and residual-free rejections;
    no VC; health and metrics."""
    svc = serve.ArtifactService(artifacts["float32"], export.codec_params(live["float32"]),
                                batch_window_ms=1.0)
    jsvc = jserve.ArtifactService(jax_artifacts["float32"], jax_params[1], batch_window_ms=1.0)
    try:
        w = tone()[:T]
        f, jf = svc.encode(w), jsvc.encode(w)
        for name in ("codes_p", "codes_c", "codes_r"):
            np.testing.assert_array_equal(getattr(f, name), getattr(jf, name))
        np.testing.assert_allclose(f.timbre, jf.timbre, **TOL)
        np.testing.assert_allclose(svc.decode(f), jsvc.decode(jf), **TOL)
        np.testing.assert_allclose(svc.reconstruct(w), jsvc.reconstruct(w), **TOL)
        short = tone(0.45, hz=300.0, seed=4)
        f2 = svc.encode(short)
        assert f2.codes_p.shape[-1] == len(short) // HOP
        np.testing.assert_array_equal(f2.codes_c, jsvc.encode(short).codes_c)
        np.testing.assert_allclose(svc.reconstruct(short), jsvc.reconstruct(short), **TOL)
        with pytest.raises(ValueError, match="exceeds the artifact bucket"):
            svc.encode(tone(0.9))
        with pytest.raises(ValueError, match="residual"):
            svc.decode(f, use_residual=False)
        with pytest.raises(RuntimeError, match="VC"):
            svc.convert(w, w)
        h = svc.health()
        assert h["artifact"] is True and h["max_batch"] == BATCH and h["device"] == "cpu:cpu"
        assert {k for k in jsvc.health() if k != "device"} <= set(h)
        assert "facodec_artifact 1" in serve.render_metrics(svc)
    finally:
        svc.close()


def test_serve_artifact_cli(live, artifacts, ckpt):
    """`python -m facodec_tpu_torch serve --artifact` on port 0 answers
    /reconstruct with the live hybrid codec's wave, and /health."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "facodec_tpu_torch", "serve", "--artifact", artifacts["hybrid"],
         "--ckpt-path", ckpt, "--device", "cpu", "--port", "0", "--no-warmup"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env)
    try:
        line = ""
        for line in proc.stdout:
            if "serving artifact on" in line:
                break
        assert "serving artifact on" in line, line
        base = line.strip().rsplit(" ", 1)[-1]
        w = tone()[:T]
        blob = serve.write_wav_bytes(w)
        resp = urllib.request.urlopen(urllib.request.Request(f"{base}/reconstruct", data=blob,
                                                             method="POST"), timeout=120)
        got = serve.read_wav_bytes(resp.read())
        codec = live["hybrid"]
        x = np.zeros((BATCH, T), np.float32)
        x[0] = serve.read_wav_bytes(blob)
        y = codec.decode_latent(codec.encode_tensor(torch.from_numpy(x))[0])[:1].numpy()
        np.testing.assert_array_equal(got, serve.read_wav_bytes(serve.write_wav_bytes(y)))
        health = json.loads(urllib.request.urlopen(f"{base}/health", timeout=30).read())
        assert health["artifact"] is True and health["precision"] == "hybrid"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_serve_artifact_needs_checkpoint_and_device(artifacts):
    assert port_main.main(["serve", "--artifact", artifacts["float32"], "--device", "cpu"]) == 2
    with pytest.raises(SystemExit, match="runs there only"):
        port_main.main(["serve", "--artifact", artifacts["float32"], "--ckpt-path", "x",
                        "--device", "cuda"])


# ------------------------------------------------------ ops and graphs
def _unit(C=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(C, C, 7, generator=g) / 15, 0.1 * torch.randn(C, generator=g),
            torch.randn(C, C, 1, generator=g) / 6, 0.1 * torch.randn(C, generator=g),
            0.5 + torch.rand(1, C, 1, generator=g), 0.5 + torch.rand(1, C, 1, generator=g))


def _grad(*ts):
    return tuple(t.clone().requires_grad_(True) for t in ts)


OPCHECK_CASES = {
    "resunit_f32": lambda: (torch.ops.facodec.resunit_f32.default,
                            (*_grad(torch.randn(2, 40, 32), *_unit()), 3, True)),
    "resunit_f32_noncausal": lambda: (torch.ops.facodec.resunit_f32.default,
                                      (*_grad(torch.randn(2, 20, 32), *_unit()), 9, False)),
    "resunit_bf16": lambda: (torch.ops.facodec.resunit_bf16.default,
                             (torch.randn(2, 40, 32).bfloat16(), *resunit.pack_bf16(*_unit()),
                              3, False)),
    "nearest_code": lambda: (torch.ops.facodec.nearest_code.default,
                             _grad(torch.randn(2, 10, 8), torch.randn(32, 8))),
    "resunit_halo_f32": lambda: (torch.ops.facodec.resunit_halo_f32.default,
                                 (torch.randn(2, 12, 32), torch.randn(2, 18, 32), *_unit(), 3)),
    "resunit_halo_f32_first": lambda: (torch.ops.facodec.resunit_halo_f32.default,
                                       (torch.randn(2, 40, 32), None, *_unit(), 3)),
    "resunit_bf16_f32io": lambda: (torch.ops.facodec.resunit_bf16_f32io.default,
                                   (torch.randn(2, 40, 32),
                                    *resunit.pack_bf16(*_unit(), torch.float32), 3, True, False)),
    "resunit_bf16_f32io_act": lambda: (torch.ops.facodec.resunit_bf16_f32io.default,
                                       (torch.randn(2, 40, 32),
                                        *resunit.pack_bf16(*_unit(), torch.float32), 9, False,
                                        True)),
    "resunit_int8_amax": lambda: (torch.ops.facodec.resunit_int8_amax.default,
                                  (torch.randn(2, 40, 32), *resunit.pack_int8(*_unit())[5:7])),
    "resunit_int8": lambda: (torch.ops.facodec.resunit_int8.default,
                             (torch.randn(2, 40, 32), 3.0 + torch.rand(2),
                              *resunit.pack_int8(*_unit()), 3, True)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_opcheck(case):
    """Every kernel entry is a custom op whose schema, fake, autograd
    registration and traced forward (and backward) pass `opcheck`."""
    op, args = OPCHECK_CASES[case]()
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("route", ["bf16", "f32io", "f32io_act"])
def test_packed_cpu_route_equals_eager(route):
    """The packed bf16 forms' CPU implementations (what a program exported on
    the CPU runs) equal the eager plain composition bit for bit: both hand
    the conv a weight in the module's own contiguous layout (a strided one
    is summed in another order, and one float32 ulp can round a bf16 output
    the other way)."""
    ws = _unit(64, seed=7)
    x = torch.randn(8, 400, 64, generator=torch.Generator().manual_seed(8))
    if route == "bf16":
        x = x.bfloat16()
    pack = resunit.make_pack(route, *ws)
    with torch.no_grad(), port_precision.policy(resunit.ROUTE_POLICY[route]):
        want = resunit.residual_unit_reference(x, *ws, 3, True)
        if route == "bf16":
            got = torch.ops.facodec.resunit_bf16(x, *pack, 3, True)
        else:
            got = torch.ops.facodec.resunit_bf16_f32io(x, *pack, 3, True, route == "f32io_act")
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("precision", ["float32", "hybrid"])
def test_exported_graph_nodes(exported, precision):
    """reconstruct: one node per residual unit (24 float32, or 12 + 12 with
    bf16), one per VQ search, one `aten.lstm.input` per SLSTM (no unrolled
    loop); the hybrid encode holds no bf16 value (its codes are float32's)."""
    def nodes(name):
        graph = exported[precision].program(name).graph
        return [n for n in graph.nodes if n.op == "call_function"]

    counts = Counter(str(n.target) for n in nodes("reconstruct"))
    units = ({"facodec.resunit_f32.default": 24} if precision == "float32" else
             {"facodec.resunit_f32.default": 12, "facodec.resunit_bf16.default": 12})
    assert {k: v for k, v in counts.items() if "resunit" in k} == units
    assert counts["facodec.nearest_code.default"] == 6
    assert counts["aten.lstm.input"] == 2  # the tiny config's encoder and decoder SLSTMs
    vals = [n.meta.get("val") for n in nodes("encode")]
    dtypes = {v.dtype for val in vals for v in (val if isinstance(val, (list, tuple)) else [val])
              if isinstance(v, torch.Tensor)}
    assert torch.float32 in dtypes and torch.bfloat16 not in dtypes, dtypes
