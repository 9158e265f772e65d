"""Training on one's own data, port against the JAX package, on the CPU:
`utils.audio.load_wav` on every sample width, `ops.metrics`,
`cli.assemble_data` and `cli.extract_targets`.

- `load_wav`: the formats JAX's native reader refuses (8-bit PCM, 64-bit
  float) go through JAX's scipy fallback; 16, 22.05, 44.1 and 48 kHz, mono
  and stereo, bit for bit against `facodec_tpu.train.data.load_wav` with
  its native library loaded.
- `ops.metrics`: each function returns JAX's bits on seeded waves, and the
  property cases of tests/test_metrics.py hold for the port's functions.
- `assemble_data`: byte-equal `train.txt` / `val.txt`.
- `extract_targets`: the gate (exit 2, nothing written) and the opt-out as
  JAX; the JDC route against JAX's file for file, F0 within 2e-4 x max|F0|
  + 2e-4 (the port's log-mel is torch's, within 1.3e-6 of JAX's numpy
  one); the wav2vec2 route on a tiny offline model and the TorchScript
  speaker route, their ids equal to JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import facodec_tpu.native
import facodec_tpu.ops.metrics as jm
from facodec_tpu.cli import assemble_data as j_assemble
from facodec_tpu.cli import extract_targets as j_extract
from facodec_tpu.train.data import load_wav as j_load_wav
from facodec_tpu_torch.cli import assemble_data, extract_targets
from facodec_tpu_torch.models.jdc import random_reference_state_dict
from facodec_tpu_torch.ops import metrics as pm
from facodec_tpu_torch.utils.audio import load_wav

SR = 24000
HOP = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several files at once: one torch thread each here,
    restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ load_wav
def _samples(kind: str, channels: int, n: int = 16001) -> np.ndarray:
    x = np.clip(np.random.default_rng(channels).standard_normal((n, channels)) * 0.3, -1, 1)
    x = x[:, 0] if channels == 1 else x
    return (x * 127 + 128).astype(np.uint8) if kind == "uint8" else x.astype(np.float64)


@pytest.fixture(scope="module")
def native_loaded(tmp_path_factory):
    """JAX's native reader is built and reads an int16 file, so that its
    `load_wav` takes both routes."""
    path = str(tmp_path_factory.mktemp("native") / "int16.wav")
    wavfile.write(path, SR, (np.linspace(-0.5, 0.5, 4800) * 32767).astype(np.int16))
    assert isinstance(facodec_tpu.native.load_wav_native(path, SR), np.ndarray)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("file_sr", [16000, 22050, 44100, 48000])
@pytest.mark.parametrize("kind", ["uint8", "float64"])
def test_load_wav_fallback_formats_match_jax(native_loaded, tmp_path, kind, file_sr, channels):
    path = str(tmp_path / f"{kind}.wav")
    wavfile.write(path, file_sr, _samples(kind, channels))
    assert facodec_tpu.native.load_wav_native(path, SR) is None  # JAX's scipy route
    got, want = load_wav(path), j_load_wav(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ metrics
def speechy(seconds=2.0, f0=160.0):
    """tests/test_metrics.py `speechy`: an amplitude- and pitch-modulated
    harmonic signal."""
    t = np.arange(int(seconds * SR)) / SR
    vib = f0 * (1 + 0.04 * np.sin(2 * np.pi * 3.0 * t))
    phase = 2 * np.pi * np.cumsum(vib) / SR
    x = sum(np.sin(k * phase) / k for k in (1, 2, 3, 4))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 2.5 * t)
    x = (x * env).astype(np.float64)
    return 0.3 * x / np.abs(x).max()


@pytest.fixture(scope="module")
def waves():
    ref = speechy()
    est = ref + 0.05 * np.random.default_rng(0).standard_normal(len(ref))
    return est, ref


CALLS = {
    "si_sdr": lambda m, est, ref: m.si_sdr(est, ref),
    "stoi": lambda m, est, ref: m.stoi(est, ref, SR),
    "mcd": lambda m, est, ref: m.mcd(est, ref),
    "f0_autocorr": lambda m, est, ref: m.f0_autocorr(est),
    "f0_correlation": lambda m, est, ref: m.f0_correlation(m.f0_autocorr(est), m.f0_autocorr(ref)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_metrics_match_jax(waves, name):
    est, ref = waves
    got, want = CALLS[name](pm, est, ref), CALLS[name](jm, est, ref)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_si_sdr_properties():
    ref = speechy()
    assert pm.si_sdr(ref, ref) > 60.0
    rng = np.random.default_rng(0)
    deg = ref + 0.05 * rng.standard_normal(len(ref))
    assert abs(pm.si_sdr(0.25 * deg, ref) - pm.si_sdr(deg, ref)) < 1e-6
    noisy = ref + 0.1 * rng.standard_normal(len(ref)) * ref.std() / 0.1 * 0.316
    assert 5.0 < pm.si_sdr(noisy, ref) < 15.0
    assert pm.si_sdr(rng.standard_normal(len(ref)), ref) < 1.0


def test_stoi_properties():
    ref = speechy()
    perfect = pm.stoi(ref, ref, SR)
    assert perfect > 0.98
    rng = np.random.default_rng(1)
    light = pm.stoi(ref + 0.02 * rng.standard_normal(len(ref)), ref, SR)
    heavy = pm.stoi(ref + 0.5 * rng.standard_normal(len(ref)), ref, SR)
    assert perfect >= light > heavy
    assert heavy < 0.75
    assert np.isnan(pm.stoi(np.zeros(1000), np.zeros(1000), SR))


def test_mcd_properties():
    from scipy.signal import butter, sosfilt

    ref = speechy()
    assert pm.mcd(ref, ref) < 1e-6
    rng = np.random.default_rng(2)
    light = pm.mcd(ref + 0.01 * rng.standard_normal(len(ref)), ref)
    heavy = pm.mcd(ref + 0.2 * rng.standard_normal(len(ref)), ref)
    assert 0.0 < light < heavy
    assert np.isnan(pm.mcd(np.zeros(10), np.zeros(10)))
    noise = rng.standard_normal(SR * 2).astype(np.float64)
    lo = sosfilt(butter(4, 3000, fs=SR, btype="low", output="sos"), noise)
    hi = sosfilt(butter(4, 3000, fs=SR, btype="high", output="sos"), noise)
    assert 9.0 < pm.mcd(lo + 2.0 * hi, lo + hi) < 22.0  # a +6 dB shelf above 3 kHz


def test_f0_autocorr_tracks_pitch_and_glide():
    t = np.arange(SR) / SR
    for hz in (110.0, 220.0, 330.0):
        f0 = pm.f0_autocorr(0.5 * np.sin(2 * np.pi * hz * t), SR)
        voiced = f0[f0 > 0]
        assert len(voiced) > 0.9 * len(f0)
        np.testing.assert_allclose(np.median(voiced), hz, rtol=0.03)
    assert np.all(pm.f0_autocorr(np.zeros(SR), SR) == 0)
    t = np.arange(2 * SR) / SR
    inst = 120.0 * (300.0 / 120.0) ** (t / 2.0)
    f0 = pm.f0_autocorr(0.5 * np.sin(2 * np.pi * np.cumsum(inst) / SR), SR)
    expect = inst[(np.arange(len(f0)) * 300 + 600).clip(0, len(t) - 1)]
    voiced = f0 > 0
    assert voiced.mean() > 0.9
    assert np.median(np.abs(f0[voiced] - expect[voiced]) / expect[voiced]) < 0.04
    assert pm.f0_correlation(f0, expect * voiced)[0] > 0.95
    assert pm.f0_correlation(f0, (expect * voiced)[::-1])[0] < -0.5


def test_f0_correlation():
    f0a = pm.f0_autocorr(speechy(f0=140.0), SR)
    r, agree = pm.f0_correlation(f0a, f0a)
    assert abs(r - 1.0) < 1e-9 and agree == 1.0
    r3, agree3 = pm.f0_correlation(np.zeros(10), np.ones(10) * 100)
    assert np.isnan(r3) and agree3 == 0.0


# ------------------------------------------------------------ assemble_data
def test_assemble_data_matches_jax(tmp_path):
    """Durations around both limits, a missing file and a file that is no
    wav; the same seeded shuffle and split."""
    rows = []
    for i, seconds in enumerate([0.5, 1.0, 1.2, 2.0, 2.5, 3.0, 3.1, 1.7, 2.2, 1.4, 2.9, 1.1]):
        path = str(tmp_path / f"u{i}.wav")
        wavfile.write(path, 16000 if i % 3 else SR, np.zeros(int(seconds * (16000 if i % 3 else
                                                                              SR)), np.int16))
        rows.append(f"{path}\t{i}\ten\ttext {i}\tphones {i}")
    (tmp_path / "bad.wav").write_text("not a wav")
    rows += [f"{tmp_path / 'missing.wav'}\t1\ten\tx\ty", f"{tmp_path / 'bad.wav'}\t2\ten\tx\ty"]
    transcript = tmp_path / "all.txt"
    transcript.write_text("\n".join(rows))  # the last row has no newline
    args = ["--transcripts", str(transcript), "--min-s", "1", "--max-s", "3", "--seed", "3"]
    assert assemble_data.main(args + ["--target-dir", str(tmp_path / "port")]) == 0
    assert j_assemble.main(args + ["--target-dir", str(tmp_path / "jax")]) == 0
    for name in ("train.txt", "val.txt"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
    assert len((tmp_path / "port" / "train.txt").read_text().splitlines()) == 9


# ------------------------------------------------------------ extract_targets
def _manifest(tmp_path, name, specs):
    """Wavs of `specs` [(seconds, file_sr, sid)], written in their own
    directory, and a manifest of them."""
    d = tmp_path / name
    d.mkdir()
    rows = []
    for i, (seconds, file_sr, sid) in enumerate(specs):
        t = np.arange(int(seconds * file_sr)) / file_sr
        wave = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) * (0.6 + 0.4 * np.sin(3 * t))
        path = str(d / f"u{i}.wav")
        wavfile.write(path, file_sr, (wave * 32767).astype(np.int16))
        rows.append(f"{path}\t{sid}\ten\ttext\tphones\n")
    manifest = d / "list.txt"
    manifest.write_text("".join(rows))
    return str(manifest), [r.split("\t")[0] for r in rows]


def _both(tmp_path, specs, args):
    """Both CLIs on copies of the same wavs; (port rc, JAX rc, wav paths of
    each)."""
    port_m, port_wavs = _manifest(tmp_path, "port", specs)
    jax_m, jax_wavs = _manifest(tmp_path, "jax", specs)
    rc_port = extract_targets.main(["--manifest", port_m, "--device", "cpu", *args])
    rc_jax = j_extract.main(["--manifest", jax_m, *args])
    return rc_port, rc_jax, port_wavs, jax_wavs


def _targets(path):
    with np.load(path + ".targets.npz") as t:
        return {k: t[k] for k in ("f0", "phone_ids", "spk_label")}


SPECS = [(0.4, SR, 7), (0.3, 16000, 12)]


def test_extract_targets_gate(tmp_path, monkeypatch):
    """Requested teachers that are unavailable (no JDC file; no NeMo) stop
    both CLIs with exit 2 before any file is written."""
    monkeypatch.delenv("FACODEC_JDC_CKPT", raising=False)
    rc_port, rc_jax, port_wavs, jax_wavs = _both(tmp_path, SPECS, ["--teachers", "jdc,titanet",
                                                                    "--titanet-model", ""])
    assert rc_port == rc_jax == 2
    assert not any(os.path.exists(p + ".targets.npz") for p in port_wavs + jax_wavs)


def test_extract_targets_opt_out(tmp_path, monkeypatch):
    """--allow-missing: zero F0 and phones and the manifest's sid, the files
    equal to JAX's, and FileListDataset reads them."""
    from facodec_tpu_torch.train.data import FileListDataset

    monkeypatch.delenv("FACODEC_JDC_CKPT", raising=False)
    args = ["--teachers", "jdc,titanet", "--titanet-model", "", "--allow-missing", "jdc,titanet"]
    rc_port, rc_jax, port_wavs, jax_wavs = _both(tmp_path, SPECS, args)
    assert rc_port == rc_jax == 0
    for p, j in zip(port_wavs, jax_wavs):
        got, want = _targets(p), _targets(j)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert int(_targets(port_wavs[1])["spk_label"]) == 12
    item = FileListDataset(os.path.join(os.path.dirname(port_wavs[0]), "list.txt"))[0]
    assert int(item["spk_label"]) == 7 and np.all(item["f0"] == 0)


def test_extract_targets_jdc_matches_jax(tmp_path):
    """The JDC route on a seeded reference-layout file, file for file."""
    ckpt = str(tmp_path / "bst.t7")
    torch.save({"net": random_reference_state_dict(0)}, ckpt)
    rc_port, rc_jax, port_wavs, jax_wavs = _both(
        tmp_path, SPECS, ["--teachers", "jdc", "--jdc-ckpt", ckpt])
    assert rc_port == rc_jax == 0
    for p, j in zip(port_wavs, jax_wavs):
        got, want = _targets(p), _targets(j)
        assert got["f0"].shape == want["f0"].shape and got["f0"].dtype == np.float32
        tol = 2e-4 * np.abs(want["f0"]).max() + 2e-4
        assert np.abs(got["f0"] - want["f0"]).max() <= tol
        assert np.array_equal(got["phone_ids"], want["phone_ids"])
        assert int(got["spk_label"]) == int(want["spk_label"])


def test_extract_targets_w2v_matches_jax(tmp_path, monkeypatch):
    """The wav2vec2 CTC route on a tiny random model saved offline
    (tests/test_api_cli.py's), phone ids equal to JAX's. Both CLIs run the
    PyTorch model: transformers is kept from importing its TensorFlow and
    Flax back ends, which the route does not use (about 10 s of imports)."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    mdir = tmp_path / "w2v_tiny"
    mdir.mkdir()
    vocab = {c: i for i, c in enumerate("<pad> a b c d e f g".split())}
    (mdir / "vocab.json").write_text(json.dumps(vocab))
    tok = transformers.Wav2Vec2CTCTokenizer(str(mdir / "vocab.json"), pad_token="<pad>")
    fe = transformers.Wav2Vec2FeatureExtractor(feature_size=1, sampling_rate=16000,
                                               padding_value=0.0, do_normalize=True,
                                               return_attention_mask=False)
    transformers.Wav2Vec2Processor(feature_extractor=fe, tokenizer=tok).save_pretrained(str(mdir))
    torch.manual_seed(0)
    cfg = transformers.Wav2Vec2Config(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=1,
                                      num_attention_heads=2, intermediate_size=64,
                                      conv_dim=(16,) * 7)
    transformers.Wav2Vec2ForCTC(cfg).save_pretrained(str(mdir))
    rc_port, rc_jax, port_wavs, jax_wavs = _both(
        tmp_path, SPECS, ["--teachers", "w2v", "--w2v-model", str(mdir)])
    assert rc_port == rc_jax == 0
    for p, j in zip(port_wavs, jax_wavs):
        got, want = _targets(p), _targets(j)
        assert got["phone_ids"].dtype == np.int32 and got["phone_ids"].shape == (
            len(load_wav(p)) // HOP,)
        np.testing.assert_array_equal(got["phone_ids"], want["phone_ids"])


def test_extract_targets_torchscript_speaker_matches_jax(tmp_path):
    """The TorchScript speaker route (tests/test_api_cli.py's stand-in:
    16 kHz wave (1, T) -> 20000 logits), labels equal to JAX's."""

    class TinySpeakerNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(3, 20000)

        def forward(self, w: torch.Tensor) -> torch.Tensor:
            feats = torch.stack([w.mean(dim=1), w.std(dim=1), w.abs().mean(dim=1)], dim=1)
            return self.proj(feats)

    torch.manual_seed(0)
    mpath = str(tmp_path / "spk_teacher.pt")
    torch.jit.script(TinySpeakerNet()).save(mpath)
    rc_port, rc_jax, port_wavs, jax_wavs = _both(
        tmp_path, SPECS, ["--teachers", "titanet", "--titanet-model", mpath])
    assert rc_port == rc_jax == 0
    labels = [int(_targets(p)["spk_label"]) for p in port_wavs]
    assert labels == [int(_targets(j)["spk_label"]) for j in jax_wavs]
    assert all(0 <= s < 20000 for s in labels)
