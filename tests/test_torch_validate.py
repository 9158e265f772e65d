"""The port's `validate` command (facodec_tpu_torch/cli/validate.py) against
the JAX package, on the CPU.

A tiny seeded checkpoint in the reference's `pytorch_model.bin` layout (one
state dict per module) is written from the port's modules
(tests/test_torch_export.py writes its checkpoint so); the golden comes
from the JAX package's `FACodec.from_config(config, ckpt, n_c=2)` on the
JAX command's chirp: its codes, timbre and reconstruction, in the layout of
the JAX command's `--emit-golden`. The port's `validate --golden` then
passes with bit-exact codes (exit 0), fails on a golden whose content codes
are off by one (exit 1), and exits 3 with no golden, no checkpoint or
`--emit-golden`, where the JAX command does. Its chirp equals JAX's
`_test_wave` bit for bit, and its mel-L1 of a pair JAX's `_mel_l1` within
1e-6 (both float32 over the same log-mel).

The reconstruction's mel-L1 is held at 0.05, the JAX package's own test's
threshold (tests/test_validate.py): random-weight decoders emit
near-silence, where the normalised log-mel is hypersensitive; the 1e-3
default targets the released checkpoint.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from facodec_tpu_torch.__main__ import exit_code, main as port_main
from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.cli import validate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
CODEC = ("encoder", "quantizer", "decoder")
SECONDS = 0.8
MEL_THRESHOLD = 0.05


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(checkpoint, golden) of a seeded tiny codec."""
    from facodec_tpu.api import FACodec as JFACodec
    from facodec_tpu.cli.validate import _test_wave as j_test_wave

    d = tmp_path_factory.mktemp("validate")
    port = FACodec.from_config(TINY, seed=11, device="cpu")
    ckpt = str(d / "pytorch_model.bin")
    torch.save({k: getattr(port, k).state_dict() for k in CODEC}, ckpt)
    wave = j_test_wave("", SECONDS)
    jc = JFACodec.from_config(TINY, ckpt, n_c=2)
    f = jc.encode(wave[None])
    golden = str(d / "golden.npz")
    np.savez(golden, codes_p=np.asarray(f.codes_p), codes_c=np.asarray(f.codes_c),
             codes_r=np.asarray(f.codes_r), timbre=np.asarray(f.timbre),
             recon=np.asarray(jc.reconstruct(wave[None]))[:, :])
    return ckpt, golden


def _run(argv, capsys):
    p = argparse.ArgumentParser()
    validate.add_args(p)
    rc = validate.main(p.parse_args(argv + ["--device", "cpu"]))
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_validate_against_jax_golden(files, capsys):
    ckpt, golden = files
    rc, out = _run(["--ckpt", ckpt, "--config", TINY, "--golden", golden, "--seconds",
                    str(SECONDS), "--mel-threshold", str(MEL_THRESHOLD)], capsys)
    assert rc == 0, out
    assert out["codes_bit_exact"] is True and out["pass"] is True
    assert out["source"] == "golden-file" and out["ckpt"] == ckpt
    assert out["mel_l1"] <= MEL_THRESHOLD and out["mel_l1_threshold"] == MEL_THRESHOLD
    assert out["timbre_max_abs_diff"] < 1e-4
    assert set(out) == {"codes_bit_exact", "mel_l1", "mel_l1_threshold",
                        "timbre_max_abs_diff", "source", "ckpt", "pass"}


def test_validate_broken_golden_exits_1(files, capsys, tmp_path):
    ckpt, golden = files
    ref = dict(np.load(golden))
    ref["codes_c"] = ref["codes_c"] + 1
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **ref)
    rc, out = _run(["--ckpt", ckpt, "--config", TINY, "--golden", bad, "--seconds",
                    str(SECONDS), "--mel-threshold", str(MEL_THRESHOLD)], capsys)
    assert rc == 1 and out["codes_bit_exact"] is False and out["pass"] is False


def test_validate_nothing_to_compare_exits_3(files, capsys, tmp_path):
    ckpt, _ = files
    for argv, error in (
            (["--ckpt", ckpt, "--config", TINY], "no comparison source"),
            (["--config", TINY], "no checkpoint available"),
            (["--ckpt", ckpt, "--config", TINY, "--emit-golden", str(tmp_path / "g.npz")],
             "torch reference unavailable")):
        rc, out = _run(argv, capsys)
        assert rc == 3 and out["pass"] is False and out["error"].startswith(error), out
    assert not (tmp_path / "g.npz").exists()
    # through the dispatcher, with its exit code
    rc = port_main(["validate", "--config", TINY, "--device", "cpu"])
    assert rc == 3 and exit_code(rc) == 3
    assert exit_code(0) == 0 and exit_code({"x": 1}) == 0 and exit_code(None) == 1


@pytest.mark.parametrize("seconds", [0.8, 2.0, 1.234])
def test_chirp_equals_jax(seconds):
    from facodec_tpu.cli.validate import _test_wave as j_test_wave

    got, want = validate._test_wave("", seconds), j_test_wave("", seconds)
    assert got.dtype == want.dtype == np.float32 and len(got) % 300 == 0
    np.testing.assert_array_equal(got, want)


def test_wav_input_is_cut_to_the_hop(tmp_path):
    from scipy.io import wavfile

    from facodec_tpu_torch.utils.audio import load_wav

    path = str(tmp_path / "x.wav")
    rng = np.random.default_rng(0)
    wavfile.write(path, 24000, (rng.standard_normal(7777) * 3000).astype(np.int16))
    got = validate._test_wave(path, 9.0)
    np.testing.assert_array_equal(got, load_wav(path)[:7500])


def test_mel_l1_equals_jax():
    from facodec_tpu.cli.validate import _mel_l1 as j_mel_l1

    rng = np.random.default_rng(5)
    a = (0.3 * rng.standard_normal((2, 9000))).astype(np.float32)
    b = (a + 0.01 * rng.standard_normal((2, 9000))).astype(np.float32)
    np.testing.assert_allclose(validate.mel_l1(a, b), j_mel_l1(a, b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(validate.mel_l1(a, b[:, :8700]), j_mel_l1(a, b[:, :8700]),
                               rtol=0, atol=1e-6)
