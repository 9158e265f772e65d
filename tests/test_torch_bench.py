"""The port's benchmarks (facodec_tpu_torch/bench*.py, utils/flops.py) on the CPU.

The bench's timed round trip (`FACodec.reconstruct_tensor` of the codec that
`bench.build_codec` builds, under `bench.with_policy`) is held to the JAX
bench's (`bench.py` `_roundtrip_fn`) on the same weights, moved by
`load_jax_params`, at tests/tiny_config.yml: codes bit-exact under every
policy (each encodes in float32 but the whole-bf16 ones), waves within the
golden tolerance in float32 and within the bf16 decode's bounds
(tests/test_torch_precision.py) under hybrid and hybrid_int8. The FLOP
count is held to `FlopCounterMode`; the commands print one JSON line each
with the JAX benches' keys, and refuse to fall back to the CPU.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from facodec_tpu.models.builder import build_model
from facodec_tpu.ops import precision as jprecision
from facodec_tpu.utils.checkpoint import convert_state_dict
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch import bench
from facodec_tpu_torch.__main__ import main as cli
from facodec_tpu_torch.nn.lstm import SLSTM
from facodec_tpu_torch.ops import precision
from facodec_tpu_torch.utils.flops import round_trip_flops
from facodec_tpu_torch.utils.weights import load_jax_params

from test_torch_precision import DECODER_VS_F32, DECODER_VS_JAX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
NAMES = ("encoder", "quantizer", "decoder")
TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX package's golden tolerance
FANIN = 112  # the tiny decoder's block-0 conv7 (7 x 16) and above quantize
CPU = torch.device("cpu")


def _jax_bench():
    """The root bench.py, imported by path (it reads __graft_entry__)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    """The tiny codec in both packages on one set of weights, and one bench
    wave: seeded port weights as a JAX param tree (the JAX package's
    `convert_state_dict`, in place of its init, which takes 20 s here),
    moved into the bench's codec by `load_jax_params`."""
    jm = build_model(load_config(TINY).model_params, "codec")
    jm = {k: jm[k] for k in NAMES}
    seeded = bench.build_codec(CPU, "float32", TINY, seed=3)
    params = {k: convert_state_dict(getattr(seeded, k).state_dict()) for k in NAMES}
    codec = bench.build_codec(CPU, "float32", TINY)
    for k in NAMES:
        load_jax_params(getattr(codec, k), params[k])
    wave = bench.bench_wave(2, 0.5, CPU)
    return dict(jm=jm, params=params, codec=codec, wave=wave)


@pytest.mark.parametrize("policy", ["float32", "hybrid", "hybrid_int8"])
def test_round_trip_matches_jax_bench(both, policy, monkeypatch):
    monkeypatch.setattr(precision, "INT8_MIN_FANIN", FANIN)
    monkeypatch.setattr(jprecision, "INT8_MIN_FANIN", FANIN)
    fn = _jax_bench()._roundtrip_fn(both["jm"], policy, with_codes=True)
    wave = both["wave"]
    want, jcodes = jax.jit(fn)(both["params"], jnp.asarray(wave.numpy()))
    codec = bench.with_policy(both["codec"], policy)
    got = codec.reconstruct_tensor(wave).numpy()
    _, codes, _ = codec.encode_tensor(wave)
    for c, jc in zip(codes, jcodes):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    want = np.asarray(want, np.float32)[:, :, 0]
    assert got.shape == want.shape and got.dtype == np.float32
    if policy == "float32":
        np.testing.assert_allclose(got, want, **TOL)
        return
    err = np.abs(got - want).max() / np.abs(want).max()
    rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    print(f"{policy} round trip: port vs JAX err/scale {err:.3e} at the worst sample, "
          f"{rms:.3e} in RMS")
    assert rms <= DECODER_VS_JAX
    assert err < DECODER_VS_F32


def _lstm_term(codec, batch: int, frames: int) -> int:
    """2 * 4H (I + H) per step per layer, over every LSTM of the round trip."""
    total = 0
    for part in (codec.encoder, codec.decoder):
        for m in part.modules():
            if isinstance(m, SLSTM):
                H, I = m.lstm.hidden_size, m.lstm.input_size
                for _ in range(m.lstm.num_layers):
                    total += 2 * batch * frames * 4 * H * (I + H)
                    I = H
    return total


@pytest.mark.parametrize("batch,seconds", [(2, 0.25), (1, 0.3125)])
def test_flops_equal_the_flop_counter(both, batch, seconds):
    codec = both["codec"]
    wave = bench.bench_wave(batch, seconds, CPU)
    with FlopCounterMode(display=False) as counter:
        codec.reconstruct_tensor(wave)
    modules = {k: getattr(codec, k) for k in NAMES}
    samples = wave.shape[1]
    assert round_trip_flops(modules, batch, samples, n_c=codec.n_c) == \
        counter.get_total_flops() + _lstm_term(codec, batch, samples // 300)


def test_codes_match(both):
    codec = both["codec"]
    assert bench.codes_match_f32_frac(codec, "hybrid") == 1.0
    wave = bench.bench_wave(1, 2.0, CPU, seed=2)
    codes = {p: [c.numpy() for c in bench.with_policy(codec, p).encode_tensor(wave)[1]]
             for p in ("float32", "bfloat16")}
    flat = {p: np.concatenate([c.ravel() for c in cs]) for p, cs in codes.items()}
    want = np.count_nonzero(flat["float32"] == flat["bfloat16"]) / flat["float32"].size
    assert bench.codes_match_f32_frac(codec, "bfloat16") == want


JAX_KEYS = {
    # bench.py's line less vs_baseline, and what it adds without FAST
    "roundtrip": {"metric", "value", "unit", "precision", "batch", "seconds",
                  "flops_per_s_audio", "mfu", "device_kind"},
    "streaming": {"metric", "value", "unit", "chunk_ms", "p99_ms", "device_only_ms",
                  "device_only_2call_ms", "device_op_ms", "e2e_latency_ms", "prime_ms",
                  "rtf_interactive", "rtf_device", "latency_analytic", "redecoder_vc",
                  "group_capacity"},
    "train": {"metric", "value", "unit", "precision", "remat", "split", "paired_g", "batch",
              "seg_frames", "audio_s_per_s", "pipeline_step_ms", "pipeline_overhead_pct"},
}
ARGS = {"roundtrip": ["--batch", "2", "--seconds", "0.5"],
        "streaming": ["--seconds", "0.5"],
        "train": ["--batch", "1", "--seg-frames", "4"]}
METRICS = {"roundtrip": "encode_decode_rtf", "streaming": "streaming_chunk_p50_ms",
           "train": "train_step_ms"}


@pytest.mark.parametrize("what", ["roundtrip", "streaming", "train"])
def test_cli_prints_one_line(what, capsys, monkeypatch):
    monkeypatch.setenv("FACODEC_BENCH_CAPACITY", "2")
    result = cli(["bench", what, "--device", "cpu", "--config-path", TINY, "--fast",
                  *ARGS[what]])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == result
    assert JAX_KEYS[what] <= set(line) and "vs_baseline" not in line
    assert line["metric"] == METRICS[what] and line["value"] > 0
    if what == "roundtrip":
        assert line["precision"] == "hybrid_int8" and line["device_kind"] == "cpu"
        assert line["mfu"] is None  # no card measured
    if what == "streaming":
        assert line["device_op_ms"] is None
        assert line["group_capacity"]["tick_ms"].keys() == {"2"}


@pytest.mark.parametrize("what", ["roundtrip", "streaming", "train"])
def test_no_cpu_fallback(what, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli(["bench", what, "--config-path", TINY, "--fast"])
    assert exc.value.code not in (0, None) and "CUDA" in str(exc.value.code)


def test_unknown_card_has_no_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Some Other Card")
    with pytest.raises(KeyError, match="no bf16 peak"):
        bench.peak_bf16(torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert bench.peak_bf16(torch.device("cuda", 0)) == 989e12
