"""The trainer options of the port, on the CPU (port only): the split step,
`remat`, the probes, and the config keys of the codec loop.

The JAX split step differs from its fused step only in rounding, so the
port's variants are held to the port's fused steps, which
tests/test_torch_train_step.py and tests/test_torch_redecoder_train.py hold
to JAX. Every draw is in play (dropout, quantizer dropout, the residual
mask), from one generator seed:
- the split codec and redecoder steps against the fused ones: metrics and
  updated parameters within 1e-5 (`rtol` and `atol`), except one parameter
  whose gradient is rounding noise (NOISE_ONLY);
- `remat=True` against `remat=False` for the codec and the redecoder step:
  metrics and gradients within 1e-6. The recompute must draw the masks the
  forward drew; a checkpoint that replayed only torch's global RNG would
  draw new ones and give other gradients;
- the residual units and the VQ searches each variant runs: split runs the
  generator forward twice, `remat` recomputes it once in the backward.
The codec loop: `split_step` runs the split step, `remat` reaches the step,
a `probe_interval` with a writer logs `probe/*` audio, `tensor_parallel: 2`
raises, and an `F0_path` with `inline_f0: false` is not read.
"""

import numpy as np
import pytest
import torch

from facodec_tpu_torch.models.builder import (build_redecoder_train_from_fields,
                                              build_train_from_fields)
from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.models.quantize import VectorQuantize
from facodec_tpu_torch.train import loop, redecoder_loop
from facodec_tpu_torch.train.data import PseudoDataset
from facodec_tpu_torch.train.optimizers import build_optimizers
from facodec_tpu_torch.train.probes import SUBSETS
from facodec_tpu_torch.train.redecoder_step import (make_redecoder_train_step,
                                                    make_redecoder_train_step_split)
from facodec_tpu_torch.train.step import make_codec_train_step, make_codec_train_step_split
from facodec_tpu_torch.utils.weights import init_random_

FRAMES, HOP, B = 4, 300, 2
# tests/test_train_step.py `tiny_models`, every draw in play
FIELDS = dict(
    encoder=dict(d_model=8, strides=(15, 20), d_latent=64, causal=True, lstm=1),
    quantizer=dict(in_dim=64, n_p_codebooks=1, n_c_codebooks=2, n_t_codebooks=2,
                   n_r_codebooks=3, codebook_size=32, codebook_dim=4, quantizer_dropout=0.5,
                   causal=True, separate_prosody_encoder=True, timbre_norm=True,
                   style_hidden_dim=32, prosody_hidden_dim=16),
    decoder=dict(input_channel=64, channels=16, rates=(20, 15), causal=True, lstm=1),
    discriminator=dict(rates=(), periods=(2,), fft_sizes=(512,), sample_rate=24000),
    fa_predictors=dict(in_dim=64, use_gr_content_f0=False, use_gr_prosody_phone=False,
                       use_gr_residual_f0=True, use_gr_residual_phone=True,
                       use_gr_timbre_content=True, use_gr_timbre_prosody=False,
                       use_gr_x_timbre=True, norm_f0=True, timbre_norm=True,
                       use_gr_content_global_f0=True, n_phone_classes=32, n_speakers=16),
)
# tests/test_redecoder_train.py `tiny_redecoder_models`, dropout 0.2
RED_FIELDS = dict(
    codec=dict(encoder=FIELDS["encoder"], quantizer=FIELDS["quantizer"]),
    encoder=dict(n_p_codebooks=1, n_c_codebooks=2, codebook_size=32, embed_dim=16, n_layers=2,
                 causal=True, p_dropout=0.2, gin_channels=64, out_dim=64),
    decoder=dict(input_channel=64, channels=16, rates=(20, 15), causal=True, lstm=1),
    discriminator=dict(rates=(), periods=(2,), fft_sizes=(512,), sample_rate=24000),
)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
REMAT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny widths gain nothing from torch's intra-op threads, and the
    suite runs several files at once: one thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(seed=0):
    """tests/test_train_step.py `make_batch`, as tensors."""
    rng = np.random.default_rng(seed)
    tw = FRAMES * HOP
    arrays = dict(
        wave_seg=(rng.standard_normal((B, tw)) * 0.3).astype(np.float32),
        mel_seg=(rng.standard_normal((B, FRAMES, 80)) * 0.5).astype(np.float32),
        f0=(np.abs(rng.standard_normal((B, FRAMES))) * 200).astype(np.float32),
        phone_ids=rng.integers(0, 32, (B, FRAMES)).astype(np.int32),
        spk_labels=rng.integers(0, 16, (B,)).astype(np.int32),
        full_waves=(rng.standard_normal((B, 2 * tw)) * 0.3).astype(np.float32),
        wave_lens=np.full((B,), 2 * tw, np.int32),
    )
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def codec_setup():
    models = build_train_from_fields(FIELDS)
    gen = torch.Generator().manual_seed(0)
    for k in loop.MODULES:
        init_random_(models[k], gen)
    return models, build_optimizers(models, base_lr=1e-4)


def redecoder_setup():
    codec = redecoder_loop.build_frozen_codec(RED_FIELDS["codec"], "cpu")
    models = redecoder_loop.build_redecoder_models(RED_FIELDS, 0, "cpu")
    return codec, models, build_optimizers(models, base_lr=1e-4)


def count_calls(modules):
    """Counters of ResidualUnit forwards and VQ searches in `modules`."""
    counts = dict(units=0, searches=0)

    def bump(key):
        def hook(*_):
            counts[key] += 1
        return hook

    for part in modules:
        for m in part.modules():
            if isinstance(m, ResidualUnit):
                m.register_forward_pre_hook(bump("units"))
            if isinstance(m, VectorQuantize):
                m.in_proj.register_forward_hook(bump("searches"))
    return counts


def run_codec(make, seed=1, **kw):
    models, optimizers = codec_setup()
    counts = count_calls(models.values())
    metrics, grads = make(models, optimizers, **kw)(make_batch(),
                                                    torch.Generator().manual_seed(seed))
    return dict(models=models, metrics=metrics, grads=grads, counts=dict(counts))


def run_redecoder(make, seed=1, **kw):
    codec, models, optimizers = redecoder_setup()
    counts = count_calls(list(codec.values()) + list(models.values()))
    metrics, grads = make(codec, models, optimizers, **kw)(make_batch(),
                                                           torch.Generator().manual_seed(seed))
    return dict(models=models, metrics=metrics, grads=grads, counts=dict(counts))


VARIANTS = {
    "codec": (run_codec, make_codec_train_step, make_codec_train_step_split),
    "redecoder": (run_redecoder, make_redecoder_train_step, make_redecoder_train_step_split),
}


@pytest.fixture(scope="module")
def fused():
    return {name: run(make) for name, (run, make, _) in VARIANTS.items()}


def assert_metrics_close(got, want, tol):
    assert set(got) == set(want)
    for k in sorted(want):
        assert np.isfinite(float(got[k])), k
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **tol)


# The style encoder's attention key bias has a gradient of 0 in exact
# arithmetic (it shifts every score of a query alike, and the softmax
# ignores that), so its computed gradient is rounding noise, and AdamW's
# first step moves it by up to lr whatever the noise's size and sign. The
# split step's phase D forward runs without a graph, and torch's CPU LSTM
# and convolutions round one ulp otherwise there, so that noise differs.
NOISE_ONLY = ("timbre_encoder.slf_attn.conv_k.bias",)
LR = 1e-4


@pytest.mark.parametrize("stage", sorted(VARIANTS))
def test_split_step_matches_fused(fused, stage):
    """Metrics and updated parameters within 1e-5; a parameter whose
    gradient is noise only within AdamW's first step of each other, its
    gradient under 1e-6 of the module's gradient norm in both steps."""
    run, _, make_split = VARIANTS[stage]
    split = run(make_split)
    assert_metrics_close(split["metrics"], fused[stage]["metrics"], STEP_TOL)
    for key, m in fused[stage]["models"].items():
        norm = float(fused[stage]["metrics"][f"grad_norm/{key}"])
        for (name, want), got, g_a, g_b in zip(m.named_parameters(),
                                               split["models"][key].parameters(),
                                               fused[stage]["grads"][key], split["grads"][key]):
            if name in NOISE_ONLY:
                for g in (g_a, g_b):
                    assert g.abs().max().item() <= 1e-6 * norm, name
                tol = dict(rtol=0, atol=2 * LR)
            else:
                tol = STEP_TOL
            np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                                       err_msg=f"{key}.{name}", **tol)


@pytest.mark.parametrize("stage", sorted(VARIANTS))
def test_remat_matches_fused(fused, stage):
    run, make, _ = VARIANTS[stage]
    remat = run(make, remat=True)
    assert_metrics_close(remat["metrics"], fused[stage]["metrics"], REMAT_TOL)
    for key, want in fused[stage]["grads"].items():
        for i, (a, b) in enumerate(zip(remat["grads"][key], want)):
            if b is None:
                assert a is None, f"{key}[{i}]"
                continue
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=f"{key}[{i}]",
                                       **REMAT_TOL)


def test_remat_replays_the_generator():
    """Two different seeds give different steps (the masks are in play), and
    the generator leaves a remat step where it leaves a fused one."""
    models, optimizers = codec_setup()
    gens = [torch.Generator().manual_seed(1) for _ in range(2)]
    make_codec_train_step(models, optimizers)(make_batch(), gens[0])
    models, optimizers = codec_setup()
    make_codec_train_step(models, optimizers, remat=True)(make_batch(), gens[1])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    a = run_codec(make_codec_train_step, seed=1)["metrics"]["loss/gen_all"]
    b = run_codec(make_codec_train_step, seed=2)["metrics"]["loss/gen_all"]
    assert float(a) != float(b)


# (residual units, VQ searches) per step: the codec's encoder and decoder
# have 6 units each and its quantizer 6 searches; the redecoder stage runs
# the frozen encoder's 6 units and 6 searches once, and its decoder's 6
EXPECTED_CALLS = {
    ("codec", "fused"): (12, 6), ("codec", "split"): (24, 12), ("codec", "remat"): (24, 12),
    ("codec", "split+remat"): (36, 18),
    ("redecoder", "fused"): (12, 6), ("redecoder", "split"): (18, 6),
    ("redecoder", "remat"): (18, 6), ("redecoder", "split+remat"): (24, 6),
}


@pytest.mark.parametrize("stage,variant", sorted(EXPECTED_CALLS))
def test_variant_calls(fused, stage, variant):
    run, make, make_split = VARIANTS[stage]
    if variant == "fused":
        counts = fused[stage]["counts"]
    else:
        counts = run(make_split if "split" in variant else make, remat="remat" in variant)[
            "counts"]
    assert (counts["units"], counts["searches"]) == EXPECTED_CALLS[stage, variant]


# ------------------------------------------------------------------ the loop
class Writer:
    def __init__(self):
        self.scalars, self.audio = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def add_audio(self, tag, wave, step, sample_rate):
        assert wave.ndim == 2 and wave.shape[1] == 1 and sample_rate == 24000
        assert np.all(np.abs(wave) <= 1.0)
        self.audio.append((tag, step))


def dataset():
    return PseudoDataset(length=4, seed=0, min_s=1.0, max_s=1.5, n_phones=32, n_speakers=16)


def train(tmp_path, max_steps=1, **kw):
    kw.setdefault("log_writer", False)
    return loop.run_training(fields=FIELDS, dataset=dataset(), max_steps=max_steps,
                             device="cpu", log_dir=str(tmp_path), batch_size=2, max_len=8, **kw)


@pytest.mark.parametrize("key", ["split_step", "remat"])
def test_loop_honours_step_options(tmp_path, monkeypatch, key):
    """`split_step` builds the split step and `remat` reaches it, as the JAX
    loop passes them; `donate_params` changes nothing."""
    calls = []
    for name in ("make_codec_train_step", "make_codec_train_step_split"):
        real = getattr(loop, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, k.get("remat")))
            return _real(*a, **k)

        monkeypatch.setattr(loop, name, spy)
    state = train(tmp_path, donate_params=True, **{key: True})
    assert state.step == 1 and all(np.isfinite(v) for v in state.metrics.values())
    want = ("make_codec_train_step_split", False) if key == "split_step" else (
        "make_codec_train_step", True)
    assert calls == [want]


def test_loop_logs_probes(tmp_path):
    """With a writer, every probe_interval steps: the six stream subsets,
    the timbre swap and the ground truth, one item each."""
    writer = Writer()
    train(tmp_path, max_steps=2, log_writer=writer, log_interval=1, probe_interval=2)
    names = [f"probe/{s}/0" for s in SUBSETS] + ["probe/timbre_swap/0", "probe/ground_truth/0"]
    assert sorted(writer.audio) == sorted((n, 2) for n in names)
    assert ("train/loss/gen_all", 1) in writer.scalars


def test_loop_raises_on_unported_keys(tmp_path):
    """`tensor_parallel: 2` in one plain process raises the layout's error
    (a world of 1 does not divide over a model axis of 2, where JAX's
    `make_mesh` fails on one device too; ranks train it,
    tests/test_torch_tp.py); an F0_path with `inline_f0: false` trains on
    the batch's F0 without reading the file (tests/test_torch_jdc.py runs
    an existing F0_path as the inline teacher)."""
    f0 = tmp_path / "jdc.pth"
    f0.write_bytes(b"")
    with pytest.raises(ValueError, match="a world of 1 rank.s. is not divisible by a model "
                                         "axis of 2"):
        train(tmp_path, tensor_parallel=2)
    # the offline targets, as the JAX loop takes them with inline_f0 off
    assert train(tmp_path / "off", F0_path=str(f0), inline_f0=False).step == 1
