"""The JDC F0 teacher of the port against the JAX package's, on the CPU, and
the codec step and loop that run it inline.

JDCNet has one width (the reference's num_class=1 teacher), so it is tested
at it. Weights come by two routes, and each must give JAX's F0 within
2e-4 x max|F0_JAX| + 2e-4 (the golden tolerance, scaled to Hz) at (B, T) =
(2, 24) and (1, 37):
- the JAX module's parameter tree (its `init`'s structure, seeded values,
  BatchNorm statistics randomised) carried across by
  `utils.weights.load_jax_jdc_params`;
- a seeded state dict in the reference's layout (detector branch and
  `num_batches_tracked` included) written to a `{'net': sd}` file that both
  packages' `load_jdc_checkpoint` read.
The seeded teacher's F0 lies far above the 5 Hz voiced threshold of
`normalize_f0`, so no utterance has exactly one voiced frame.

The step with `f0_teacher` (fused and split) must equal, within 1e-6, the
same step fed `batch["f0"] = teacher(mel_seg)`, and leave the teacher
without gradients and unchanged. The draws-off step test
(tests/test_torch_train_step.py) ties the step itself to JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.models.jdc import JDCNet as JJDCNet
from facodec_tpu.models.jdc import load_jdc_checkpoint as j_load_jdc_checkpoint
from facodec_tpu_torch.models.builder import build_train_from_fields
from facodec_tpu_torch.models.jdc import (JDCNet, load_jdc_checkpoint,
                                          random_reference_state_dict)
from facodec_tpu_torch.train import loop
from facodec_tpu_torch.train.data import PseudoDataset
from facodec_tpu_torch.train.optimizers import build_optimizers
from facodec_tpu_torch.train.step import make_codec_train_step, make_codec_train_step_split
from facodec_tpu_torch.utils.weights import init_random_, load_jax_jdc_params

SHAPES = [(2, 24), (1, 37)]
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
_j_apply = jax.jit(JJDCNet().apply)

# tests/test_torch_train_options.py FIELDS: the tiny codec stage, every draw in play
FRAMES, HOP, B = 4, 300, 2
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several files at once: one torch thread each here,
    restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jdc_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("jdc") / "bst.t7"
    torch.save({"net": random_reference_state_dict(0)}, path)
    return str(path)


@pytest.fixture(scope="module")
def jax_init_params():
    """The JAX module's own parameter tree (the structure and shapes its
    `init` returns, from `jax.eval_shape`, which skips init's slow CPU
    compile), filled from a seed: every BatchNorm's statistics, weight and
    bias randomised, the rest U(-1/sqrt(fan_in), +)."""
    shapes = jax.eval_shape(JJDCNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 80)))["params"]
    rng = np.random.default_rng(1)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k in ("running_var", "weight") and "running_mean" in tree:
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("running_mean", "bias") and "running_mean" in tree:
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            else:
                fan_in = 256 if k.startswith("bilstm") else 512 if len(v.shape) == 1 else int(
                    np.prod(v.shape[1:]))
                out[k] = rng.uniform(-1, 1, v.shape).astype(np.float32) / np.float32(
                    np.sqrt(fan_in))
        return out

    return fill(shapes)


def mel_input(B, T):
    return (np.random.default_rng(B * 100 + T).standard_normal((B, T, 80)) - 2.0
            ).astype(np.float32)


def port_f0(model, mel):
    with torch.no_grad():
        f0, feat = model(torch.from_numpy(mel))
    return f0.numpy(), feat.numpy()


@pytest.mark.parametrize("route", ["jax_init", "reference_file"])
@pytest.mark.parametrize("B,T", SHAPES)
def test_jdc_matches_jax(jdc_file, jax_init_params, route, B, T):
    if route == "jax_init":
        params = jax_init_params
        model = JDCNet()
        load_jax_jdc_params(model, params)
    else:
        params = j_load_jdc_checkpoint(jdc_file)
        model = load_jdc_checkpoint(jdc_file, "cpu")
    mel = mel_input(B, T)
    want, want_feat = (np.asarray(a) for a in _j_apply({"params": params}, jnp.asarray(mel)))
    got, got_feat = port_f0(model.eval(), mel)
    assert got.shape == want.shape == (B, T) and got_feat.shape == want_feat.shape == (B, T, 512)
    np.testing.assert_allclose(got_feat, want_feat, rtol=2e-4, atol=2e-4)
    tol = 2e-4 * np.abs(want).max() + 2e-4
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    if route == "reference_file":
        assert want.min() > 5.0  # every frame voiced: normalize_f0 sees no lone voiced frame


def test_load_jax_jdc_params_raises_on_missing_and_left_over(jax_init_params):
    params = {k: v for k, v in jax_init_params.items() if k != "classifier"}
    with pytest.raises(ValueError, match="without a JAX parameter"):
        load_jax_jdc_params(JDCNet(), params)
    params = dict(jax_init_params, extra={"weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="left over"):
        load_jax_jdc_params(JDCNet(), params)


@pytest.mark.parametrize("layout", ["net", "bare", "ddp_prefix"])
def test_load_jdc_checkpoint_drops_the_unused_keys(tmp_path, layout):
    """The detector branch, the pools' keys and `num_batches_tracked` are
    dropped; the F0 branch is loaded bit for bit."""
    sd = random_reference_state_dict(0)
    sd["maxpool1.dummy"] = torch.zeros(1)
    assert any(k.startswith("detector") for k in sd) and any(
        k.endswith("num_batches_tracked") for k in sd)
    if layout == "ddp_prefix":
        sd = {"module." + k: v for k, v in sd.items()}
    path = tmp_path / "jdc.pth"
    torch.save({"net": sd} if layout != "bare" else sd, path)
    model = load_jdc_checkpoint(str(path), "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[("module." if layout == "ddp_prefix" else "") + k]), k
    assert not any(p.requires_grad for p in model.parameters()) and not model.training


@pytest.mark.parametrize("fault", ["foreign_key", "missing_key"])
def test_load_jdc_checkpoint_raises(tmp_path, fault):
    sd = random_reference_state_dict(0)
    if fault == "foreign_key":
        sd["classifier_extra.weight"] = torch.zeros(1, 512)
    else:
        del sd["res_block2.conv.3.weight"]
    path = tmp_path / "jdc.pth"
    torch.save({"net": sd}, path)
    with pytest.raises(RuntimeError, match="classifier_extra|res_block2.conv.3.weight"):
        load_jdc_checkpoint(str(path), "cpu")


def test_train_mode_leaves_the_teacher_unchanged(jdc_file):
    """The loop calls .train() on modules: the frozen BatchNorms keep their
    running statistics and the output stays the eval output."""
    model = load_jdc_checkpoint(jdc_file, "cpu")
    mel = mel_input(2, 24)
    want, _ = port_f0(model.eval(), mel)
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    got, _ = port_f0(model.train(), mel)
    np.testing.assert_array_equal(got, want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, stats[k]), k


# ------------------------------------------------------------ the step
def make_batch(seed=0):
    """tests/test_torch_train_options.py `make_batch`."""
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


def run_step(make, batch, teacher=None):
    models = build_train_from_fields(FIELDS)
    gen = torch.Generator().manual_seed(0)
    for k in loop.MODULES:
        init_random_(models[k], gen)
    marks = []
    metrics, grads = make(models, build_optimizers(models), f0_teacher=teacher)(
        batch, torch.Generator().manual_seed(1), mark=marks.append)
    return metrics, grads, models, marks


@pytest.mark.parametrize("make", [make_codec_train_step, make_codec_train_step_split],
                         ids=["fused", "split"])
def test_step_with_teacher_equals_offline_f0(jdc_file, make):
    teacher = load_jdc_checkpoint(jdc_file, "cpu")
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    batch = make_batch()
    with torch.no_grad():
        f0, _ = teacher(batch["mel_seg"])
    assert not torch.allclose(f0, batch["f0"])  # the teacher's F0 is the one that counts
    got, got_grads, got_models, marks = run_step(make, batch, teacher)
    want, want_grads, want_models, _ = run_step(make, dict(batch, f0=f0))
    assert marks[0] == "teacher"
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **STEP_TOL)
    for key in want_grads:
        for a, b in zip(got_grads[key], want_grads[key]):
            assert (a is None) == (b is None), key
            if b is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=key, **STEP_TOL)
    for key, m in want_models.items():
        for (name, p), q in zip(m.named_parameters(), got_models[key].parameters()):
            np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                       err_msg=f"{key}.{name}", **STEP_TOL)
    # no gradient reaches the teacher, and the step leaves it as it was
    assert all(p.grad is None for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("split_step", [False, True], ids=["fused", "split"])
def test_run_training_runs_the_teacher_of_f0_path(tmp_path, jdc_file, capsys, monkeypatch,
                                                  split_step):
    """An existing F0_path is the inline teacher: the loop prints its line,
    hands it to the step it builds, and takes a step."""
    seen = []
    name = "make_codec_train_step_split" if split_step else "make_codec_train_step"
    real = getattr(loop, name)

    def spy(*a, **k):
        seen.append(k["f0_teacher"])
        return real(*a, **k)

    monkeypatch.setattr(loop, name, spy)
    ds = PseudoDataset(length=4, seed=0, min_s=1.0, max_s=1.5, n_phones=32, n_speakers=16)
    state = loop.run_training(fields=FIELDS, dataset=ds, max_steps=1, device="cpu",
                              log_dir=str(tmp_path), batch_size=2, max_len=8, log_writer=False,
                              F0_path=jdc_file, split_step=split_step)
    assert f"inline F0 teacher: {jdc_file}" in capsys.readouterr().out
    assert len(seen) == 1 and isinstance(seen[0], JDCNet) and not seen[0].training
    assert state.step == 1 and all(np.isfinite(v) for v in state.metrics.values())
