"""Redecoder training in the port against the JAX package, on the CPU.

The tiny frozen codec and redecoder stage of tests/test_redecoder_train.py
(their fields copied here) are built on both sides; seeded random weights
are drawn once (the port's `init_random_`, read out as JAX parameter trees
by key name) and move into the port with `load_jax_params`. The fused step
runs with every draw out of play (the Redecoder's `p_dropout` 0 on both
sides; the frozen codec runs in eval, with no draw) on one numpy batch.
Held, at the golden tolerance rtol = atol = 2e-4
(tests/test_model_parity.py):
- the frozen encode's codes bit-exact, its timbre;
- one fused step against JAX `make_redecoder_train_step`: every metric
  and the updated parameters of the Redecoder, the decoder and the
  discriminator;
- `resample_frac`, `MSD` at rates 1 and 2, `Discriminator(rates=(1, 2))`
  with its weight keys, the Redecoder in train mode at p_dropout 0 against
  JAX's in eval, and `make_probe_fn`'s waves against JAX's.
Port only: the Redecoder's dropout rate and its masks' generator, and the
loop (`run_redecoder_training`: checkpoints, rotation, resume, one seed's
determinism, the frozen codec bit for bit, a codec checkpoint of
`run_training` as its frozen codec) and the `train-redecoder` command.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.models.dac import Decoder as JDecoder
from facodec_tpu.models.dac import Encoder as JEncoder
from facodec_tpu.models.discriminator import MSD as JMSD
from facodec_tpu.models.discriminator import Discriminator as JDiscriminator
from facodec_tpu.models.fa_quantizer import FAquantizer as JFAquantizer
from facodec_tpu.models.redecoder import Redecoder as JRedecoder
from facodec_tpu.ops.resample import resample_frac as j_resample_frac
from facodec_tpu.train.optimizers import build_optimizers as j_build_optimizers
from facodec_tpu.train.optimizers import init_opt_states
from facodec_tpu.train.probes import make_probe_fn as j_make_probe_fn
from facodec_tpu.train.redecoder_step import _make_redecoder_parts, make_redecoder_train_step
from facodec_tpu.train.step import TrainState as JTrainState
from facodec_tpu_torch.__main__ import main as cli_main
from facodec_tpu_torch.models import wavenet
from facodec_tpu_torch.models.discriminator import MSD, Discriminator
from facodec_tpu_torch.models.redecoder import Redecoder
from facodec_tpu_torch.ops.resample import resample_frac
from facodec_tpu_torch.train import loop, redecoder_loop
from facodec_tpu_torch.train.data import PseudoDataset
from facodec_tpu_torch.train.optimizers import build_optimizers
from facodec_tpu_torch.train.probes import make_probe_fn
from facodec_tpu_torch.train.redecoder_step import frozen_encode
from facodec_tpu_torch.train.redecoder_step import make_redecoder_train_step as port_step
from facodec_tpu_torch.utils.weights import (flatten_tree, init_random_, load_jax_params,
                                             torch_key_to_path)

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, HOP, B = 4, 300, 2
# tests/test_redecoder_train.py `tiny_codec` and `tiny_redecoder_models`,
# the Redecoder's dropout 0
CODEC = dict(
    encoder=dict(d_model=8, strides=(15, 20), d_latent=64, causal=True, lstm=1),
    quantizer=dict(in_dim=64, n_p_codebooks=1, n_c_codebooks=2, n_t_codebooks=2,
                   n_r_codebooks=3, codebook_size=32, codebook_dim=4, quantizer_dropout=0.5,
                   causal=True, separate_prosody_encoder=True, timbre_norm=True,
                   style_hidden_dim=32, prosody_hidden_dim=16),
)
FIELDS = dict(
    codec=CODEC,
    encoder=dict(n_p_codebooks=1, n_c_codebooks=2, codebook_size=32, embed_dim=16, n_layers=2,
                 causal=True, p_dropout=0.0, gin_channels=64, out_dim=64),
    decoder=dict(input_channel=64, channels=16, rates=(20, 15), causal=True, lstm=1),
    discriminator=dict(rates=(), periods=(2,), fft_sizes=(512,), sample_rate=24000),
)
J_CLASSES = dict(encoder=JRedecoder, decoder=JDecoder, discriminator=JDiscriminator)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny widths gain nothing from torch's intra-op threads, and the
    suite runs several files at once: one thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(rng, batch=B):
    """tests/test_redecoder_train.py `make_batch`, as numpy."""
    tw = FRAMES * HOP
    return dict(
        wave_seg=(rng.standard_normal((batch, tw)) * 0.3).astype(np.float32),
        full_waves=(rng.standard_normal((batch, 2 * tw)) * 0.3).astype(np.float32),
        wave_lens=np.full((batch,), 2 * tw, np.int32),
    )


def jax_tree(module: torch.nn.Module) -> dict:
    """The module's parameters as a nested JAX parameter tree, by key name."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *parents, leaf = torch_key_to_path(name)
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return tree


def by_path(module, tree):
    flat = flatten_tree(tree)
    return {name: np.asarray(flat[torch_key_to_path(name)])
            for name, _ in module.named_parameters()}


def port_side(params):
    """The port's frozen codec and redecoder stage on the JAX weights."""
    codec = redecoder_loop.build_frozen_codec(CODEC, "cpu")
    models = redecoder_loop.build_redecoder_models(FIELDS, 0, "cpu")
    for k, m in codec.items():
        load_jax_params(m, params["codec"][k])
    for k, m in models.items():
        load_jax_params(m, params[k])
    return codec, models


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    codec = redecoder_loop.build_frozen_codec(CODEC, "cpu")
    models = redecoder_loop.build_redecoder_models(FIELDS, 0, "cpu")
    codec_params = {k: jax_tree(m) for k, m in codec.items()}
    params = {k: jax_tree(m) for k, m in models.items()}
    j_codec = dict(encoder=JEncoder(**CODEC["encoder"]),
                   quantizer=JFAquantizer(**CODEC["quantizer"]))
    j_models = {k: J_CLASSES[k](**FIELDS[k]) for k in J_CLASSES}
    optimizers = j_build_optimizers(j_models.keys(), base_lr=1e-4)
    opt_states = init_opt_states(optimizers, params)
    batch = make_batch(np.random.default_rng(7))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(make_redecoder_train_step(j_codec, codec_params, j_models, optimizers))
    state, metrics = step(JTrainState(params, opt_states, jnp.zeros((), jnp.int32)), jb,
                          jax.random.PRNGKey(0))
    encode = _make_redecoder_parts(j_codec, codec_params, j_models)["frozen_encode"]
    codes, timbre = jax.jit(encode)(jb)
    probe = j_make_probe_fn(dict(j_codec, decoder=j_models["decoder"]))(
        dict(codec_params, decoder=params["decoder"]), jb)
    return dict(params=dict(params, codec=codec_params), batch=batch, j_models=j_models,
                metrics={k: float(v) for k, v in metrics.items()},
                updated=jax.tree.map(np.asarray, state.params),
                codes=[np.asarray(c) for c in codes], timbre=np.asarray(timbre),
                probe={k: np.asarray(v) for k, v in probe.items()})


def test_frozen_encode_matches_jax(jax_side):
    codec, _ = port_side(jax_side["params"])
    codes, timbre = frozen_encode(codec, tensors(jax_side["batch"]))
    assert len(codes) == 3
    for got, want in zip(codes, jax_side["codes"]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(timbre.numpy(), jax_side["timbre"], **TOL)


@pytest.fixture(scope="module")
def port_run(jax_side):
    codec, models = port_side(jax_side["params"])
    before = {k: {n: t.clone() for n, t in m.state_dict().items()} for k, m in codec.items()}
    optimizers = build_optimizers(models, base_lr=1e-4)
    metrics, grads = port_step(codec, models, optimizers)(tensors(jax_side["batch"]), None)
    return dict(codec=codec, before=before, models=models, metrics=metrics, grads=grads)


def test_step_metrics_match_jax(jax_side, port_run):
    want = jax_side["metrics"]
    got = {k: float(v) for k, v in port_run["metrics"].items()}
    assert set(want) == {k for k in got if not k.startswith("grad_norm/")}
    assert {f"grad_norm/{k}" for k in redecoder_loop.MODULES} <= set(got)
    for k in sorted(want):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("module", redecoder_loop.MODULES)
def test_step_updates_match_jax(jax_side, port_run, module):
    port = port_run["models"][module]
    want = by_path(port, jax_side["updated"][module])
    start = by_path(port, jax_side["params"][module])
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], err_msg=name, **TOL)
    assert any(not np.array_equal(want[n], start[n]) for n in want)


def test_step_leaves_frozen_codec(port_run):
    for k, m in port_run["codec"].items():
        for n, t in m.state_dict().items():
            assert torch.equal(t, port_run["before"][k][n]), f"{k}.{n}"
        assert not any(p.requires_grad for p in m.parameters())


@pytest.mark.parametrize("old,new,length", [(24000, 12000, 2400), (24000, 6000, 2400),
                                            (24000, 12000, 2401), (44100, 22050, 1999)])
def test_resample_frac_matches_jax(old, new, length):
    x = np.random.default_rng(length).standard_normal((2, 3, length)).astype(np.float32)
    want = np.asarray(j_resample_frac(jnp.asarray(x), old, new))
    got = resample_frac(torch.from_numpy(x), old, new).numpy()
    assert got.shape == want.shape == (2, 3, int(new * length / old))
    np.testing.assert_allclose(got, want, **TOL)


def nchw_as_jax(t: torch.Tensor) -> np.ndarray:
    """A port feature map in the JAX layout: 2-D maps NCHW -> NHWC."""
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


@pytest.mark.parametrize("rate", [1, 2])
def test_msd_matches_jax(rate):
    msd = init_random_(MSD(rate, sample_rate=24000), torch.Generator().manual_seed(rate))
    x = (np.random.default_rng(rate).standard_normal((2, 600, 1)) * 0.3).astype(np.float32)
    want = jax.jit(JMSD(rate, sample_rate=24000).apply)({"params": jax_tree(msd)},
                                                        jnp.asarray(x))
    got = msd(torch.from_numpy(x))
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(nchw_as_jax(g), np.asarray(w), err_msg=f"fmap {i}", **TOL)


def test_discriminator_with_msd_matches_jax():
    """MPD, then the MSDs, then MRD, under the JAX module's keys."""
    kw = dict(rates=(1, 2), periods=(2,), fft_sizes=(512,), sample_rate=24000)
    disc = init_random_(Discriminator(**kw), torch.Generator().manual_seed(3))
    x = (np.random.default_rng(3).standard_normal((2, 600, 1)) * 0.3).astype(np.float32)
    jdisc = JDiscriminator(**kw)
    shapes = jax.eval_shape(lambda: jdisc.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    assert {torch_key_to_path(n) for n, _ in disc.named_parameters()} == set(flatten_tree(shapes))
    assert {n.split(".")[1] for n, _ in disc.named_parameters() if ".convs.5." in n} == {"1", "2"}
    want = jax.jit(jdisc.apply)({"params": jax_tree(disc)}, jnp.asarray(x))
    got = disc(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for d, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws)
        for i, (g, w) in enumerate(zip(gs, ws)):
            np.testing.assert_allclose(nchw_as_jax(g), np.asarray(w), err_msg=f"{d}/{i}", **TOL)


def redecoder_inputs(seed=0, T=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, (B, 1, T)).astype(np.int32),
            rng.integers(0, 32, (B, 2, T)).astype(np.int32),
            rng.standard_normal((B, 64)).astype(np.float32))


def test_redecoder_train_mode_matches_jax_eval(jax_side):
    red = Redecoder(**FIELDS["encoder"])
    load_jax_params(red, jax_side["params"]["encoder"])
    cp, cc, t = redecoder_inputs()
    want = jax.jit(jax_side["j_models"]["encoder"].apply)(
        {"params": jax_side["params"]["encoder"]}, cp, cc, t)
    got = red(torch.from_numpy(cp), torch.from_numpy(cc), torch.from_numpy(t), train=True,
              generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_redecoder_dropout_follows_generator(monkeypatch):
    """p = 0.2: about a fifth of the gated activations dropped, masks from
    the generator alone (one seed twice gives one output, whatever torch's
    global RNG), and eval is the same module with no draw."""
    kept = []
    real = wavenet.dropout

    def spy(x, p, train, generator):
        y = real(x, p, train, generator)
        if train:
            kept.append(float((y != 0).float().mean()))
        return y

    monkeypatch.setattr(wavenet, "dropout", spy)
    red = init_random_(Redecoder(**dict(FIELDS["encoder"], p_dropout=0.2)),
                       torch.Generator().manual_seed(1))
    args = [torch.from_numpy(a) for a in redecoder_inputs(T=64)]
    with torch.no_grad():
        torch.manual_seed(1)
        a = red(*args, train=True, generator=torch.Generator().manual_seed(5))
        torch.manual_seed(2)
        b = red(*args, train=True, generator=torch.Generator().manual_seed(5))
        c = red(*args, train=True, generator=torch.Generator().manual_seed(6))
        e = red(*args)
    assert len(kept) == 3 * FIELDS["encoder"]["n_layers"]
    assert abs(np.mean(kept) - 0.8) < 0.02, np.mean(kept)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, e)
    with pytest.raises(ValueError, match="Generator"):
        red(*args, train=True)


def test_probes_match_jax(jax_side):
    codec, models = port_side(jax_side["params"])
    got = make_probe_fn(dict(codec, decoder=models["decoder"]))(tensors(jax_side["batch"]))
    want = jax_side["probe"]
    assert set(got) == set(want) and len(want) == 8
    for k in sorted(want):
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)


# ------------------------------------------------------------------ the loop
def train(log_dir, max_steps, pseudo_length=4, **kw):
    return redecoder_loop.run_redecoder_training(
        fields=dict(FIELDS, encoder=dict(FIELDS["encoder"], p_dropout=0.2)),
        dataset=PseudoDataset(length=pseudo_length, seed=0, min_s=1.0, max_s=1.4),
        max_steps=max_steps, device="cpu", log_dir=str(log_dir), log_writer=False,
        batch_size=2, max_len=8, **kw)


def params_of(models):
    return {f"{k}.{n}": p.detach().clone() for k, m in models.items()
            for n, p in m.state_dict().items()}


def test_loop_saves_rotates_resumes_and_is_deterministic(tmp_path):
    a = train(tmp_path / "a", 2, save_interval=2)
    assert a.step == 2 and all(np.isfinite(v) for v in a.metrics.values())
    assert {"loss/gen_all", "loss/disc", "grad_norm/decoder"} <= set(a.metrics)
    path = loop.latest_checkpoint(str(tmp_path / "a"))
    assert os.path.basename(path) == "FAcodec_epoch_00000_step_00002.pth"
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["step"] == 2 and set(ckpt["net"]) == set(redecoder_loop.MODULES)

    b = train(tmp_path / "b", 2, save_interval=2)
    pa, pb = params_of(a.models), params_of(b.models)
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0, msg=k)
    seeded = redecoder_loop.build_frozen_codec(CODEC, "cpu")
    for k, v in params_of(a.frozen).items():
        torch.testing.assert_close(v, params_of(seeded)[k], rtol=0, atol=0, msg=k)
    start = params_of(redecoder_loop.build_redecoder_models(FIELDS, 0, "cpu"))
    for module in redecoder_loop.MODULES:
        assert any(not torch.equal(pa[k], start[k]) for k in pa if k.startswith(module + "."))

    resumed = train(tmp_path / "a", 3, save_interval=2)
    assert resumed.step == 3 and resumed.optimizers["decoder"].count == 3

    # 2 utterances in batches of 2: an epoch is 1 step, and its end saves
    # once more; of the 7 files written the newest 5 stay
    many = train(tmp_path / "rot", 4, save_interval=1, pseudo_length=2)
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "rot" / "*.pth")))
    assert many.step == 4
    assert names == [f"FAcodec_epoch_{e:05d}_step_{s:05d}.pth"
                     for e, s in ((1, 2), (2, 2), (2, 3), (3, 3), (3, 4))]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the raise without a CUDA device")
def test_loop_defaults_to_the_card(tmp_path):
    """The entry point trains on the card unless asked for the CPU, and
    raises where torch sees no CUDA device."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        redecoder_loop.run_redecoder_training(fields=FIELDS, max_steps=1,
                                              log_dir=str(tmp_path), log_writer=False)


def test_two_stage_pipeline_and_command(tmp_path, monkeypatch, capsys):
    """A checkpoint of the codec trainer is the frozen codec, through the
    loop and through the `train-redecoder` command."""
    monkeypatch.setattr(loop, "_default_writer", lambda log_dir: None)
    tiny = os.path.join(ROOT, "tests", "tiny_config.yml")
    codec_run = loop.run_training(config_path=tiny, device="cpu", max_steps=1,
                                  log_dir=str(tmp_path / "codec"), log_writer=False,
                                  save_interval=1)
    ckpt = loop.latest_checkpoint(str(tmp_path / "codec"))
    state = cli_main(["train-redecoder", "--config-path", tiny, "--device", "cpu",
                      "--max-steps", "1", "--log-dir", str(tmp_path / "red"),
                      "--pretrained-encoder", ckpt])
    assert state.step == 1 and "trained to step 1" in capsys.readouterr().out
    for k in redecoder_loop.CODEC_MODULES:
        want = codec_run.models[k].state_dict()
        for n, t in state.frozen[k].state_dict().items():
            torch.testing.assert_close(t, want[n], rtol=0, atol=0, msg=f"{k}.{n}")
    with pytest.raises(FileNotFoundError):
        redecoder_loop.run_redecoder_training(config_path=tiny, device="cpu", max_steps=1,
                                              log_dir=str(tmp_path / "x"), log_writer=False,
                                              pretrained_encoder=str(tmp_path / "missing.pth"))
