"""The port's training draws, loop and `train` command, on the CPU (port only).

- Draws: every draw of a train-mode forward comes from the generator it is
  given (one seed, the same result twice; no global RNG), the quantizer
  dropout touches only the first int(B * quantizer_dropout) rows and keeps
  1..N stages there, the residual stream is kept at 1 - 0.75 per row, and
  every dropout is the identity in eval.
- The loop: `run_training` at the tiny widths of tests/test_train_step.py
  on `PseudoDataset` takes 2 steps and writes a checkpoint, resumes from it
  to step 3, keeps the newest 5 checkpoints (which the codec's serving
  loader reads), and gives the same parameters in two runs of one seed.
  The `train` command parses and runs on the CPU.
"""

import glob
import os

import numpy as np
import pytest
import torch

from facodec_tpu_torch.__main__ import main as cli_main
from facodec_tpu_torch.models.builder import build_train_from_fields
from facodec_tpu_torch.models.quantize import ResidualVectorQuantize
from facodec_tpu_torch.models.style_encoder import StyleEncoder
from facodec_tpu_torch.models.wavenet import WN
from facodec_tpu_torch.nn.basic import dropout
from facodec_tpu_torch.train import loop
from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch
from facodec_tpu_torch.utils.weights import init_random_, load_torch_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once: eight spinning threads each thrash
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quantizer():
    models = build_train_from_fields(FIELDS)
    return init_random_(models["quantizer"], gen(0))


def train_forward(qt, seed, B=4):
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((B, 4, 64)).astype(np.float32))
    wave = torch.from_numpy((rng.standard_normal((B, 1200)) * 0.3).astype(np.float32))
    with torch.no_grad():
        return qt.forward_v2(z, wave, n_c=2, train=True, generator=gen(seed))


def test_train_forward_draws_from_its_generator(quantizer):
    torch.manual_seed(1)
    a = train_forward(quantizer, 7)
    torch.manual_seed(2)  # the global RNG plays no part
    b = train_forward(quantizer, 7)
    c = train_forward(quantizer, 8)
    for x, y in zip((a[0], *a[1], a[2], a[3], a[4]), (b[0], *b[1], b[2], b[3], b[4])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="Generator"):
        quantizer.forward_v2(torch.zeros(2, 4, 64), torch.zeros(2, 1200), train=True)


def test_quantizer_dropout_rows_and_stages():
    """Rows at or past int(B * 0.5) sum all N stages; each earlier row sums
    its first k stages for one k in 1..N, and every k turns up."""
    torch.manual_seed(0)
    rvq = init_random_(ResidualVectorQuantize(16, 3, 32, 4, quantizer_dropout=0.5), gen(0))
    B, N = 6, 3
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 5, 16)).astype(np.float32))
    with torch.no_grad():
        partial, residual, acc = [], z, torch.zeros_like(z)
        for q in rvq.quantizers:
            z_q_i = q.forward_train(residual)[0]
            residual = residual - z_q_i
            acc = acc + z_q_i
            partial.append(acc)
        g = gen(3)
        seen = set()
        for _ in range(40):
            z_q = rvq.forward_train(z, g)[0]
            for b in range(B):
                ks = [k + 1 for k in range(N) if torch.equal(z_q[b], partial[k][b])]
                assert ks, f"row {b} is no prefix sum of the stages"
                if b >= B // 2:
                    assert ks == [N]
                else:
                    seen.add(ks[0])
    assert seen == {1, 2, 3}


def test_residual_keep_rate(quantizer):
    """p = 0.75: over many draws a quarter of the rows keep z_r; a row that
    drops it carries only the prosody and content streams."""
    B = 64
    keeps = []
    for seed in range(16):
        outs, (z_p, z_c, z_r), *_ , timbre = train_forward(quantizer, seed, B=B)
        with torch.no_grad():
            full = quantizer._timbre_condition(z_p + z_c + z_r, timbre)
            drop = quantizer._timbre_condition(z_p + z_c, timbre)
        for b in range(B):
            kept = torch.allclose(outs[b], full[b], rtol=0, atol=1e-6)
            dropped = torch.allclose(outs[b], drop[b], rtol=0, atol=1e-6)
            assert kept != dropped
            keeps.append(kept)
    assert abs(np.mean(keeps) - 0.25) < 0.05, np.mean(keeps)


def test_dropout_is_identity_in_eval():
    x = torch.randn(4, 50, 16, generator=gen(0))
    assert dropout(x, 0.2, False, None) is x
    y = dropout(x, 0.2, True, gen(1))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.03
    torch.testing.assert_close(y[kept], x[kept] / 0.8)
    wn = init_random_(WN(16, 5, 1, 3, p_dropout=0.2), gen(2))
    se = init_random_(StyleEncoder(16, 32, 8), gen(3))
    with torch.no_grad():
        for m in (wn, se):
            ref = m(x)
            torch.testing.assert_close(m(x, train=False, generator=gen(4)), ref, rtol=0, atol=0)
            assert not torch.equal(m(x, train=True, generator=gen(4)), ref)


def test_segment_batch_draws_from_its_generator():
    ds = PseudoDataset(length=2, seed=0, min_s=1.0, max_s=2.0, n_phones=32, n_speakers=16)
    batch = collate([ds[0], ds[1]], bucket_frames=80)
    a = segment_batch(batch, max_frames=8, generator=gen(5))
    b = segment_batch(batch, max_frames=8, generator=gen(5))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["wave_seg"].shape == (2, 8 * 300)
    with pytest.raises(ValueError, match="Generator"):
        segment_batch(batch, max_frames=8)


def dataset():
    return PseudoDataset(length=8, seed=0, min_s=1.0, max_s=1.5, n_phones=32, n_speakers=16)


def train(log_dir, max_steps, **kw):
    return loop.run_training(fields=FIELDS, dataset=dataset(), max_steps=max_steps, device="cpu",
                             log_dir=str(log_dir), log_writer=False, batch_size=2, max_len=8,
                             **kw)


def params_of(state):
    return {f"{k}.{n}": p.detach().clone() for k, m in state.models.items()
            for n, p in m.named_parameters()}


def test_loop_saves_resumes_and_rotates(tmp_path):
    state = train(tmp_path / "run", 2, save_interval=2)
    assert state.step == 2
    path = loop.latest_checkpoint(str(tmp_path / "run"))
    assert os.path.basename(path) == "FAcodec_epoch_00000_step_00002.pth"
    assert all(np.isfinite(v) for v in state.metrics.values())
    assert {"loss/gen_all", "loss/disc", "grad_norm/fa_predictors"} <= set(state.metrics)

    resumed = train(tmp_path / "run", 3, save_interval=2)
    assert resumed.step == 3
    assert resumed.optimizers["encoder"].count == 3
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["step"] == 2 and set(ckpt["net"]) == set(loop.MODULES)
    # the codec's serving modules read a training checkpoint by key name
    serving = {k: v for k, v in build_train_from_fields(FIELDS).items()
               if k in ("encoder", "quantizer", "decoder")}
    load_torch_checkpoint(serving, path)
    for k, m in serving.items():
        for name, p in m.state_dict().items():
            torch.testing.assert_close(p, ckpt["net"][k][name], rtol=0, atol=0)

    # 8 utterances in batches of 2: an epoch is 4 steps, and its end saves
    # once more (as epoch 1); of the 8 files written the newest 5 stay
    many = train(tmp_path / "rot", 7, save_interval=1)
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "rot" / "*.pth")))
    assert many.step == 7
    assert names == ["FAcodec_epoch_00000_step_00004.pth"] + [
        f"FAcodec_epoch_00001_step_{s:05d}.pth" for s in range(4, 8)]


def test_loop_is_deterministic(tmp_path):
    a = params_of(train(tmp_path / "a", 2))
    b = params_of(train(tmp_path / "b", 2))
    start = params_of(loop.TrainState(loop.build_models(FIELDS, 0, "cpu"), {}, 0, 0))
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for module in loop.MODULES:
        assert any(not torch.equal(a[k], start[k]) for k in a if k.startswith(module + "."))


def test_train_command_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(loop, "_default_writer", lambda log_dir: None)
    state = cli_main(["train", "--config-path", os.path.join(ROOT, "tests", "tiny_config.yml"),
                      "--device", "cpu", "--max-steps", "1", "--log-dir", str(tmp_path)])
    assert state.step == 1
    assert "trained to step 1" in capsys.readouterr().out
