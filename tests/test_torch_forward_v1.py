"""The legacy 4-stream quantizer and predictor heads against the JAX package's.

`FAquantizer` with `timbre_norm=False` (prosody, content, timbre and
residual RVQs) at a tiny width, with and without the separate prosody
encoder, and `FApredictors` with `timbre_norm=False` (a global-pooled
`CNNLSTM` speaker head), both with `norm_f0` True and False. The JAX
modules' own `init` makes each parameter tree, and `load_jax_params` moves
it into the port's module by key name (raising on any key missing or left
over). Held to the golden tolerance (rtol = atol = 2e-4; codes bit-exact):
`forward_v1` in eval and in train mode with every draw out of play (the
quantizer dropout and the residual mask at 0, flax's Dropout the identity
inside this module's JAX calls, the port's rates 0), with the noise flags;
`encode` and `decode`; the predictors' outputs and the gradients of a
weighted sum of them. The timbre RVQ's searches run through the VQ op, as
every search does: a `forward_v1` at n_c = 2 makes 1 + 2 + 2 + 3 of them.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from facodec_tpu.models.fa_quantizer import FApredictors as JFApredictors
from facodec_tpu.models.fa_quantizer import FAquantizer as JFAquantizer
from facodec_tpu_torch.models.builder import build_train_from_fields
from facodec_tpu_torch.models.fa_quantizer import FApredictors, FAquantizer
from facodec_tpu_torch.ops.kernels import vq
from facodec_tpu_torch.utils.weights import flatten_tree, load_jax_params, torch_key_to_path

TOL = dict(rtol=2e-4, atol=2e-4)
B, FRAMES, HOP, D = 2, 6, 300, 64


def q_fields(separate: bool) -> dict:
    return dict(in_dim=D, n_p_codebooks=1, n_c_codebooks=2, n_t_codebooks=2, n_r_codebooks=3,
                codebook_size=32, codebook_dim=4, quantizer_dropout=0.0, causal=True,
                separate_prosody_encoder=separate, timbre_norm=False, style_hidden_dim=32,
                prosody_hidden_dim=16, prob_random_mask_residual=0.0)


def p_fields(norm_f0: bool) -> dict:
    return dict(in_dim=D, use_gr_content_f0=True, use_gr_prosody_phone=True,
                use_gr_residual_f0=True, use_gr_residual_phone=True, use_gr_timbre_content=True,
                use_gr_timbre_prosody=True, use_gr_x_timbre=True, norm_f0=norm_f0,
                timbre_norm=False, use_gr_content_global_f0=True, n_phone_classes=12,
                n_speakers=8)


def no_dropout(module: torch.nn.Module) -> torch.nn.Module:
    for m in module.modules():
        for attr in ("p_dropout", "dropout"):
            if isinstance(getattr(m, attr, None), float):
                setattr(m, attr, 0.0)
    return module


def inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, FRAMES, D)).astype(np.float32)
    wave = (rng.standard_normal((B, FRAMES * HOP)) * 0.3).astype(np.float32)
    return z, wave


@pytest.fixture(scope="module", params=[True, False], ids=["separate", "shared"])
def quantizer(request):
    """(JAX module, its parameters, the port's module with them)."""
    jq = JFAquantizer(**q_fields(request.param))
    z, wave = inputs()
    params = jax.jit(lambda r, z, w: jq.init(r, z, w, n_c=2))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, z, wave)["params"]
    port = FAquantizer(**q_fields(request.param))
    load_jax_params(port, params)
    return jq, params, no_dropout(port)


def _jax_v1(jq, params, z, wave, train, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        return jax.jit(lambda p, z, w: jq.apply(
            {"params": p}, z, w, n_c=2, train=train, rngs={"dropout": jax.random.PRNGKey(2)},
            **kwargs))(params, z, wave)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_v1_matches_jax(quantizer, train):
    """outs, the four streams, commitment and codebook losses."""
    jq, params, port = quantizer
    z, wave = inputs(1)
    want = _jax_v1(jq, params, z, wave, train)
    port.train(train)
    got = port(torch.from_numpy(z), torch.from_numpy(wave), n_c=2, train=train,
               generator=torch.Generator().manual_seed(0))
    _close(got[0], want[0], "outs")
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        _close(a, b, f"quantized[{i}]")
    _close(got[2], want[2], "commitment")
    _close(got[3], want[3], "codebook")


def test_forward_v1_noise_flags(quantizer):
    """A noisy row keeps its residual stream where its reconstruction flag
    is set and drops it where not; a clean row keeps the mask's draw."""
    jq, params, port = quantizer
    z, wave = inputs(2)
    noisy, recon = np.array([True, True]), np.array([False, True])
    want = _jax_v1(jq, params, z, wave, True, noise_added_flags=noisy, recon_noisy_flags=recon)
    got = port.forward_v1(torch.from_numpy(z), torch.from_numpy(wave), torch.from_numpy(noisy),
                          torch.from_numpy(recon), n_c=2, train=True,
                          generator=torch.Generator().manual_seed(0))
    _close(got[0], want[0], "outs")
    z_p, z_c, z_t, _ = got[1]
    _close(got[0][0], (z_p + z_c + z_t)[0].detach(), "row 0 without its residual")


def test_encode_decode_match_jax(quantizer):
    """`encode` codes bit-exact and streams at the golden tolerance; the
    stacked [c, p, t0, t1] codes through `decode`."""
    jq, params, port = quantizer
    z, wave = inputs(3)
    codes_j, zs_j = jax.jit(lambda p, z, w: jq.apply({"params": p}, z, w, n_c=2,
                                                     method=JFAquantizer.encode))(params, z, wave)
    with torch.no_grad():
        codes, zs = port.encode(torch.from_numpy(z), torch.from_numpy(wave), n_c=2)
    assert [tuple(c.shape) for c in codes] == [(B, 2, FRAMES), (B, 1, FRAMES), (B, 2, FRAMES),
                                               (B, 3, FRAMES)]
    for a, b in zip(codes, codes_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i, (a, b) in enumerate(zip(zs, zs_j)):
        _close(a, b, f"z[{i}]")
    stacked = np.concatenate([np.asarray(codes_j[0])[:, :1], np.asarray(codes_j[1]),
                              np.asarray(codes_j[2])], axis=1)
    sum_j, parts_j = jax.jit(lambda p, c: jq.apply({"params": p}, c, method=JFAquantizer.decode))(
        params, stacked)
    with torch.no_grad():
        total, parts = port.decode(torch.from_numpy(stacked))
    _close(total, sum_j, "decode")
    for i, (a, b) in enumerate(zip(parts, parts_j)):
        _close(a, b, f"decode part {i}")


def test_forward_v1_search_count(quantizer):
    """1 + 2 + 2 + 3 code searches at n_c = 2, each through the VQ wrapper
    (its kernel on the card; here its plain version)."""
    _, _, port = quantizer
    z, wave = inputs(4)
    calls = []
    real = vq.nearest_code

    def counted(*args):
        calls.append(1)
        return real(*args)

    import facodec_tpu_torch.models.quantize as mq
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mq, "nearest_code", counted)
        port.eval()
        with torch.no_grad():
            port(torch.from_numpy(z), torch.from_numpy(wave), n_c=2)
    assert len(calls) == 8


def test_v2_only_methods_refuse():
    port = FAquantizer(**q_fields(False))
    z, wave = inputs()
    with pytest.raises(ValueError, match="timbre_norm=False"):
        port.forward_v2(torch.from_numpy(z), torch.from_numpy(wave))


@pytest.mark.parametrize("norm_f0", [True, False])
def test_predictors_v1_match_jax(norm_f0):
    """`FApredictors.forward_v1`: every head's output, and the gradients of
    a weighted sum of them for the streams and every parameter."""
    fa = JFApredictors(**p_fields(norm_f0))
    rng = np.random.default_rng(5)
    q = [rng.standard_normal((B, FRAMES, D)).astype(np.float32) for _ in range(4)]
    params = jax.jit(lambda r, q: fa.init(r, q))(jax.random.PRNGKey(3), q)["params"]
    port = FApredictors(**p_fields(norm_f0))
    load_jax_params(port, params)
    keys = ("f0", "uv", "content", "timbre", "rev_f0", "rev_uv", "rev_content", "x_timbre")

    def flat(preds, rev):
        return [dict(preds, **rev)[k] for k in keys]

    shapes = flat(*jax.eval_shape(lambda p, q: fa.apply({"params": p}, q), params, q))
    probe = [rng.standard_normal(o.shape).astype(np.float32) for o in shapes]

    def jfn(p, q):
        outs = flat(*fa.apply({"params": p}, q))
        return sum(jnp.sum(o * c) for o, c in zip(outs, probe)), outs

    (_, jouts), (jgp, jgq) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        params, q)
    qt = [torch.from_numpy(a).requires_grad_(True) for a in q]
    outs = flat(*port(qt))
    for k, got, want in zip(keys, outs, jouts):
        _close(got, want, k)
    sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, probe)).backward()

    def grad_close(got, want, name):
        bound = 1e-3 * np.abs(want).max() + 1e-7
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"

    for i, (got, want) in enumerate(zip(qt, jgq)):
        grad_close(got.grad, np.asarray(want), f"quantized[{i}]")
    want = {name: np.asarray(v) for name, v in
            ((n, flatten_tree(jgp)[torch_key_to_path(n)]) for n, _ in port.named_parameters())}
    for name, p in port.named_parameters():
        grad_close(p.grad, want[name], name)


def test_v1_models_build_from_fields():
    """The training builder makes both 4-stream modules from fields."""
    fields = dict(quantizer=q_fields(True), fa_predictors=p_fields(True),
                  encoder=dict(d_model=8, strides=(15, 20), d_latent=D, causal=True, lstm=1),
                  decoder=dict(input_channel=D, channels=16, rates=(20, 15), causal=True, lstm=1),
                  discriminator=dict(rates=(), periods=(2,), fft_sizes=(512,),
                                     sample_rate=24000))
    models = build_train_from_fields(fields)
    assert hasattr(models["quantizer"], "timbre_quantizer")
    assert not hasattr(models["quantizer"], "timbre_encoder")
    assert isinstance(models["fa_predictors"].timbre_predictor, torch.nn.Module)
