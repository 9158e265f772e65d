"""The port's voice-conversion modules against the JAX package, on the CPU.

JAX builds the redecoder stage (Redecoder + DAC Decoder) from
tests/tiny_config.yml with `build_model` + `init_params`; its parameters
move into the port by key name with `load_jax_params`, and both run the
same numpy codes and timbre. The causal and non-causal variants share one
parameter tree: `decoder_causal` changes padding, not parameters. Tensors
must agree within the JAX package's golden tolerance
(tests/test_model_parity.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.models.builder import build_model, init_params
from facodec_tpu.models.dac import Decoder as JDecoder
from facodec_tpu.models.dac import ResidualUnit as JResidualUnit
from facodec_tpu.models.wavenet import WN as JWN
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch.models.builder import build_redecoder, build_redecoder_from_fields
from facodec_tpu_torch.models.dac import Decoder, ResidualUnit
from facodec_tpu_torch.models.wavenet import WN
from facodec_tpu_torch.utils.weights import flatten_tree, load_jax_params, torch_key_to_path

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
NAMES = ("encoder", "decoder")


def _inputs(B: int, T: int, n_codes: int, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    cp = rng.integers(0, n_codes, (B, 1, T)).astype(np.int32)
    cc = rng.integers(0, n_codes, (B, 2, T)).astype(np.int32)
    timbre = rng.standard_normal((B, d)).astype(np.float32)
    return cp, cc, timbre


def _jax_vc(red, dec):
    """Jitted redecoder (use_p_code and n_c static) -> jitted decoder, so
    that the variants share the decoder's compile."""
    red_fn = jax.jit(lambda p, cp, cc, t, use_p_code, n_c: red.apply(
        {"params": p}, cp, cc, t, use_p_code=use_p_code, n_c=n_c), static_argnums=(4, 5))
    dec_fn = jax.jit(lambda p, z: dec.apply({"params": p}, z))

    def vc(params, cp, cc, timbre, use_p_code, n_c):
        z = red_fn(params["encoder"], cp, cc, timbre, use_p_code, n_c)
        return z, dec_fn(params["decoder"], z)[:, :, 0]

    vc.decoder = dec_fn
    return vc


def _port_vc(models, cp, cc, timbre, use_p_code, n_c):
    with torch.no_grad():
        z = models["encoder"](torch.from_numpy(cp), torch.from_numpy(cc),
                              torch.from_numpy(timbre), use_p_code=use_p_code, n_c=n_c)
        return z.numpy(), models["decoder"](z)[:, :, 0].numpy()


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once: eight spinning threads each thrash
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(TINY)
    jmodels = build_model(cfg.model_params, "redecoder")
    jmodels = {k: jmodels[k] for k in NAMES}
    params = init_params(jmodels, jax.random.PRNGKey(0))
    out = dict(params=params, cfg=cfg)
    for causal in (True, False):
        cfg.model_params.decoder_causal = causal
        port = build_redecoder(cfg.model_params)
        for k in NAMES:
            load_jax_params(port[k], params[k])
        jm = build_model(cfg.model_params, "redecoder")
        red, dec = jm["encoder"], jm["decoder"]
        assert red.causal is causal and dec.causal is causal
        out[causal] = dict(port=port, jax_vc=_jax_vc(red, dec))
    cfg.model_params.decoder_causal = True
    return out


@pytest.mark.parametrize("n_c", [1, 2])
@pytest.mark.parametrize("use_p_code", [False, True])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_redecoder_matches_jax(tiny, causal, use_p_code, n_c):
    """Latent and VC wave, from the same codes and timbre."""
    cp, cc, timbre = _inputs(2, 40, 32, 64)
    jz, jw = tiny[causal]["jax_vc"](tiny["params"], cp, cc, timbre, use_p_code, n_c)
    z, w = _port_vc(tiny[causal]["port"], cp, cc, timbre, use_p_code, n_c)
    assert z.shape == (2, 40, 64) and w.shape == (2, 40 * 300)
    assert np.isfinite(w).all()
    np.testing.assert_allclose(z, np.asarray(jz), **TOL)
    np.testing.assert_allclose(w, np.asarray(jw), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_redecoder_key_bijection(tiny, name):
    """Every JAX parameter path of the redecoder stage is reached by exactly
    one port key (`prosody_embed.0.weight` -> prosody_embed_0/weight)."""
    keys = list(tiny[True]["port"][name].state_dict())
    paths = [torch_key_to_path(k) for k in keys]
    assert len(set(paths)) == len(paths)
    assert set(paths) == set(flatten_tree(tiny["params"][name]))
    if name == "encoder":
        assert ("prosody_embed_0", "weight") in paths and ("content_embed_1", "weight") in paths
        assert ("encoder", "cond_layer", "weight_g") in paths


@pytest.mark.parametrize("with_g", [True, False], ids=["g", "no_g"])
def test_wn_matches_jax(with_g):
    """WN with global conditioning, and without it (the prosody encoder's),
    which must gain no `cond_layer` key."""
    H, gin, L, B, T = 16, 12, 4, 2, 50
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    g = rng.standard_normal((B, 1, gin)).astype(np.float32) if with_g else None
    jwn = JWN(hidden_channels=H, kernel_size=5, dilation_rate=1, n_layers=L,
              gin_channels=gin if with_g else 0, causal=True)
    params = jwn.init(jax.random.PRNGKey(1), jnp.asarray(x), None,
                      None if g is None else jnp.asarray(g))["params"]
    want = np.asarray(jwn.apply({"params": params}, jnp.asarray(x), None,
                                None if g is None else jnp.asarray(g)))
    wn = WN(H, 5, 1, L, gin_channels=gin if with_g else 0, causal=True)
    load_jax_params(wn, params)
    assert any(k.startswith("cond_layer.") for k in wn.state_dict()) is with_g
    with torch.no_grad():
        got = wn(torch.from_numpy(x), None if g is None else torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("frames", [3, 4, 40])
def test_noncausal_decoder_matches_jax(tiny, frames):
    """The tiny Decoder with causal=False alone. At 3 and 4 latent frames its
    first block's units see 18 and 24 rows, fewer than the 27-row pads of
    d = 9: pad1d's zero-extend path."""
    z = np.random.default_rng(frames).standard_normal((2, frames, 64)).astype(np.float32)
    want = np.asarray(tiny[False]["jax_vc"].decoder(tiny["params"]["decoder"], z))
    dec = tiny[False]["port"]["decoder"]
    assert isinstance(dec, Decoder) and not dec.model[0].causal
    with torch.no_grad():
        got = dec(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, frames * 300, 1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("T", [20, 27, 28])
def test_noncausal_residual_unit_short_inputs(T):
    """d = 9, non-causal: 27 rows of reflect pad on each side, so T <= 27
    zero-extends before the reflect, in JAX and in the port alike."""
    C = 32
    x = (0.5 * np.random.default_rng(T).standard_normal((2, T, C))).astype(np.float32)
    junit = JResidualUnit(C, dilation=9, causal=False)
    params = junit.init(jax.random.PRNGKey(T), jnp.asarray(x))["params"]
    want = np.asarray(junit.apply({"params": params}, jnp.asarray(x)))
    unit = ResidualUnit(C, dilation=9, causal=False)
    load_jax_params(unit, params)
    with torch.no_grad():
        got = unit(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.slow
def test_flagship_redecoder_parity():
    """FLAGSHIP_REDECODER (embed 512, WN 16, decoder 1536, non-causal, LSTM 2)
    against the JAX modules built from the same fields, 0.5 s of codes."""
    from facodec_tpu.models.redecoder import Redecoder as JRedecoder
    from facodec_tpu_torch.config import FLAGSHIP_REDECODER

    f = FLAGSHIP_REDECODER
    jmodels = dict(encoder=JRedecoder(p_dropout=0.2, **f["encoder"]),
                   decoder=JDecoder(**f["decoder"]))
    params = init_params(jmodels, jax.random.PRNGKey(0))
    port = build_redecoder_from_fields(f)
    for k in NAMES:
        load_jax_params(port[k], params[k])
    cp, cc, timbre = _inputs(1, 40, 1024, 1024, seed=5)
    jz, jw = _jax_vc(jmodels["encoder"], jmodels["decoder"])(params, cp, cc, timbre, False, 1)
    z, w = _port_vc(port, cp, cc, timbre, False, 1)
    np.testing.assert_allclose(z, np.asarray(jz), **TOL)
    np.testing.assert_allclose(w, np.asarray(jw), **TOL)
