"""The port's precision policy against the JAX package's, on the CPU.

Under `bfloat16_act` both packages round conv and matmul operands to bf16,
sum in float32 and return bf16 layer outputs; snake computes in float32 and
rounds its result. Single ops (snake, `conv1d_ntc`, the residual unit's
plain version, which the kernel's bf16 entry is held to on the card) must
agree within 2 bf16 ulps: the two frameworks sum the float32 products in
another order, so a sum near a rounding boundary can round either way. The
ulp is that of the largest term of the op's last sums (for the unit,
`resunit.bf16_error_scale`), where such a step enters. These JAX references
are compiled with `xla_allow_excess_precision` off: with it on (XLA's
default) a jitted fusion keeps float32 between ops and skips some of the
roundings the JAX code writes; op by op, JAX gives the same bits as the
compiled reference. The decoder compounds the steps: one flipped rounding
moves every later layer's inputs, so two faithful bf16 decoders differ at
their worst sample by a few output ulps. JAX's two compilations of its own
hybrid decode differ by 2.7-2.8e-2 of the wave's peak at the worst sample
(0.7% in RMS); the port differs from either by as much, with the same
percentiles. So the decoder is held to JAX's hybrid API in RMS, err / scale
<= 2e-2, to the JAX package's own 8e-2 at the worst sample (its hybrid
against float32 limit, tests/test_precision.py), and the port's hybrid to
its float32 decode by that 8e-2. `hybrid` encodes in float32, so its codes
are bit-exact to float32's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.api import FACodec as JFACodec
from facodec_tpu.models.builder import build_model, init_params
from facodec_tpu.models.dac import ResidualUnit as JResidualUnit
from facodec_tpu.nn.activations import snake as jsnake
from facodec_tpu.nn.conv import conv1d_ntc as jconv1d_ntc
from facodec_tpu.nn.lstm import SLSTM as JSLSTM
from facodec_tpu.ops import precision as jprecision
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.models.builder import build_codec
from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.nn.activations import snake
from facodec_tpu_torch.nn.conv import conv1d_ntc
from facodec_tpu_torch.nn.lstm import SLSTM
from facodec_tpu_torch.ops import precision
from facodec_tpu_torch.ops.kernels import resunit
from facodec_tpu_torch.utils.signals import sweep_wave
from facodec_tpu_torch.utils.weights import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
CODEC = ("encoder", "quantizer", "decoder")
MAX_ULPS = 2
DECODER_VS_JAX = 2e-2
DECODER_VS_F32 = 8e-2  # tests/test_precision.py:93
TIMBRE_TOL = 2e-4  # the JAX package's golden tolerance


def bf16_np(a: np.ndarray) -> np.ndarray:
    """float32 numpy holding a's values rounded to bf16."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """Spacing of bf16 numbers at |a| (8 significand bits)."""
    a = np.maximum(np.abs(np.asarray(a, np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_ulps(got, want, scale, what: str) -> None:
    """No element more than MAX_ULPS bf16 ulps (at `scale`) off; prints the
    share of elements that are bit-equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    ulps = np.abs(got.astype(np.float64) - want) / bf16_ulp(scale)
    equal = float(np.mean(got == want))
    print(f"{what}: {equal:.4%} bit-equal, worst {ulps.max():.2f} ulps")
    assert ulps.max() <= MAX_ULPS, (what, ulps.max())


def j_rounding_jit(fn, *args):
    """fn(*args) jitted with every rounding the JAX code writes kept (the
    module docstring)."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


def j_bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def j_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def t_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# ------------------------------------------------------------- the policy
def test_policy_scoping_and_aliases():
    assert precision.get_policy() == "float32"
    with precision.policy("bf16_act"):
        assert precision.get_policy() == "bfloat16_act"
        assert precision.compute_dtype() == precision.out_dtype() == torch.bfloat16
        with precision.policy(None):
            assert precision.get_policy() == "bfloat16_act"
        with precision.policy("hybrid"):
            assert precision.compute_dtype() == torch.float32
    assert precision.get_policy() == "float32"
    with pytest.raises(RuntimeError):
        with precision.policy("bfloat16_act"):
            raise RuntimeError("boom")
    assert precision.get_policy() == "float32"
    with pytest.raises(ValueError):
        precision.check("fp16")
    x, i = torch.ones(2, 3), torch.ones(2, dtype=torch.int32)
    with precision.policy("bfloat16_act"):
        a, b = precision.cast_operands(x, i)
        assert a.dtype == torch.bfloat16 and b.dtype == torch.int32
    assert precision.cast_operands(x).dtype == torch.float32


@pytest.mark.parametrize("name", ["bfloat16", "bf16", "int8", "hybrid_int8"])
def test_unported_policies_raise(name):
    """The policies once refused now run: each name resolves, and the tiny
    codec round-trips a short wave under it with JAX's encode / decode split."""
    canon = precision.check(name)
    assert canon == {"bf16": "bfloat16"}.get(name, name)
    codec = FACodec.from_config(TINY, device="cpu", precision=name)
    assert codec.precision == canon
    assert (codec.enc_policy, codec.dec_policy) == {
        "bfloat16": ("bfloat16", "bfloat16"), "int8": ("int8", "int8"),
        "hybrid_int8": ("float32", "int8")}[canon]
    y = codec.reconstruct(sweep_wave(1, 0.2, seed=1))
    assert y.dtype == np.float32 and y.shape == (1, 4800) and np.isfinite(y).all()


# ------------------------------------------------------------ single ops
def test_snake_matches_jax():
    rng = np.random.default_rng(0)
    x = bf16_np(3.0 * rng.standard_normal((2, 300, 64)))
    alpha = (0.5 + rng.random((1, 1, 64))).astype(np.float32)
    want = jsnake(j_bf16(x), jnp.asarray(alpha))
    assert want.dtype == jnp.bfloat16
    got = snake(t_bf16(x), torch.from_numpy(alpha))
    assert got.dtype == torch.bfloat16
    assert_ulps(got.float().numpy(), j_np(want), j_np(want), "snake")


@pytest.mark.parametrize("k,d", [(7, 1), (7, 3), (7, 9), (1, 1)])
def test_conv1d_ntc_matches_jax(k, d):
    rng = np.random.default_rng(k + d)
    C, T = 48, 200
    x = bf16_np(rng.standard_normal((2, T, C)))
    w = (rng.standard_normal((C, C, k)) / np.sqrt(C * k)).astype(np.float32)
    b = (0.3 * rng.standard_normal(C)).astype(np.float32)
    with jprecision.policy("bfloat16_act"):
        want = j_rounding_jit(lambda v, w_, b_: jconv1d_ntc(v, w_, b_, dilation=d),
                              j_bf16(x), jnp.asarray(w), jnp.asarray(b))
    assert want.dtype == jnp.bfloat16
    with precision.policy("bfloat16_act"):
        got = conv1d_ntc(t_bf16(x), torch.from_numpy(w), torch.from_numpy(b), dilation=d)
        exact = conv1d_ntc(t_bf16(x), torch.from_numpy(w), None, dilation=d, exact=True)
    assert got.dtype == torch.bfloat16 and exact.dtype == torch.float32
    want = j_np(want)
    # the magnitudes of the sum's terms, |W| . |x|, and of the bias
    terms = conv1d_ntc(torch.from_numpy(np.abs(x)), torch.from_numpy(np.abs(bf16_np(w))), None,
                       dilation=d).numpy()
    assert_ulps(got.float().numpy(), want,
                np.maximum.reduce([np.abs(want), terms, np.broadcast_to(np.abs(b), terms.shape)]),
                f"conv1d_ntc k={k} d={d}")
    # exact=True is the float32 conv whatever the policy
    np.testing.assert_array_equal(
        exact.numpy(), conv1d_ntc(t_bf16(x).float(), torch.from_numpy(w), None,
                                  dilation=d).numpy())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_bf16_residual_unit_matches_jax(dilation, causal):
    """The plain version the bf16 entry is held to on the card, against the
    JAX package's unit under bfloat16_act (its default, unfused path)."""
    C, T = 64, 1200
    x = bf16_np(0.5 * np.random.default_rng(dilation).standard_normal((2, T, C)))
    junit = JResidualUnit(C, dilation=dilation, causal=causal)
    params = junit.init(jax.random.PRNGKey(dilation), jnp.zeros((1, T, C)))["params"]
    with jprecision.policy("bfloat16_act"):
        want = j_rounding_jit(lambda p, v: junit.apply({"params": p}, v), params, j_bf16(x))
    assert want.dtype == jnp.bfloat16

    unit = ResidualUnit(C, dilation=dilation, causal=causal)
    load_jax_params(unit, params)
    before = (resunit.fused_residual_unit.launches, resunit.fused_residual_unit.bf16_launches)
    with torch.no_grad(), precision.policy("bfloat16_act"):
        got = unit(t_bf16(x))
    assert got.dtype == torch.bfloat16
    # on the CPU the wrapper runs the plain version and launches nothing
    assert (resunit.fused_residual_unit.launches,
            resunit.fused_residual_unit.bf16_launches) == before
    snake1, conv7, snake2, conv1 = unit.block
    with torch.no_grad():
        scale = resunit.bf16_error_scale(t_bf16(x), conv7.effective_weight(), conv7.bias,
                                         conv1.effective_weight(), conv1.bias, snake1.alpha,
                                         snake2.alpha, dilation, causal)
    assert_ulps(got.float().numpy(), j_np(want), scale.numpy(),
                f"residual unit d={dilation} {'causal' if causal else 'non-causal'}")


def test_slstm_gap_to_jax():
    """The port's route under bfloat16_act (a float32 LSTM on bf16-rounded
    input and weights) against JAX's, which also rounds h to bf16 at every
    step: the gap is reported, and held to the decoder's limit."""
    rng = np.random.default_rng(3)
    C, T = 32, 80
    x = bf16_np(rng.standard_normal((2, T, C)))
    jm = JSLSTM(C, 1)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, T, C)))["params"]
    with jprecision.policy("bfloat16_act"):
        want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, j_bf16(x))
    m = SLSTM(C, 1)
    load_jax_params(m, params)
    with torch.no_grad(), precision.policy("bfloat16_act"):
        got = m(t_bf16(x))
        again = m(t_bf16(x))
    with torch.no_grad():
        f32 = m(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want = np.asarray(want)
    gap = np.abs(got.numpy() - want).max() / np.abs(want).max()
    gap32 = np.abs(f32.numpy() - want).max() / np.abs(want).max()
    print(f"SLSTM under bfloat16_act, port vs JAX: err/scale {gap:.3e} "
          f"(the float32 LSTM vs JAX's bf16 one: {gap32:.3e})")
    assert gap <= DECODER_VS_JAX
    np.testing.assert_array_equal(got.numpy(), again.numpy())  # the cached copy


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once: eight spinning threads each thrash
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ whole codec
@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(TINY)
    jm = build_model(cfg.model_params, "codec")
    jm = {k: jm[k] for k in CODEC}
    params = init_params(jm, jax.random.PRNGKey(0), seg_frames=4)
    port = build_codec(cfg.model_params)
    for k in CODEC:
        load_jax_params(port[k], params[k])
    mods = [port[k] for k in CODEC]
    return dict(jm=jm, params=params, f32=FACodec(*mods), hybrid=FACodec(*mods, precision="hybrid"),
                jf32=JFACodec(models=jm, params=params, n_c=2),
                jhy=JFACodec(models=jm, params=params, n_c=2, precision="hybrid"),
                wave=sweep_wave(2, 0.5, seed=7))


def test_hybrid_codes_bit_exact(tiny):
    f32, fhy = tiny["f32"].encode(tiny["wave"]), tiny["hybrid"].encode(tiny["wave"])
    jhy = tiny["jhy"].encode(tiny["wave"])
    for name in ("codes_p", "codes_c", "codes_r"):
        np.testing.assert_array_equal(getattr(fhy, name), getattr(f32, name))
        np.testing.assert_array_equal(getattr(fhy, name), getattr(jhy, name))
    np.testing.assert_array_equal(fhy.timbre, f32.timbre)
    np.testing.assert_allclose(fhy.timbre, jhy.timbre, rtol=TIMBRE_TOL, atol=TIMBRE_TOL)


def test_bf16_act_decoder_matches_jax(tiny):
    """The decode of the same codes: the port's hybrid against JAX's hybrid,
    and against the port's float32 decode (the module docstring)."""
    f = tiny["jf32"].encode(tiny["wave"])
    want = tiny["jhy"].decode(f)
    got = tiny["hybrid"].decode(f)
    y32 = tiny["f32"].decode(f)
    assert got.dtype == want.dtype == np.float32
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    err32 = np.abs(got - y32).max() / np.abs(y32).max()
    print(f"hybrid decode: port vs JAX err/scale {err:.3e} at the worst sample, {rms:.3e} in "
          f"RMS; port hybrid vs port float32 {err32:.3e}")
    assert rms <= DECODER_VS_JAX
    assert err < DECODER_VS_F32
    assert err32 < DECODER_VS_F32


def test_decoder_module_under_bf16_act(tiny):
    """The decoder module alone under the policy returns a bf16 wave, as the
    JAX package's does."""
    outs = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 64))
                            .astype(np.float32))
    dec = tiny["f32"].decoder
    with torch.no_grad(), precision.policy("bfloat16_act"):
        y = dec(outs)
    with jprecision.policy("bfloat16_act"):
        jy = tiny["jm"]["decoder"].apply({"params": tiny["params"]["decoder"]},
                                         jnp.asarray(outs.numpy()))
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    got, want = y.float().numpy(), j_np(jy)
    assert np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)) <= DECODER_VS_JAX
    assert np.abs(got - want).max() / np.abs(want).max() < DECODER_VS_F32
