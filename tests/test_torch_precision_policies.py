"""The `bfloat16`, `int8` and `hybrid_int8` policies of the port against the
JAX package's, on the CPU at the tiny config's widths.

Under `int8` a conv whose fan-in reaches INT8_MIN_FANIN sums exact int8
products, so the port's W8A8 convs (conv, pointwise, transposed, strided)
are held bit-equal to the JAX package's, with both thresholds set alike.
The reference is JAX op by op (its written arithmetic: `sum * (sx * sw)`,
then `+ bias`, two roundings): a jitted XLA program contracts that multiply
and add into one fused multiply-add, which lands within 1 float32 ulp of
it. The int8 residual unit's plain version (the card's int8 kernel is held
to it) has its quantized input, its scale and its conv7 output bit-equal to
JAX's, and its output within 1 bf16 ulp of JAX's unit: its 1x1 sums bf16
products in float32 in another order, and a sum near a bf16 rounding
boundary can round either way (the ulp at the magnitude of the 1x1's
largest term, `resunit.bf16_error_scale`).

Under `bfloat16` a conv rounds its product to bf16 and adds a float32 bias:
single convs within 1 bf16 ulp of JAX's, compiled with
`xla_allow_excess_precision` off (tests/test_torch_precision.py says why);
units within MAX_ULPS (2), since a rounding flipped in the conv7 moves s2
and reaches the 1x1.

Round trips: codes equal to JAX's under the same policy (JAX's encode and
decode compiled with every rounding kept); `hybrid_int8`'s codes and timbre
equal to the port's float32 ones (its encode is float32, and the port's
float32 codes are JAX's: tests/test_torch_codec.py), its decode held to
JAX's `int8` decode of those codes (JAX's `hybrid_int8` decode); waves within
DECODER_VS_JAX in RMS and DECODER_VS_F32 at the worst sample of JAX's (two
faithful bf16 decodes, tests/test_torch_precision.py). The thresholds are
set to FANIN so that the tiny decoder quantizes what the flagship's does:
its first conv, its first two transposed convs and block 0's conv7s, not
the 1x1s and not block 1's units.
"""

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
from facodec_tpu.nn.conv import apply_weight_norm
from facodec_tpu.nn.conv import conv_transpose1d_ntc as jconv_transpose1d_ntc
from facodec_tpu.ops import padding as jpadding
from facodec_tpu.ops import precision as jprecision
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.models.builder import build_codec
from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.nn.conv import conv1d_ntc, conv_transpose1d_ntc
from facodec_tpu_torch.ops import precision
from facodec_tpu_torch.ops.kernels import resunit
from facodec_tpu_torch.utils.signals import sweep_wave
from facodec_tpu_torch.utils.weights import load_jax_params

from test_torch_precision import (CODEC, DECODER_VS_F32, DECODER_VS_JAX, MAX_ULPS, TINY,
                                  TIMBRE_TOL, bf16_ulp, j_rounding_jit)

FANIN = 112  # the tiny decoder's block-0 conv7 (7 x 16) and above quantize
F32_ULPS = 1  # JAX jitted against JAX op by op: one fused multiply-add
CONV_ULPS = 1  # a bf16 conv against JAX's: one rounding of one sum
UNIT_ULPS = 1  # the int8 unit's output: the 1x1's one rounding


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once
    yield
    torch.set_num_threads(n)


def set_threshold(monkeypatch, fanin: int) -> None:
    monkeypatch.setattr(precision, "INT8_MIN_FANIN", fanin)
    monkeypatch.setattr(jprecision, "INT8_MIN_FANIN", fanin)


def f32_ulps(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float32)
    return float((np.abs(got - want) / np.spacing(np.abs(want))).max())


def bf16_ulps(got, want, scale) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / bf16_ulp(scale)).max())


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------- the policy
def test_policy_names_and_dtypes():
    for name, canon in (("bf16", "bfloat16"), ("BFLOAT16", "bfloat16"), ("w8a8", "int8"),
                        ("int8", "int8"), ("hybrid_int8", "hybrid_int8")):
        assert precision.check(name) == canon
    dtypes = {"float32": (torch.float32, torch.float32), "bfloat16": (torch.bfloat16, torch.float32),
              "bfloat16_act": (torch.bfloat16, torch.bfloat16),
              "int8": (torch.bfloat16, torch.bfloat16), "hybrid_int8": (torch.float32, torch.float32)}
    for name, (compute, out) in dtypes.items():
        with precision.policy(name):
            assert (precision.compute_dtype(), precision.out_dtype()) == (compute, out), name
            assert precision.is_int8(10**9) == (name == "int8")
    assert precision.entry_policies("hybrid_int8") == ("float32", "int8")
    assert precision.entry_policies("w8a8") == ("int8", "int8")
    assert precision.entry_policies("hybrid") == ("float32", "bfloat16_act")
    with pytest.raises(ValueError, match="unknown precision policy"):
        precision.check("int4")


def test_quantize_dynamic_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((3, 40, 24))).astype(np.float32)
    x[1] = 0.0  # an all-zero row quantizes to zeros with a finite scale
    x[2, 5, 7] = 1e-30
    for dims in ((1, 2), (0, 2), (1,)):
        want_q, want_s = jprecision.quantize_dynamic(jnp.asarray(x), dims)
        got_q, got_s = precision.quantize_dynamic(t(x), dims)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ------------------------------------------------------------ single convs
CONVS = {  # kind: (weight shape, keyword arguments)
    "conv7_d3": ((24, 32, 7), dict(dilation=3)),
    "pointwise": ((24, 32, 1), {}),
    "strided": ((40, 32, 12), dict(stride=6)),
    "transposed": ((32, 24, 10), dict(stride=5)),
}


def _conv_inputs(kind: str):
    rng = np.random.default_rng(len(kind))
    shape, kw = CONVS[kind]
    x = (2.0 * rng.standard_normal((2, 60, 32))).astype(np.float32)
    w = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
    b = (0.3 * rng.standard_normal(shape[1] if kind == "transposed" else shape[0])
         ).astype(np.float32)
    return x, w, b, kw


def _both(kind: str):
    if kind == "transposed":
        return (lambda x, w, b, kw: jconv_transpose1d_ntc(x, w, b, **kw),
                lambda x, w, b, kw: conv_transpose1d_ntc(x, w, b, kw["stride"]))
    return (lambda x, w, b, kw: jconv1d_ntc(x, w, b, **kw),
            lambda x, w, b, kw: conv1d_ntc(x, w, b, **kw))


@pytest.mark.parametrize("kind", list(CONVS))
def test_int8_conv_bit_equal_to_jax(kind, monkeypatch):
    set_threshold(monkeypatch, 0)
    x, w, b, kw = _conv_inputs(kind)
    jfn, tfn = _both(kind)
    with jprecision.policy("int8"):
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), kw))
        jitted = np.asarray(j_rounding_jit(lambda x_, w_, b_: jfn(x_, w_, b_, kw), x, w, b))
    with precision.policy("int8"):
        got = tfn(t(x), t(w), t(b), kw)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert f32_ulps(got.numpy(), jitted) <= F32_ULPS
    # below the threshold the conv rounds as under bfloat16_act: bf16 out
    set_threshold(monkeypatch, 10**9)
    with precision.policy("int8"):
        assert tfn(t(x), t(w), t(b), kw).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", list(CONVS))
def test_bfloat16_conv_matches_jax(kind):
    x, w, b, kw = _conv_inputs(kind)
    jfn, tfn = _both(kind)
    with jprecision.policy("bfloat16"):
        want = np.asarray(j_rounding_jit(lambda x_, w_, b_: jfn(x_, w_, b_, kw), x, w, b))
    with precision.policy("bfloat16"):
        got = tfn(t(x), t(w), t(b), kw)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # the sum's rounding point: the terms |W| . |x| and the product's bf16 value
    with precision.policy("float32"):
        terms = tfn(t(np.abs(x)), t(np.abs(w)), None, kw).numpy()
    scale = np.maximum(np.abs(want - b), terms)
    assert bf16_ulps(got.numpy(), want, scale) <= CONV_ULPS


# ------------------------------------------------------------ the units
def _unit(C: int, d: int, seed: int):
    junit = JResidualUnit(C, dilation=d, causal=True)
    params = junit.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, C)))["params"]
    params = jax.tree.map(lambda a: a * (1.0 + 0.3 * jnp.sign(a)), params)  # nonzero biases
    rng = np.random.default_rng(seed)
    params["block_0"]["alpha"] = jnp.asarray(0.5 + rng.random((1, C, 1)), jnp.float32)
    params["block_2"]["alpha"] = jnp.asarray(0.5 + rng.random((1, C, 1)), jnp.float32)
    params["block_1"]["bias"] = jnp.asarray(0.2 * rng.standard_normal(C), jnp.float32)
    params["block_3"]["bias"] = jnp.asarray(0.2 * rng.standard_normal(C), jnp.float32)
    unit = ResidualUnit(C, dilation=d, causal=True)
    load_jax_params(unit, params)
    x = (0.8 * rng.standard_normal((2, 150, C))).astype(np.float32)
    return junit, params, unit.eval(), x


def _jax_weights(params):
    """A JAX unit's effective weights (JAX's weight norm), biases and alphas,
    in the order `resunit`'s functions take them."""
    p0, p1, p2, p3 = (params[f"block_{i}"] for i in range(4))
    w7, w1 = (np.asarray(apply_weight_norm(p["weight_v"], p["weight_g"])) for p in (p1, p3))
    return tuple(t(a) for a in (w7, p1["bias"], w1, p3["bias"], p0["alpha"], p2["alpha"]))


def _weights(unit):
    snake1, conv7, snake2, conv1 = unit.block
    return (conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
            snake1.alpha, snake2.alpha)


@pytest.mark.parametrize("d", [1, 3, 9])
def test_int8_unit_operands_match_jax(d, monkeypatch):
    """A unit whose conv7 quantizes and whose 1x1 does not (the int8 kernel's
    case): q1, sx and c7 bit-equal to JAX's, the output within UNIT_ULPS."""
    C = 32
    set_threshold(monkeypatch, 7 * C)
    junit, params, unit, x = _unit(C, d, d)
    p0, p1 = params["block_0"], params["block_1"]
    ws = _jax_weights(params)  # the same effective weights on both sides
    w7 = ws[0].numpy()
    with jprecision.policy("int8"):
        s1 = jpadding.pad1d(jsnake(jnp.asarray(x), p0["alpha"].reshape(1, 1, C)), (6 * d, 0),
                            mode="reflect")
        want_q, want_sx = jprecision.quantize_dynamic(s1, (1, 2))
        want_c7 = jconv1d_ntc(s1, jnp.asarray(w7), p1["bias"], dilation=d)
        want = j_rounding_jit(lambda p, v: junit.apply({"params": p}, v), params, x)
    with torch.no_grad():
        parts = resunit.int8_unit_parts(t(x), resunit.int8_row_amax_reference(t(x), ws[4]),
                                        resunit.pack_int8(*ws), d, True)
        scale = resunit.bf16_error_scale(t(x), *ws, d, True, "int8")
        # the module under the policy is the plain version on its own weights
        with precision.policy("int8"):
            module = unit(t(x))
        mine = _weights(unit)
        own = resunit.int8_unit_parts(t(x), resunit.int8_row_amax_reference(t(x), mine[4]),
                                      resunit.pack_int8(*mine), d, True)
    np.testing.assert_array_equal(parts["q1"].numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(parts["sx"].numpy(), np.asarray(want_sx))
    np.testing.assert_array_equal(parts["c7"].numpy(), np.asarray(want_c7))
    assert bf16_ulps(parts["out"].numpy(), np.asarray(want), scale.numpy()) <= UNIT_ULPS
    assert own["out"].dtype == module.dtype == torch.float32
    np.testing.assert_array_equal(module.numpy(), own["out"].numpy())


def test_unit_with_every_conv_quantized_matches_jax(monkeypatch):
    """INT8_MIN_FANIN 0 on both sides: the 1x1 quantizes too (no kernel
    form; the plain version on the CPU), bit-equal to JAX op by op on the
    same effective weights."""
    set_threshold(monkeypatch, 0)
    junit, params, unit, x = _unit(16, 3, 5)
    with jprecision.policy("int8"):
        want = np.asarray(junit.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad(), precision.policy("int8"):
        got = resunit.residual_unit_reference(t(x), *_jax_weights(params), 3, True)
        with pytest.raises(ValueError, match="quantizes the 1x1"):
            resunit.unit_route(torch.float32, 16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_unquantized_unit_under_int8_is_the_act_form(monkeypatch):
    """A unit whose conv7 does not quantize, given a float32 x: the bf16
    entry's rounding with float32 in and out (the float32-in/out act form),
    as JAX's unit, which returns float32."""
    C = 32
    set_threshold(monkeypatch, 7 * C + 1)
    junit, params, unit, x = _unit(C, 3, 11)
    with jprecision.policy("int8"):
        want = j_rounding_jit(lambda p, v: junit.apply({"params": p}, v), params, x)
    assert want.dtype == jnp.float32
    with torch.no_grad():
        ws = _weights(unit)
        with precision.policy("int8"):
            assert resunit.unit_route(torch.float32, C) == "f32io_act"
            got = unit(t(x))
        act = resunit.residual_unit_reference(t(x), *ws, 3, True, "bfloat16_act")
        packed = resunit.f32io_reference(t(x), resunit.make_pack("f32io_act", *ws), 3, True,
                                         act=True)
        scale = resunit.bf16_error_scale(t(x), *ws, 3, True, "f32io_act")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), act.numpy())
    assert bf16_ulps(packed.numpy(), act.numpy(), scale.numpy()) <= MAX_ULPS
    assert bf16_ulps(got.numpy(), np.asarray(want), scale.numpy()) <= MAX_ULPS


@pytest.mark.parametrize("d", [1, 3, 9])
def test_bfloat16_unit_matches_jax(d):
    C = 32
    junit, params, unit, x = _unit(C, d, 20 + d)
    with jprecision.policy("bfloat16"):
        want = j_rounding_jit(lambda p, v: junit.apply({"params": p}, v), params, x)
    with torch.no_grad():
        ws = _weights(unit)
        with precision.policy("bfloat16"):
            assert resunit.unit_route(torch.float32, C) == "f32io"
            got = unit(t(x))
        packed = resunit.f32io_reference(t(x), resunit.make_pack("f32io", *ws), d, True,
                                         act=False)
        scale = resunit.bf16_error_scale(t(x), *ws, d, True, "f32io")
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert bf16_ulps(got.numpy(), np.asarray(want), scale.numpy()) <= MAX_ULPS
    assert bf16_ulps(packed.numpy(), got.numpy(), scale.numpy()) <= MAX_ULPS


# ------------------------------------------------------------ round trips
@pytest.fixture(scope="module")
def codecs():
    """The tiny codec in both packages on JAX's weights, at FANIN."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(precision, "INT8_MIN_FANIN", FANIN)
        mp.setattr(jprecision, "INT8_MIN_FANIN", FANIN)
        cfg = load_config(TINY)
        jm = build_model(cfg.model_params, "codec")
        jm = {k: jm[k] for k in CODEC}
        params = init_params(jm, jax.random.PRNGKey(0), seg_frames=4)
        port = build_codec(cfg.model_params)
        for k in CODEC:
            load_jax_params(port[k], params[k])
        wave = sweep_wave(2, 0.5, seed=7)
        w = jnp.asarray(wave[:, : wave.shape[1] // 300 * 300])
        mods = [port[k] for k in CODEC]
        f32 = FACodec(*mods).encode(wave)
        out = {"wave": wave, "f32": f32}
        decoders = {}
        for p in ("bfloat16", "int8", "hybrid_int8"):
            jc = JFACodec(models=jm, params=params, n_c=2, precision=p)
            port_codec = FACodec(*mods, precision=p)
            f = port_codec.encode(wave)
            if p == "hybrid_int8":
                # JAX's hybrid_int8 is its float32 encode (the port's float32
                # codes equal JAX's: tests/test_torch_codec.py) and its int8
                # decode, compiled above for `int8`
                codes = [getattr(f32, n).astype(np.int32) for n in ("codes_p", "codes_c",
                                                                    "codes_r")]
                timbre, dec = f32.timbre, decoders["int8"]
            else:
                # JAX's own closures, compiled with every rounding they write kept
                enc = jc._enc.lower(params, w).compile({"xla_allow_excess_precision": False})
                _, codes, timbre = enc(params, w)
                codes = [np.asarray(c) for c in codes]
                dec = decoders[p] = jc._dec_codes.lower(params, *codes, timbre).compile(
                    {"xla_allow_excess_precision": False})
            out[p] = dict(jcodes=codes, jtimbre=np.asarray(timbre),
                          jwave=np.asarray(dec(params, *codes, timbre)), f=f,
                          wave=port_codec.decode_tensor(*(torch.from_numpy(c.astype(np.int64))
                                                          for c in codes),
                                                        torch.from_numpy(np.array(timbre)))
                          .numpy())
        yield out


@pytest.mark.parametrize("policy", ["bfloat16", "int8", "hybrid_int8"])
def test_codec_round_trip_matches_jax(codecs, policy):
    r = codecs[policy]
    for i, name in enumerate(("codes_p", "codes_c", "codes_r")):
        np.testing.assert_array_equal(getattr(r["f"], name), r["jcodes"][i])
    if policy == "int8":
        # the style encoder runs on bf16 activations: a bf16 rounding apart
        assert bf16_ulps(r["f"].timbre, r["jtimbre"], np.abs(r["jtimbre"]).max()) <= MAX_ULPS
    else:
        np.testing.assert_allclose(r["f"].timbre, r["jtimbre"], rtol=TIMBRE_TOL, atol=TIMBRE_TOL)
    if policy == "hybrid_int8":
        f32 = codecs["f32"]
        for name in ("codes_p", "codes_c", "codes_r"):
            np.testing.assert_array_equal(getattr(r["f"], name), getattr(f32, name))
        np.testing.assert_array_equal(r["f"].timbre, f32.timbre)
    got, want = r["wave"], r["jwave"]
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    print(f"{policy} decode: port vs JAX err/scale {err:.3e} at the worst sample, {rms:.3e} "
          f"in RMS")
    assert rms <= DECODER_VS_JAX
    assert err < DECODER_VS_F32


# -------------------------------------------------------------- training
@pytest.mark.parametrize("name", ["int8", "w8a8", "hybrid_int8"])
def test_int8_training_refused(name):
    from facodec_tpu_torch.train.step import make_codec_train_step, make_codec_train_step_split
    for make in (make_codec_train_step, make_codec_train_step_split):
        with pytest.raises(ValueError, match="inference-only"):
            make({}, {}, precision=name)
    with pytest.raises(NotImplementedError, match="item 10"):
        make_codec_train_step({}, {}, precision="bfloat16")
