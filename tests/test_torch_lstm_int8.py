"""The port's opt-in W8A8 LSTM recurrence (FACODEC_LSTM_INT8) against the
JAX package's, on the CPU.

The gate (`nn.lstm.lstm_int8`) decides as JAX's `_lstm_int8`. Under it each
SLSTM layer runs the hoisted projection and `facodec::lstm_int8`, whose CPU
implementation is the plain version (`ops.kernels.lstm.lstm_int8_reference`,
the oracle of csrc/lstm_int8.cu on the card). The widths here are tiny, so
FACODEC_LSTM_INT8_MIN_BYTES is lowered to let them qualify.

Tolerances: the layer and the SLSTM against JAX's within rtol = atol = 2e-4
(the JAX package's golden tolerance; both quantize h with the same bits, and
the gates' sigmoid and tanh differ in the last float32 bits between the two
frameworks); the bf16-activation decoder within tests/test_torch_precision.py's
limits for that policy (err / scale 2e-2 in RMS, 8e-2 at the worst sample:
the decoders' convs round to bf16 in other places); the float32 no-op,
chunked against one-shot, and an exported SLSTM against the live module
bit-exact.
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.api import FACodec as JFACodec
from facodec_tpu.models import streaming as jstreaming
from facodec_tpu.models.builder import build_model, init_params
from facodec_tpu.nn import lstm as jlstm
from facodec_tpu.ops import precision as jprecision
from facodec_tpu.utils.config import load_config
from facodec_tpu_torch.api import FACodec
from facodec_tpu_torch.models import streaming
from facodec_tpu_torch.models.builder import build_codec
from facodec_tpu_torch.nn import lstm as plstm
from facodec_tpu_torch.ops import precision
from facodec_tpu_torch.ops.kernels import lstm as klstm
from facodec_tpu_torch.profile import LSTM_INT8, kind_of
from facodec_tpu_torch.utils import export
from facodec_tpu_torch.utils.weights import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
CODEC = ("encoder", "quantizer", "decoder")
TOL = dict(rtol=2e-4, atol=2e-4)
DECODER_RMS, DECODER_WORST = 2e-2, 8e-2  # tests/test_torch_precision.py
POLICIES = ("float32", "bfloat16", "bfloat16_act", "int8")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once: eight spinning threads each thrash
    yield
    torch.set_num_threads(n)


@pytest.fixture
def flag(monkeypatch):
    """FACODEC_LSTM_INT8=1 with every width qualifying."""
    monkeypatch.setenv("FACODEC_LSTM_INT8", "1")
    monkeypatch.setenv("FACODEC_LSTM_INT8_MIN_BYTES", "0")


def _layer_weights(H, rng, in_size=None):
    bound = 1.0 / np.sqrt(H)
    u = lambda *s: rng.uniform(-bound, bound, s).astype(np.float32)
    return u(4 * H, in_size or H), u(4 * H, H), u(4 * H), u(4 * H)


def _slstm_params(H, layers, rng):
    return {"lstm": {f"{name}_l{k}": w for k in range(layers)
                     for name, w in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                                        _layer_weights(H, rng))}}


def _pair(H, layers, seed):
    """A JAX SLSTM's params and the port's SLSTM holding them."""
    params = _slstm_params(H, layers, np.random.default_rng(seed))
    m = plstm.SLSTM(H, layers)
    load_jax_params(m, params)
    return params, m


def _j_slstm(H, layers, params, x, state, policy):
    mod = jlstm.SLSTM(dimension=H, num_layers=layers)
    js = None if state is None else tuple(jnp.asarray(s) for s in state)
    with jprecision.policy(policy):
        y, (h, c) = mod.apply({"params": params}, jnp.asarray(x), js, return_state=True)
    return np.asarray(y), np.asarray(h), np.asarray(c)


def _p_slstm(m, x, state, policy):
    ts = None if state is None else tuple(torch.from_numpy(s) for s in state)
    with torch.no_grad(), precision.policy(policy):
        y, (h, c) = m(torch.from_numpy(x), ts, return_state=True)
    return y.numpy(), h.numpy(), c.numpy()


# ------------------------------------------------------------------ gate
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("env", [None, "0", "1"])
def test_gate_matches_jax(monkeypatch, env, policy):
    """Over flag x policy x width x FACODEC_LSTM_INT8_MIN_BYTES: the port's
    gate decides as JAX's, including the float32 no-op and, at the default
    12 MiB, the flagship's 1536-wide decoder in and its 1024-wide encoder out."""
    if env is None:
        monkeypatch.delenv("FACODEC_LSTM_INT8", raising=False)
    else:
        monkeypatch.setenv("FACODEC_LSTM_INT8", env)
    for min_bytes in (None, "0", str(4 * 64 * 64 * 2), str(4 * 64 * 64 * 2 + 1)):
        if min_bytes is None:
            monkeypatch.delenv("FACODEC_LSTM_INT8_MIN_BYTES", raising=False)
        else:
            monkeypatch.setenv("FACODEC_LSTM_INT8_MIN_BYTES", min_bytes)
        for H in (16, 64, 1024, 1536):
            with jprecision.policy(policy), precision.policy(policy):
                want = jlstm._lstm_int8(H)
                assert plstm.lstm_int8(H) == want, (env, policy, min_bytes, H)
            if min_bytes is None and env == "1" and policy != "float32":
                assert want == (H == 1536)
    with precision.policy("hybrid"), precision.policy("hybrid_int8"):
        assert not plstm.lstm_int8(1536)  # entry-point names read as float32 in a model


def test_quantized_weight_is_jax(flag):
    """quantize_weight(w_hh) is JAX's quantize_dynamic(w_hh.T, axes=0),
    transposed, bit for bit."""
    _, w_hh, _, _ = _layer_weights(48, np.random.default_rng(1))
    jq, js = jprecision.quantize_dynamic(jnp.asarray(w_hh).T, axes=0)
    q, s = klstm.quantize_weight(torch.from_numpy(w_hh))
    assert q.dtype == torch.int8 and q.shape == (192, 48) and s.shape == (192,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(-1))


def test_reference_sums_exactly():
    """Sums past 2^24 (up to 1536 * 127 * 127), which float32 cannot hold,
    are formed exactly and rounded once to float32, as JAX's int32 ->
    float32 cast rounds them; the layer stays finite there."""
    H = 1536
    w_q = torch.full((4 * H, H), 127, dtype=torch.int8)
    w_q[1, 0] = 126  # an odd sum, 24774017: half way between two float32s
    w_q[2] = -127
    h_q = precision.quantize_dynamic(torch.ones(2, H), (-1,))[0]
    assert (h_q == 127).all()
    exact = h_q.long() @ w_q.long().t()
    assert int(exact[0, 1]) == 24774017
    got = klstm.exact_sums(h_q, w_q)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exact.float().numpy())
    assert float(got[0, 1]) == 24774016.0  # round half to even
    y, hT, cT = klstm.lstm_int8(torch.zeros(1, 3, 4 * H), w_q, torch.full((4 * H,), 1e-4),
                                torch.ones(1, H), torch.zeros(1, H))
    assert torch.isfinite(y).all() and torch.equal(y[:, -1], hT)


# ------------------------------------------------------ layer and SLSTM
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("policy", ["bfloat16_act", "int8"])
def test_layer_matches_jax(flag, policy, given):
    """The port's layer (the projection as SLSTM forms it: bf16 operands
    summed in float64, then the op) against JAX's `lstm_layer` under the
    same flag (bf16 operands summed in float32)."""
    H, B, T = 24, 3, 11
    rng = np.random.default_rng(5)
    w_ih, w_hh, b_ih, b_hh = _layer_weights(H, rng)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    h0, c0 = ((0.5 * rng.standard_normal((B, H))).astype(np.float32) if given
              else np.zeros((B, H), np.float32) for _ in range(2))
    with jprecision.policy(policy):
        want = jlstm.lstm_layer(*map(jnp.asarray, (x, w_ih, w_hh, b_ih, b_hh, h0, c0)))
    t = torch.from_numpy
    x_proj = (torch.nn.functional.linear(precision.bf16_values(t(x)).double(),
                                         precision.bf16_values(t(w_ih)).double()).float()
              + (t(b_ih) + t(b_hh)))
    got = klstm.lstm_int8(x_proj.contiguous(), *klstm.quantize_weight(t(w_hh)), t(h0), t(c0))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("policy", ["bfloat16_act", "int8"])
def test_slstm_matches_jax(flag, policy, given, monkeypatch):
    """A 2-layer SLSTM under the flag, with a zero or a given (h, c): the
    output and the final state equal JAX's. The op ran once a layer, and the
    flagless bf16 route gives another answer."""
    H, B, T = 32, 2, 13
    params, m = _pair(H, 2, 7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    state = (tuple((0.3 * rng.standard_normal((2, B, H))).astype(np.float32) for _ in range(2))
             if given else None)
    calls = []
    ref = klstm.lstm_int8_reference
    monkeypatch.setattr(klstm, "lstm_int8_reference", lambda *a: calls.append(1) or ref(*a))
    got = _p_slstm(m, x, state, policy)
    assert len(calls) == 2
    want = _j_slstm(H, 2, params, x, state, policy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    monkeypatch.setenv("FACODEC_LSTM_INT8", "0")
    assert not np.array_equal(_p_slstm(m, x, state, policy)[0], got[0])


def test_float32_flag_is_noop(flag, monkeypatch):
    """Under float32 the flag changes no bit, as in the JAX package."""
    _, m = _pair(32, 2, 9)
    x = np.random.default_rng(10).standard_normal((2, 9, 32)).astype(np.float32)
    on = _p_slstm(m, x, None, "float32")
    monkeypatch.delenv("FACODEC_LSTM_INT8")
    off = _p_slstm(m, x, None, "float32")
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_below_threshold_is_noop(monkeypatch):
    """The flag at the default 12 MiB leaves a narrow layer on the bf16 route."""
    monkeypatch.setenv("FACODEC_LSTM_INT8", "1")
    monkeypatch.delenv("FACODEC_LSTM_INT8_MIN_BYTES", raising=False)
    _, m = _pair(32, 2, 11)
    x = np.random.default_rng(12).standard_normal((2, 9, 32)).astype(np.float32)
    on = _p_slstm(m, x, None, "bfloat16_act")
    monkeypatch.setenv("FACODEC_LSTM_INT8", "0")
    off = _p_slstm(m, x, None, "bfloat16_act")
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", [1, 5, 12])
def test_chunked_equals_one_shot(flag, split):
    """Each step's scale depends on that step's h only, so carrying (h, c)
    across a chunk boundary gives the one-shot bits (JAX:
    tests/test_lstm_int8.py:81-100)."""
    _, m = _pair(32, 2, 13)
    x = np.random.default_rng(14).standard_normal((2, 13, 32)).astype(np.float32)
    y, h, c = _p_slstm(m, x, None, "bfloat16_act")
    ya, ha, ca = _p_slstm(m, x[:, :split], None, "bfloat16_act")
    yb, hb, cb = _p_slstm(m, x[:, split:], (ha, ca), "bfloat16_act")
    np.testing.assert_array_equal(y, np.concatenate([ya, yb], 1))
    np.testing.assert_array_equal(h, hb)
    np.testing.assert_array_equal(c, cb)


# ------------------------------------------------------------ the codec
@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(TINY)
    jm = build_model(cfg.model_params, "codec")
    jm = {k: jm[k] for k in CODEC}
    params = init_params(jm, jax.random.PRNGKey(0), seg_frames=4)
    port = build_codec(cfg.model_params)
    for k in CODEC:
        load_jax_params(port[k], params[k])
        port[k].eval()
    return dict(jm=jm, params=params, mods=[port[k] for k in CODEC])


def _gap(got, want):
    rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    return rms, np.abs(got - want).max() / np.abs(want).max()


def test_hybrid_decoder_matches_jax(tiny, flag, monkeypatch):
    """The tiny codec's hybrid decode (bfloat16_act) under the flag against
    JAX's under the same flag: the decoder's SLSTM runs the op, the float32
    encode does not, and the wave is within the bf16 decoder's limits."""
    f = JFACodec(models=tiny["jm"], params=tiny["params"], n_c=2).encode(
        np.random.default_rng(15).standard_normal((2, 12000)).astype(np.float32) * 0.3)
    want = JFACodec(models=tiny["jm"], params=tiny["params"], n_c=2, precision="hybrid").decode(f)
    calls = []
    ref = klstm.lstm_int8_reference
    monkeypatch.setattr(klstm, "lstm_int8_reference", lambda *a: calls.append(1) or ref(*a))
    codec = FACodec(*tiny["mods"], precision="hybrid")
    got = codec.decode(f)
    assert len(calls) == 1  # the decoder's one layer
    rms, worst = _gap(got, want)
    print(f"hybrid decode under the flag, port vs JAX: err/scale {worst:.3e} at the worst "
          f"sample, {rms:.3e} in RMS")
    assert rms <= DECODER_RMS and worst < DECODER_WORST
    codec.encode(np.zeros((1, 6000), np.float32))
    assert len(calls) == 1  # the encode runs float32


def test_streamed_decode_matches_jax(tiny, flag):
    """A streamed decode under bfloat16_act and the flag (the decoder's
    carries, its SLSTM's (h, c) through the op) against JAX's session under
    the same policy and flag."""
    jm, params, mods = tiny["jm"], tiny["params"], tiny["mods"]
    outs = np.random.default_rng(16).standard_normal((2, 36, 64)).astype(np.float32)
    jsess = jstreaming.StreamingFACodec(jm["encoder"], jm["quantizer"], jm["decoder"], params,
                                        chunk_frames=12, n_c=1)
    sess = streaming.StreamingFACodec(*mods, chunk_frames=12, n_c=1)
    jst, st = jsess.init_decode_state(2), sess.init_decode_state(2)
    got, want = [], []
    with jprecision.policy("bfloat16_act"), precision.policy("bfloat16_act"):
        for i in range(0, 36, 12):
            jst, jw = jsess.decode_chunk(jst, jnp.asarray(outs[:, i:i + 12]))
            st, w = sess.decode_chunk(st, torch.from_numpy(outs[:, i:i + 12]))
            want.append(np.asarray(jw, np.float32))
            got.append(w.float().numpy())
    rms, worst = _gap(np.concatenate(got, 1), np.concatenate(want, 1))
    print(f"streamed decode under the flag, port vs JAX: err/scale {worst:.3e} at the worst "
          f"sample, {rms:.3e} in RMS")
    assert rms <= DECODER_RMS and worst < DECODER_WORST
    (jh, jc), (h, c) = jst[0]["model_1"], st[0]["model_1"]
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=DECODER_WORST, atol=DECODER_WORST)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=DECODER_WORST, atol=DECODER_WORST)


class _Root(torch.nn.Module):
    """An export root as utils/export.py builds one: the module in a
    closure, its weights an input through `functional_call`."""

    def __init__(self, m):
        super().__init__()
        self._run = lambda p, x: torch.func.functional_call(m, p, (x,), {"return_state": True})

    def forward(self, params, x):
        with precision.policy("bfloat16_act"):
            return self._run(params, x)


def test_exported_slstm_holds_the_op(flag):
    """A 2-layer SLSTM exported under the flag: one `facodec::lstm_int8`
    node a layer and no `aten.lstm`, the quantized weights made by graph
    ops from the weights it is given, and the live module's bits."""
    _, m = _pair(32, 2, 18)
    x = torch.from_numpy(np.random.default_rng(19).standard_normal((2, 9, 32))
                         .astype(np.float32)).bfloat16()
    params = {k: v.detach() for k, v in m.state_dict().items()}
    with torch.no_grad():
        program = torch.export.export(_Root(m), (params, x), strict=False)
    counts = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    assert counts["facodec.lstm_int8.default"] == 2 and counts["aten.lstm.input"] == 0
    got = program.module()(params, x)
    with torch.no_grad(), precision.policy("bfloat16_act"):
        want = m(x, return_state=True)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1][0], want[1][0]) and torch.equal(got[1][1], want[1][1])
    params = {k: 2 * v for k, v in params.items()}  # another checkpoint: the program requantizes
    got = program.module()(params, x)
    with torch.no_grad():
        for k, v in m.state_dict().items():
            v.mul_(2)
        with precision.policy("bfloat16_act"):
            want = m(x, return_state=True)
    assert torch.equal(got[0], want[0])


def test_export_holds_the_op(tiny, flag, tmp_path):
    """A hybrid decode exported on the CPU under the flag holds one
    `facodec::lstm_int8` node (the decoder's one layer) and no `aten.lstm`,
    and decodes bit for bit as the live codec does: the LSTM's op (the test
    above) and the bf16 residual units' packed op (the plain composition
    live) compute the same values."""
    codec = FACodec(*tiny["mods"], precision="hybrid")
    export.export_codec(codec, str(tmp_path), batch=1, seconds=0.5, functions=("decode",))
    exp = export.ExportedCodec(str(tmp_path))
    counts = Counter(str(n.target) for n in exp.program("decode").graph.nodes
                     if n.op == "call_function")
    assert counts["facodec.lstm_int8.default"] == 1
    assert counts["aten.lstm.input"] == 0
    rng = np.random.default_rng(17)
    cp, cc, cr = (torch.from_numpy(rng.integers(0, 32, (1, n, 40)).astype(np.int32))
                  for n in (1, 2, 3))
    timbre = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    got = exp.decode(export.codec_params(codec), cp, cc, cr, timbre)
    with torch.no_grad():
        want = codec.decode_tensor(cp, cc, cr, timbre)
    assert torch.equal(got, want), float((got - want).abs().max())


def test_opcheck():
    """The op's schema, fake and CPU implementation pass `opcheck`."""
    g = torch.Generator().manual_seed(0)
    H, B, T = 8, 2, 5
    args = (torch.randn(B, T, 4 * H, generator=g),
            torch.randint(-127, 128, (4 * H, H), generator=g, dtype=torch.int8),
            torch.rand(4 * H, generator=g) * 1e-2, torch.randn(B, H, generator=g),
            torch.randn(B, H, generator=g))
    result = torch.library.opcheck(torch.ops.facodec.lstm_int8.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def _ops(B=2, T=3, H=8):
    return [torch.zeros(B, T, 4 * H), torch.zeros(4 * H, H, dtype=torch.int8),
            torch.ones(4 * H), torch.zeros(B, H), torch.zeros(B, H)]


@pytest.mark.parametrize("case,error", [
    ("x_proj_2d", ValueError), ("x_proj_width", ValueError), ("empty_time", ValueError),
    ("w_q_shape", ValueError), ("w_q_float", TypeError), ("h0_batch", ValueError),
    ("c0_double", TypeError)])
def test_wrapper_refuses(case, error):
    ops = _ops()
    if case == "x_proj_2d":
        ops[0] = ops[0][0]
    elif case == "x_proj_width":
        ops[0] = torch.zeros(2, 3, 30)
    elif case == "empty_time":
        ops[0] = torch.zeros(2, 0, 32)
    elif case == "w_q_shape":
        ops[1] = ops[1].t().contiguous()
    elif case == "w_q_float":
        ops[1] = ops[1].float()
    elif case == "h0_batch":
        ops[3] = torch.zeros(3, 8)
    elif case == "c0_double":
        ops[4] = ops[4].double()
    with pytest.raises(error):
        klstm.lstm_int8(*ops)


def test_profile_kind():
    """A trace files the kernel (and its barrier probe) under its own kind,
    not under cuDNN's LSTM, whose keys match its name."""
    for name in ("void (anonymous namespace)::lstm_int8_kernel<4>((anonymous namespace)::Args)",
                 "(anonymous namespace)::lstm_barrier_kernel(int)"):
        assert kind_of(name) == LSTM_INT8
    assert kind_of("void LSTM_elementWise_fp<float, float, float, 1, 1>(int)") == "cuDNN LSTM"
