"""The port's bf16 training steps against the JAX package's, on the CPU.

The tiny model set of tests/test_torch_train_step.py (its fields, seeded
weights moved by `load_jax_params`, every draw out of play) trains one step
under `bfloat16` (bf16 conv and matmul operands, float32 activations) and
`bfloat16_act` (bf16 activations between layers too). The JAX side runs the
fused step's own closures (`_make_parts`) under `policy(precision)`,
compiled with XLA's excess precision off, so that it keeps every rounding
its code writes (tests/test_torch_precision.py), and once more with it on
(XLA's default): the two compilations of the same step are the reference's
own spread. Held here, for the port's fused and split steps:
- every `loss/*` within 2e-2 relative of JAX's;
- each module's gradient within 5e-2 of JAX's in L2 over the module (or,
  where JAX's own two compilations differ by more, within that spread), and
  under `bfloat16` every tensor that the reference determines to 5e-2 of its
  max|g| (its two compilations agree that far) within 5e-2 x max|g_jax|;
- the parameters float32 after the update, and every module's moved;
- the float32 step unchanged by the policy argument, the int8 policies
  refused.

Why not every tensor to 5e-2 x max|g|: a bf16 step's gradient of a tensor
whose sums cancel (a weight-norm gain, the last conv's gain, a snake alpha
deep in the encoder, the attention's key bias, whose exact gradient is zero
by softmax's shift invariance) moves by more than that between two faithful
evaluations: one flipped bf16 rounding in the forward moves every later
layer. The reference shows it itself: its two compilations of the same step
differ by up to 2 x max|g| on such tensors (printed by the tests). Two
rounding points did differ from JAX's and were found this way: the
discriminators' leaky ReLU on a bf16 x (JAX multiplies by the bf16 0.1;
fixed in the port), and the gradient of a bias added in bf16 (under
`bfloat16_act`), which XLA's CPU backend sums in bf16 in an order of its own
(5% of the sum off its correctly rounded value on one such add) while torch
sums in float32 and rounds once. The second is the port's recorded
departure: the JAX side here adds its bf16 biases through `_exact_bias_add`,
whose backward sums in float32 and rounds once, and the gap to the
unpatched step is printed. The LSTM's per-step h rounding (a recorded
departure of the port) is left in JAX's step: its share of the gaps is
printed too.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
from jax import lax

import facodec_tpu.models.discriminator as jdisc
import facodec_tpu.nn.conv as jconv
import facodec_tpu.nn.lstm as jlstm
from facodec_tpu.ops import precision as jprecision
from facodec_tpu.train.optimizers import GEN_KEYS as J_GEN_KEYS
from facodec_tpu.train.optimizers import build_optimizers as j_build_optimizers
from facodec_tpu.train.optimizers import init_opt_states
from facodec_tpu.train.step import _make_parts
from facodec_tpu_torch.models.builder import build_train_from_fields
from facodec_tpu_torch.train.optimizers import build_optimizers
from facodec_tpu_torch.train.step import make_codec_train_step, make_codec_train_step_split
from facodec_tpu_torch.utils.weights import init_random_
from test_torch_train_step import (FIELDS, J_CLASSES, MODULES, by_path, jax_tree, make_batch,
                                   port_models)

POLICIES = ("bfloat16", "bfloat16_act")
LOSS_REL = 2e-2
GRAD_REL = 5e-2


# ------------------------------------------------- the JAX side's patches
@jax.custom_vjp
def _exact_bias_add(y, b):
    return y + b.astype(y.dtype)


def _exact_bias_fwd(y, b):
    return _exact_bias_add(y, b), jnp.zeros_like(b)


def _exact_bias_bwd(zeros, ct):
    """The bias's gradient summed in float32 and rounded once to the add's
    dtype (the port's autograd), where XLA's CPU backend sums a bf16
    cotangent in bf16."""
    axes = tuple(i for i in range(ct.ndim) if zeros.shape[i] == 1 and ct.shape[i] != 1)
    gb = jnp.sum(ct.astype(jnp.float32), axis=axes, keepdims=True)
    return ct, gb.astype(ct.dtype).astype(zeros.dtype)


_exact_bias_add.defvjp(_exact_bias_fwd, _exact_bias_bwd)


class _Conv2dExactBias(jconv.Conv2d):
    """JAX's Conv2d with its bias added through `_exact_bias_add`."""

    @fnn.compact
    def __call__(self, x):
        kh, kw = self.kernel_size
        fan_in = self.in_channels * kh * kw
        w = self._weight((self.out_channels, self.in_channels, kh, kw), fan_in, self.weight_norm)
        b = self._bias(self.out_channels, fan_in, self.use_bias)
        x, kernel = jconv.cast_operands(x, jnp.transpose(w, (2, 3, 1, 0)))
        y = lax.conv_general_dilated(
            x, kernel, window_strides=self.stride,
            padding=[(self.padding[0], self.padding[0]), (self.padding[1], self.padding[1])],
            rhs_dilation=self.dilation, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ).astype(jconv.out_dtype())
        return y if b is None else _exact_bias_add(y, b[None, None, None, :])


def _exact_bias(mp: pytest.MonkeyPatch) -> None:
    """Every JAX conv that adds a bias in bf16 adds it through
    `_exact_bias_add`: the 1-D convs and transposed convs, whose classes call
    the module's functions, and the discriminators' Conv2d."""
    conv1d, convt = jconv.conv1d_ntc, jconv.conv_transpose1d_ntc

    def conv1d_ntc(x, w, bias, *args, **kwargs):
        y = conv1d(x, w, None, *args, **kwargs)
        return y if bias is None else _exact_bias_add(y, bias[None, None, :])

    def conv_transpose1d_ntc(x, w, bias, *args, **kwargs):
        y = convt(x, w, None, *args, **kwargs)
        return y if bias is None else _exact_bias_add(y, bias[None, None, :])

    mp.setattr(jconv, "conv1d_ntc", conv1d_ntc)
    mp.setattr(jconv, "conv_transpose1d_ntc", conv_transpose1d_ntc)
    mp.setattr(jdisc, "Conv2d", _Conv2dExactBias)


def _h_unrounded(mp: pytest.MonkeyPatch) -> None:
    """JAX's LSTM with its recurrent product on a float32 h (the port's
    recorded departure: cuDNN does not round h at each step); used only to
    measure that departure's share of the gaps."""
    matmul = jlstm.matmul

    def recurrent_float32(a, b):
        if a.ndim == 2:  # h (B, H) times w_hh.T, inside the scan
            return jnp.matmul(a.astype(jnp.float32), b.astype(jnp.float32),
                              preferred_element_type=jnp.float32)
        return matmul(a, b)

    mp.setattr(jlstm, "matmul", recurrent_float32)


# --------------------------------------------------------------- the runs
def _jax_step_fn(models, optimizers, precision):
    parts = _make_parts(models, remat=False, precision=precision, f0_teacher=None,
                        paired_g=False)

    def step(params, opt_states, batch, rng):
        gen_params = {k: params[k] for k in J_GEN_KEYS}
        outs, vjp = jax.vjp(lambda gp: parts["gen_forward"](gp, batch, rng), gen_params)
        d_loss, d_grads = jax.value_and_grad(parts["disc_loss_fn"])(
            params["discriminator"], jax.lax.stop_gradient(outs[0]), batch["wave_seg"][:, :, None])
        updates, _ = optimizers["discriminator"].update(d_grads, opt_states["discriminator"],
                                                        params["discriminator"])
        new_disc = optax.apply_updates(params["discriminator"], updates)
        (_, metrics), outs_ct = jax.value_and_grad(parts["gen_loss_from_outputs"],
                                                   has_aux=True)(outs, new_disc, batch)
        metrics["loss/disc"] = d_loss
        return metrics, dict(vjp(outs_ct)[0], discriminator=d_grads)

    return step


def _jax_run(params, batch, precision, excess, patches=()):
    """One JAX step under `precision`: (metrics, gradients), numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        for patch in patches:
            patch(mp)
        models = {k: J_CLASSES[k](**FIELDS[k]) for k in MODULES}
        models["discriminator"] = jdisc.Discriminator(**FIELDS["discriminator"])
        optimizers = j_build_optimizers(models.keys(), base_lr=1e-4)
        opt_states = init_opt_states(optimizers, params)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        args = (params, opt_states, jb, jax.random.PRNGKey(1))
        with jprecision.policy(precision):
            fn = jax.jit(_jax_step_fn(models, optimizers, precision)).lower(*args).compile(
                {"xla_allow_excess_precision": excess})
        metrics, grads = fn(*args)
    return {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs six files at once
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seeded():
    """The seeded JAX parameter tree and the batch (numpy)."""
    models = build_train_from_fields(FIELDS)
    gen = torch.Generator().manual_seed(0)
    params = {k: jax_tree(init_random_(models[k], gen)) for k in MODULES}
    return dict(params=params, batch=make_batch(np.random.default_rng(0)))


_JAX_CACHE: dict = {}


def jax_side(seeded, precision):
    """JAX's step under `precision`: the reference (excess precision off)
    and the spread (excess precision on), with the bf16 bias adds summed
    exactly under `bfloat16_act`, plus the unpatched reference there."""
    if precision not in _JAX_CACHE:
        patches = (_exact_bias,) if precision == "bfloat16_act" else ()
        run = dict(ref=_jax_run(seeded["params"], seeded["batch"], precision, False, patches),
                   spread=_jax_run(seeded["params"], seeded["batch"], precision, True, patches))
        if patches:
            run["unpatched"] = _jax_run(seeded["params"], seeded["batch"], precision, False)
        _JAX_CACHE[precision] = run
    return _JAX_CACHE[precision]


def port_step(params, batch, precision, split):
    models = port_models(params)
    optimizers = build_optimizers(models, base_lr=1e-4)
    make = make_codec_train_step_split if split else make_codec_train_step
    metrics, grads = make(models, optimizers, precision=precision)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator().manual_seed(1))
    return models, optimizers, {k: float(v) for k, v in metrics.items()}, grads


def _module_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in want)
    return float(np.sqrt(num / sum(float(np.sum(w ** 2)) for w in want.values())))


def _grad_gaps(models, optimizers, grads, ref, other) -> dict:
    """Per module: the port's L2 gap to `ref`, `other`'s (JAX's spread), and
    per tensor (gap, other's gap), each of max|g_ref|."""
    out = {}
    for module in MODULES:
        want = by_path(models[module], ref[module])
        alt = by_path(models[module], other[module])
        got = {n: (np.zeros_like(want[n]) if g is None else g.detach().numpy())
               for n, g in zip(optimizers[module].names, grads[module])}
        scale = {n: max(float(np.abs(w).max()), 1e-30) for n, w in want.items()}
        out[module] = dict(
            l2=_module_l2(got, want), spread=_module_l2(alt, want),
            tensors={n: (float(np.abs(got[n] - want[n]).max()) / scale[n],
                         float(np.abs(alt[n] - want[n]).max()) / scale[n]) for n in want})
    return out


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("precision", POLICIES)
def test_bf16_step_matches_jax(seeded, torch_threads, precision, split):
    """Losses within 2e-2 relative; gradients as the module docstring says;
    parameters float32 and moved."""
    jx = jax_side(seeded, precision)
    models, optimizers, metrics, grads = port_step(seeded["params"], seeded["batch"],
                                                   precision, split)
    want = {k: v for k, v in jx["ref"][0].items() if k.startswith("loss/")}
    assert set(k for k in metrics if k.startswith("loss/")) == set(want)
    worst_loss = 0.0
    for k in sorted(want):
        assert np.isfinite(metrics[k]), k
        rel = abs(metrics[k] - want[k]) / abs(want[k])
        worst_loss = max(worst_loss, rel)
        assert rel <= LOSS_REL, (k, metrics[k], want[k])
    gaps = _grad_gaps(models, optimizers, grads, jx["ref"][1], jx["spread"][1])
    print(f"{precision} {'split' if split else 'fused'}: worst loss gap {worst_loss:.3e}")
    for module, g in gaps.items():
        worst = max(g["tensors"].items(), key=lambda kv: kv[1][0])
        determined = {n: v for n, v in g["tensors"].items() if v[1] <= GRAD_REL}
        worst_det = max(determined.items(), key=lambda kv: kv[1][0]) if determined else None
        print(f"  {module}: L2 gap {g['l2']:.3e} (JAX's own spread {g['spread']:.3e}); worst "
              f"tensor {worst[0]} {worst[1][0]:.3e} of max|g| (JAX's spread {worst[1][1]:.3e}); "
              f"{len(determined)} of {len(g['tensors'])} tensors determined to {GRAD_REL}"
              + (f", worst {worst_det[0]} {worst_det[1][0]:.3e}" if worst_det else ""))
        assert g["l2"] <= max(GRAD_REL, g["spread"]), (module, g["l2"], g["spread"])
        if precision == "bfloat16":
            for name, (gap, _) in determined.items():
                assert gap <= GRAD_REL, (module, name, gap)
    if "unpatched" in jx:
        raw = _grad_gaps(models, optimizers, grads, jx["unpatched"][1], jx["ref"][1])
        print("  against JAX with its own bf16 bias-gradient sums (the recorded departure): "
              + ", ".join(f"{m} L2 {g['l2']:.3e}" for m, g in raw.items()))
    start = port_models(seeded["params"])
    for module in MODULES:
        params = list(models[module].parameters())
        assert all(p.dtype == torch.float32 for p in params), module
        assert any(not torch.equal(p, q) for p, q in zip(params, start[module].parameters())), \
            module


@pytest.mark.slow  # one more JAX step compile, a measurement for the records
def test_lstm_h_rounding_share(seeded, torch_threads):
    """The recorded departure of the LSTM (cuDNN does not round h at every
    step): the port's `bfloat16_act` step against JAX's with and without
    its per-step h rounding; printed, and both within the step's limits."""
    jx = jax_side(seeded, "bfloat16_act")
    unrounded = _jax_run(seeded["params"], seeded["batch"], "bfloat16_act", False,
                         (_exact_bias, _h_unrounded))
    models, optimizers, metrics, grads = port_step(seeded["params"], seeded["batch"],
                                                   "bfloat16_act", False)
    for label, ref in (("JAX", jx["ref"]), ("JAX without h rounding", unrounded)):
        worst = max(abs(metrics[k] - v) / abs(v) for k, v in ref[0].items()
                    if k.startswith("loss/"))
        gaps = _grad_gaps(models, optimizers, grads, ref[1], jx["spread"][1])
        print(f"bfloat16_act port against {label}: worst loss gap {worst:.3e}; gradient L2 "
              + ", ".join(f"{m} {g['l2']:.3e}" for m, g in gaps.items()))
        assert worst <= LOSS_REL
    gaps = {m: _module_l2(by_path(models[m], unrounded[1][m]), by_path(models[m], jx["ref"][1][m]))
            for m in MODULES}
    print("JAX without h rounding against JAX, gradient L2: "
          + ", ".join(f"{m} {v:.3e}" for m, v in gaps.items()))


@pytest.mark.parametrize("name", ["float32", "f32", "fp32"])
def test_float32_step_unchanged(seeded, torch_threads, name):
    """The float32 step under its name and aliases gives the bits of the step
    built without a policy argument."""
    want = port_step(seeded["params"], seeded["batch"], name, False)
    models = port_models(seeded["params"])
    optimizers = build_optimizers(models, base_lr=1e-4)
    metrics, grads = make_codec_train_step(models, optimizers)(
        {k: torch.from_numpy(v) for k, v in seeded["batch"].items()},
        torch.Generator().manual_seed(1))
    assert {k: float(v) for k, v in metrics.items()} == want[2]
    for module in MODULES:
        for a, b in zip(grads[module], want[3][module]):
            assert (a is None and b is None) or torch.equal(a, b)
        for p, q in zip(models[module].parameters(), want[0][module].parameters()):
            assert torch.equal(p, q)


@pytest.mark.parametrize("name", ["int8", "w8a8", "hybrid_int8"])
def test_int8_policies_still_refused(name):
    for make in (make_codec_train_step, make_codec_train_step_split):
        with pytest.raises(ValueError, match="inference-only"):
            make({}, {}, precision=name)


@pytest.mark.parametrize("name", ["hybrid", "fp16"])
def test_other_names_refused(name):
    """`hybrid` is an entry-point policy, not a training one; an unknown name
    raises as the JAX policy does."""
    with pytest.raises(ValueError):
        make_codec_train_step({}, {}, precision=name)


def _close_steps(got, want, rel):
    for k, v in want[2].items():
        assert abs(got[2][k] - v) <= rel * max(abs(v), 1e-12), (k, got[2][k], v)
    for module in MODULES:
        for a, b in zip(got[3][module], want[3][module]):
            if a is None or b is None:
                assert a is None and b is None
                continue
            assert (a - b).abs().max() <= rel * b.abs().max(), module


@pytest.mark.parametrize("precision", POLICIES)
def test_remat_under_policy(seeded, torch_threads, precision, monkeypatch):
    """`remat` recomputes the generator forward, the discriminator loss and
    phase G's loss under the step's policy: the fused and split steps with
    it give the steps' metrics and gradients without it (within 1e-5
    relative, as the float32 remat test holds them)."""
    import facodec_tpu_torch.train.step as step_mod

    for split in (False, True):
        want = port_step(seeded["params"], seeded["batch"], precision, split)
        models = port_models(seeded["params"])
        optimizers = build_optimizers(models, base_lr=1e-4)
        make = make_codec_train_step_split if split else make_codec_train_step
        recomputed = []
        with monkeypatch.context() as mp:
            mp.setattr(step_mod, "get_policy", lambda: (recomputed.append(1),
                                                        step_mod.check(precision))[1])
            metrics, grads = make(models, optimizers, remat=True, precision=precision)(
                {k: torch.from_numpy(v) for k, v in seeded["batch"].items()},
                torch.Generator().manual_seed(1))
        assert recomputed
        _close_steps((models, optimizers, {k: float(v) for k, v in metrics.items()}, grads),
                     want, 1e-5)


@pytest.mark.parametrize("precision", POLICIES)
def test_teacher_under_policy(seeded, torch_threads, precision, tmp_path):
    """The inline JDC teacher runs inside the step's policy (its LSTM and
    classifier on bf16 operands, as the JAX package's policy `matmul`s);
    the step's losses are finite and its F0 targets are the teacher's under
    that policy."""
    from facodec_tpu_torch.models.jdc import load_jdc_checkpoint, random_reference_state_dict
    from facodec_tpu_torch.ops.precision import policy

    path = str(tmp_path / "bst.t7")
    torch.save({"net": random_reference_state_dict(0)}, path)
    teacher = load_jdc_checkpoint(path, "cpu")
    models = port_models(seeded["params"])
    optimizers = build_optimizers(models, base_lr=1e-4)
    batch = {k: torch.from_numpy(v) for k, v in seeded["batch"].items()}
    seen = []
    hook = teacher.register_forward_hook(lambda m, a, out: seen.append(out[0].detach()))
    metrics, _ = make_codec_train_step(models, optimizers, precision=precision,
                                       f0_teacher=teacher)(batch, torch.Generator().manual_seed(1))
    hook.remove()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    with torch.no_grad(), policy(precision):
        want, _ = teacher(batch["mel_seg"])
    with torch.no_grad():
        f32, _ = teacher(batch["mel_seg"])
    assert torch.equal(seen[0], want) and not torch.equal(want, f32)


MSD_FIELDS = dict(rates=(1, 2), periods=(), fft_sizes=(), sample_rate=24000)


@pytest.mark.parametrize("precision", POLICIES)
def test_msd_under_policy(precision):
    """The multi-scale discriminator (off in the flagship, built by `rates`)
    under a bf16 policy against JAX's: its grouped `Conv1d`s round as JAX's
    do (bf16 maps between layers under `bfloat16_act`, the same dtype at
    every feature map) and its julius resampler stays a float32 conv in the
    input's dtype; the discriminator loss within 2e-2 relative and its
    gradient within 5e-2 of JAX's in L2 over the module (or JAX's own
    spread, as the step test holds it)."""
    from facodec_tpu.losses import discriminator_loss as j_discriminator_loss
    from facodec_tpu_torch.losses import discriminator_loss
    from facodec_tpu_torch.models.discriminator import Discriminator
    from facodec_tpu_torch.ops.precision import policy
    from facodec_tpu_torch.train.step import disc_pair

    port = Discriminator(**MSD_FIELDS)
    init_random_(port, torch.Generator().manual_seed(0))
    params = jax_tree(port)
    jd = jdisc.Discriminator(**MSD_FIELDS)
    rng = np.random.default_rng(5)
    fake, real = ((rng.standard_normal((2, 1200, 1)) * 0.3).astype(np.float32) for _ in range(2))

    def jloss(p, f, r):
        both = jd.apply({"params": p}, jnp.concatenate([f, r], 0))
        return j_discriminator_loss([[x[:2] for x in fm] for fm in both],
                                    [[x[2:] for x in fm] for fm in both])

    with jprecision.policy(precision):
        want_dtypes = [[x.dtype for x in fm] for fm in jax.eval_shape(
            lambda p, x: jd.apply({"params": p}, x), params, np.concatenate([fake, real], 0))]
    out = {}
    for excess in (False, True):
        with jprecision.policy(precision):
            fn = jax.jit(jax.value_and_grad(jloss)).lower(params, fake, real).compile(
                {"xla_allow_excess_precision": excess})
        loss, grads = fn(params, fake, real)
        out[excess] = float(loss), by_path(port, grads)
    with policy(precision):
        d_fake, d_real = disc_pair(port, torch.from_numpy(fake), torch.from_numpy(real))
        loss = discriminator_loss(d_fake, d_real)
        grads = torch.autograd.grad(loss, list(port.parameters()))
    want_loss, want = out[False]
    got_dtypes = [[str(x.dtype).replace("torch.", "") for x in fm] for fm in d_fake]
    assert got_dtypes == [[str(d) for d in fm] for fm in want_dtypes]
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss), (float(loss), want_loss)
    got = {n: g.numpy() for (n, _), g in zip(port.named_parameters(), grads)}
    gap, spread = _module_l2(got, want), _module_l2(out[True][1], want)
    print(f"{precision} MSD: loss {float(loss):.6g} against {want_loss:.6g}; gradient L2 gap "
          f"{gap:.3e} (JAX's own spread {spread:.3e})")
    assert gap <= max(GRAD_REL, spread), (gap, spread)
