"""The port's codec GAN training step against the JAX package's, on the CPU.

The tiny model set of tests/test_train_step.py (its fields copied here) is
built on both sides. Seeded random weights are drawn once (the port's
`init_random_`, each module's state dict read out as a JAX parameter tree by
key name) and move into each port model with `load_jax_params`, which
checks every key. Every draw is out of play on both sides:
`quantizer_dropout=0` and `prob_random_mask_residual=0` are module fields,
the JAX dropout layers are identity inside this module only (a monkeypatch
of flax's `nn.Dropout.__call__`, undone at teardown) and the port's dropout
rates are set to 0 on its module instances.

The JAX side runs the fused step's own closures (`train/step.py`
`_make_parts`) in one jitted function that also returns the gradients; it
is compiled once for the module. Held here:
- `forward_v2(train=True)` of the quantizer (codes bit-exact, values at
  rtol = atol = 2e-4) and `FApredictors.forward_v2`, values and gradients;
- the whole step: every `loss/*` within 2e-4, every parameter's gradient
  within 1e-3 * max|g_jax| + 1e-7 per tensor (a gradient's scale is its
  own: summed over batch, time and channels, its entries span decades, so
  a tolerance relative to the tensor's largest entry is what the golden
  tolerance means for it);
- the port's AdamW fed the JAX gradients for two steps against optax's
  update (the JAX package's own chain) within rtol 1e-5 (fed the same gradients, so Adam's sign
  sensitivity for tiny gradients stays out of the comparison).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from facodec_tpu.models.dac import Decoder as JDecoder
from facodec_tpu.models.dac import Encoder as JEncoder
from facodec_tpu.models.discriminator import Discriminator as JDiscriminator
from facodec_tpu.models.fa_quantizer import FApredictors as JFApredictors
from facodec_tpu.models.fa_quantizer import FAquantizer as JFAquantizer
from facodec_tpu.train.optimizers import GEN_KEYS as J_GEN_KEYS
from facodec_tpu.train.optimizers import build_optimizers as j_build_optimizers
from facodec_tpu.train.optimizers import init_opt_states
from facodec_tpu.train.step import _make_parts
from facodec_tpu_torch.models.builder import build_train_from_fields
from facodec_tpu_torch.train.optimizers import GEN_KEYS, build_optimizers
from facodec_tpu_torch.train.step import make_codec_train_step
from facodec_tpu_torch.utils.weights import (flatten_tree, init_random_, load_jax_params,
                                             torch_key_to_path)

TOL = dict(rtol=2e-4, atol=2e-4)
FRAMES, HOP, B = 4, 300, 2
MODULES = ("encoder", "quantizer", "decoder", "fa_predictors", "discriminator")

# tests/test_train_step.py `tiny_models`, with the quantizer's draws off
FIELDS = dict(
    encoder=dict(d_model=8, strides=(15, 20), d_latent=64, causal=True, lstm=1),
    quantizer=dict(in_dim=64, n_p_codebooks=1, n_c_codebooks=2, n_t_codebooks=2,
                   n_r_codebooks=3, codebook_size=32, codebook_dim=4, quantizer_dropout=0.0,
                   causal=True, separate_prosody_encoder=True, timbre_norm=True,
                   style_hidden_dim=32, prosody_hidden_dim=16, prob_random_mask_residual=0.0),
    decoder=dict(input_channel=64, channels=16, rates=(20, 15), causal=True, lstm=1),
    discriminator=dict(rates=(), periods=(2,), fft_sizes=(512,), sample_rate=24000),
    fa_predictors=dict(in_dim=64, use_gr_content_f0=False, use_gr_prosody_phone=False,
                       use_gr_residual_f0=True, use_gr_residual_phone=True,
                       use_gr_timbre_content=True, use_gr_timbre_prosody=False,
                       use_gr_x_timbre=True, norm_f0=True, timbre_norm=True,
                       use_gr_content_global_f0=True, n_phone_classes=32, n_speakers=16),
)
J_CLASSES = dict(encoder=JEncoder, quantizer=JFAquantizer, decoder=JDecoder,
                 discriminator=JDiscriminator, fa_predictors=JFApredictors)


def make_batch(rng, batch=B):
    """tests/test_train_step.py `make_batch`, as numpy."""
    tw = FRAMES * HOP
    return dict(
        wave_seg=(rng.standard_normal((batch, tw)) * 0.3).astype(np.float32),
        mel_seg=(rng.standard_normal((batch, FRAMES, 80)) * 0.5).astype(np.float32),
        f0=(np.abs(rng.standard_normal((batch, FRAMES))) * 200).astype(np.float32),
        phone_ids=rng.integers(0, 32, (batch, FRAMES)).astype(np.int32),
        spk_labels=rng.integers(0, 16, (batch,)).astype(np.int32),
        full_waves=(rng.standard_normal((batch, 2 * tw)) * 0.3).astype(np.float32),
        wave_lens=np.full((batch,), 2 * tw, np.int32),
    )


def no_dropout(module: torch.nn.Module) -> torch.nn.Module:
    """Every dropout rate of the port's module instances set to 0."""
    for m in module.modules():
        for attr in ("p_dropout", "dropout"):
            if isinstance(getattr(m, attr, None), float):
                setattr(m, attr, 0.0)
    return module


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


def port_models(params):
    models = build_train_from_fields(FIELDS)
    for k in MODULES:
        load_jax_params(models[k], params[k])
        no_dropout(models[k])
    return models


def by_path(module, tree):
    """{port parameter name: the JAX tree's leaf at its path}."""
    flat = flatten_tree(tree)
    return {name: np.asarray(flat[torch_key_to_path(name)])
            for name, _ in module.named_parameters()}


def assert_grad_close(got, want, name, rel=1e-3):
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    bound = rel * np.abs(want).max() + 1e-7
    err = np.abs(got - want).max()
    assert err <= bound, f"{name}: max err {err:.3e} > {bound:.3e} (max|g| {np.abs(want).max():.3e})"


def _jax_step(models, optimizers, f0_teacher=None):
    parts = _make_parts(models, remat=False, precision="float32", f0_teacher=f0_teacher,
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

    return jax.jit(step)


def _jax_run(f0_teacher=None):
    """The seeded models, their JAX parameters, optimizers and batch, and
    one JAX step's metrics and gradients (dropout off)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        models = {k: J_CLASSES[k](**FIELDS[k]) for k in MODULES}
        seeded = build_train_from_fields(FIELDS)
        gen = torch.Generator().manual_seed(0)
        params = {k: jax_tree(init_random_(seeded[k], gen)) for k in MODULES}
        optimizers = j_build_optimizers(models.keys(), base_lr=1e-4)
        opt_states = init_opt_states(optimizers, params)
        batch = make_batch(np.random.default_rng(0))
        metrics, grads = _jax_step(models, optimizers, f0_teacher)(
            params, opt_states, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(1))
    return dict(models=models, params=params, optimizers=optimizers, opt_states=opt_states,
                batch=batch, metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def jax_side():
    with pytest.MonkeyPatch.context() as mp:  # dropout off for the module's tests
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        yield _jax_run()


@pytest.fixture(scope="module")
def port_step(jax_side):
    models = port_models(jax_side["params"])
    optimizers = build_optimizers(models, base_lr=1e-4)
    step = make_codec_train_step(models, optimizers)
    batch = {k: torch.from_numpy(v) for k, v in jax_side["batch"].items()}
    metrics, grads = step(batch, torch.Generator().manual_seed(1))
    return dict(models=models, optimizers=optimizers, metrics=metrics, grads=grads)


def test_step_losses_match_jax(jax_side, port_step):
    want = {k: v for k, v in jax_side["metrics"].items() if k.startswith("loss/")}
    got = {k: float(v) for k, v in port_step["metrics"].items() if k.startswith("loss/")}
    assert set(got) == set(want)
    for k in sorted(want):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("module", MODULES)
def test_step_gradients_match_jax(jax_side, port_step, module):
    want = by_path(port_step["models"][module], jax_side["grads"][module])
    names = port_step["optimizers"][module].names
    got = dict(zip(names, port_step["grads"][module]))
    assert set(got) == set(want)
    for name in names:
        assert_grad_close(got[name], want[name], f"{module}.{name}")
    norm = np.sqrt(sum(float(np.sum(np.square(g))) for g in want.values()))
    np.testing.assert_allclose(float(port_step["metrics"][f"grad_norm/{module}"]), norm,
                               rtol=1e-3)


def optax_two_steps(jax_side, module):
    """The module's parameters after two optax updates from the JAX step's
    gradients, the second from half of them. optax runs eagerly on the
    parameters and gradients raveled into one vector each: every term of
    the chain is elementwise but the clip's global norm, which one vector
    has as the whole tree does, and one leaf keeps the eager dispatch short."""
    from jax.flatten_util import ravel_pytree

    p, unravel = ravel_pytree(jax_side["params"][module])
    g, _ = ravel_pytree(jax_side["grads"][module])
    opt = jax_side["optimizers"][module]
    state = opt.init(p)
    for scale in (1.0, 0.5):
        updates, state = opt.update(g * scale, state, p)
        p = optax.apply_updates(p, updates)
    return jax.tree.map(np.asarray, unravel(p))


@pytest.mark.parametrize("module", MODULES)
def test_optimizer_matches_optax(jax_side, module):
    """The port's AdamW fed the same two gradients, against optax's chain,
    within rtol 1e-5; every parameter moved."""
    port = port_models(jax_side["params"])[module]
    popt = build_optimizers({module: port}, base_lr=1e-4)[module]
    grads = by_path(port, jax_side["grads"][module])
    for scale in (1.0, 0.5):
        popt.step([torch.from_numpy(grads[n] * scale) for n in popt.names])
    want = by_path(port, optax_two_steps(jax_side, module))
    start = by_path(port, jax_side["params"][module])
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        assert not np.array_equal(want[name], start[name]), name
    assert popt.count == 2


def test_quantizer_train_forward_matches_jax(jax_side):
    """`forward_v2(train=True)`: codes bit-exact, outputs and losses at the
    golden tolerance, and the gradient of a weighted sum of them."""
    qt = jax_side["models"]["quantizer"]
    params = jax_side["params"]["quantizer"]
    rng = np.random.default_rng(3)
    z = rng.standard_normal((B, FRAMES, 64)).astype(np.float32)
    batch = jax_side["batch"]
    w = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, FRAMES, 64), (B, FRAMES, 64), (B, FRAMES, 64), (B, FRAMES, 64), (B, 64))]

    def jfn(p, z):
        outs, q, commit, cb, timbre, codes = qt.apply(
            {"params": p}, z, jnp.asarray(batch["wave_seg"]), n_c=2,
            full_waves=jnp.asarray(batch["full_waves"]), wave_lens=jnp.asarray(batch["wave_lens"]),
            train=True, return_codes=True, rngs={"dropout": jax.random.PRNGKey(2)})
        scalar = (jnp.sum(outs * w[0]) + jnp.sum(q[0] * w[1]) + jnp.sum(q[1] * w[2])
                  + jnp.sum(q[2] * w[3]) + jnp.sum(timbre * w[4]) + 3.0 * commit + 2.0 * cb)
        return scalar, (outs, q, commit, cb, timbre, codes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        (_, aux), (jgp, jgz) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(z))
    port = port_models(jax_side["params"])["quantizer"]
    zt = torch.from_numpy(z).requires_grad_(True)
    outs, q, commit, cb, timbre = port.forward_v2(
        zt, torch.from_numpy(batch["wave_seg"]), n_c=2,
        full_waves=torch.from_numpy(batch["full_waves"]),
        wave_lens=torch.from_numpy(batch["wave_lens"]), train=True)
    with torch.no_grad():
        _, codes, _ = port.forward_v2(torch.from_numpy(z), torch.from_numpy(batch["wave_seg"]),
                                      n_c=2)
    for got, want in zip(codes, aux[5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip((outs, *q, commit, cb, timbre),
                         (aux[0], *aux[1], aux[2], aux[3], aux[4])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    scalar = (torch.sum(outs * torch.from_numpy(w[0])) + torch.sum(q[0] * torch.from_numpy(w[1]))
              + torch.sum(q[1] * torch.from_numpy(w[2])) + torch.sum(q[2] * torch.from_numpy(w[3]))
              + torch.sum(timbre * torch.from_numpy(w[4])) + 3.0 * commit + 2.0 * cb)
    scalar.backward()
    assert_grad_close(zt.grad, np.asarray(jgz), "z")
    want = by_path(port, jgp)
    for name, p in port.named_parameters():
        assert_grad_close(p.grad, want[name], name)


def test_predictors_match_jax(jax_side):
    """`FApredictors.forward_v2`: every head's output and the gradients of
    a weighted sum, through the gradient-reversal branches."""
    fa = jax_side["models"]["fa_predictors"]
    params = jax_side["params"]["fa_predictors"]
    rng = np.random.default_rng(4)
    q = [rng.standard_normal((B, FRAMES, 64)).astype(np.float32) for _ in range(3)]
    timbre = rng.standard_normal((B, 64)).astype(np.float32)
    keys = ("f0", "uv", "content", "timbre", "rev_f0", "rev_uv", "rev_content", "x_timbre")

    def flat(preds, rev):
        return [dict(preds, **rev)[k] for k in keys]

    shapes = flat(*jax.eval_shape(lambda p, q, t: fa.apply({"params": p}, q, t),
                                  params, q, timbre))
    probe = [rng.standard_normal(o.shape).astype(np.float32) for o in shapes]

    def jfn(p, q, t):
        outs = flat(*fa.apply({"params": p}, q, t))
        return sum(jnp.sum(o * c) for o, c in zip(outs, probe)), outs

    (_, jouts), (jgp, jgq, jgt) = jax.jit(
        jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(params, q, timbre)
    port = port_models(jax_side["params"])["fa_predictors"]
    qt = [torch.from_numpy(a).requires_grad_(True) for a in q]
    tt = torch.from_numpy(timbre).requires_grad_(True)
    outs = flat(*port.forward_v2(qt, tt))
    for k, got, want in zip(keys, outs, jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=k, **TOL)
    sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, probe)).backward()
    for i, (got, want) in enumerate(zip(qt, jgq)):
        assert_grad_close(got.grad, np.asarray(want), f"quantized[{i}]")
    assert_grad_close(tt.grad, np.asarray(jgt), "timbre")
    want = by_path(port, jgp)
    for name, p in port.named_parameters():
        assert_grad_close(p.grad, want[name], name)


@pytest.mark.slow
def test_step_with_teacher_matches_jax(tmp_path):
    """The step with the JDC teacher inline, from a seeded reference-layout
    file that both packages' loaders read, against JAX's fused step with
    its `f0_teacher`: every loss within 2e-4 and every gradient as above
    (JAX's `tests/test_train_step.py::test_inline_f0_teacher_step` is slow
    too: it compiles the step with the teacher)."""
    from facodec_tpu.models.jdc import JDCNet as JJDCNet
    from facodec_tpu.models.jdc import load_jdc_checkpoint as j_load_jdc_checkpoint
    from facodec_tpu_torch.models.jdc import load_jdc_checkpoint, random_reference_state_dict

    path = str(tmp_path / "bst.t7")
    torch.save({"net": random_reference_state_dict(0)}, path)
    want = _jax_run((JJDCNet(), j_load_jdc_checkpoint(path)))
    models = port_models(want["params"])
    optimizers = build_optimizers(models, base_lr=1e-4)
    step = make_codec_train_step(models, optimizers, f0_teacher=load_jdc_checkpoint(path, "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
    metrics, grads = step(batch, torch.Generator().manual_seed(1))
    for k, v in want["metrics"].items():
        if k.startswith("loss/"):
            np.testing.assert_allclose(float(metrics[k]), v, err_msg=k, **TOL)
    for module in MODULES:
        ref = by_path(models[module], want["grads"][module])
        for name, g in zip(optimizers[module].names, grads[module]):
            assert_grad_close(g, ref[name], f"{module}.{name}")
