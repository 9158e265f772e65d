"""The port's training modules and losses against the JAX package's, on the CPU.

Each case runs a JAX function and its port on the same numpy inputs and the
same weights (drawn by the port's `init_random_`, perturbed, and read out as
a JAX parameter tree by key name), then takes the gradient of one random
weighting of every output on both sides (`jax.grad` against autograd).
Values are held in float32 at the golden tolerance, rtol = atol = 2e-4
(tests/test_model_parity.py); each gradient tensor within 2e-4 of its own
largest entry (plus 1e-7). The gradients are taken in float64 on both
sides (JAX under `jax.enable_x64`, its convs' output dtype patched from
the float32 policy's to float64 inside the case, the port's module in
double): at a kink
(a leaky ReLU's pre-activation within a float32 rounding of 0) or where a
log meets a near-zero STFT bin, two float32 evaluations that agree to 1e-7
take gradients a whole derivative step apart, and which side each lands on
is the rounding's; in float64 they agree. The RVQ's gradients are taken in
float32: its code search casts to float32, and it has no kink. Feature
maps of the port's discriminators are NCHW, the JAX package's NHWC: the
port's are transposed before the comparison.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.losses import spectral as j_spectral
from facodec_tpu.losses.gan import discriminator_loss as j_disc_loss
from facodec_tpu.losses.gan import generator_adv_losses as j_gen_adv
from facodec_tpu.losses.supervision import (cross_entropy as j_ce, focal_loss as j_focal,
                                            log_norm as j_log_norm,
                                            smooth_l1_loss as j_smooth_l1)
from facodec_tpu.models.discriminator import MPD as JMPD
from facodec_tpu.models.discriminator import MRD as JMRD
from facodec_tpu.models.discriminator import Discriminator as JDiscriminator
from facodec_tpu.models.fa_quantizer import CNNLSTM as JCNNLSTM
from facodec_tpu.models.quantize import ResidualVectorQuantize as JRVQ
from facodec_tpu.nn import conv as j_conv
from facodec_tpu.nn.activations import SnakeBeta as JSnakeBeta
from facodec_tpu.nn.alias_free import Activation1d as JActivation1d
from facodec_tpu.nn.alias_free import kaiser_sinc_filter1d as j_kaiser
from facodec_tpu.ops.gradrev import gradient_reversal as j_gradrev
from facodec_tpu.train.targets import normalize_f0 as j_normalize_f0
from facodec_tpu_torch import losses as p_losses
from facodec_tpu_torch.models.discriminator import MPD, MRD, Discriminator
from facodec_tpu_torch.models.fa_quantizer import CNNLSTM
from facodec_tpu_torch.models.quantize import ResidualVectorQuantize
from facodec_tpu_torch.nn.activations import SnakeBeta
from facodec_tpu_torch.nn.alias_free import Activation1d, kaiser_sinc_filter1d
from facodec_tpu_torch.ops.gradrev import gradient_reversal
from facodec_tpu_torch.train.targets import normalize_f0
from facodec_tpu_torch.utils.weights import flatten_tree, init_random_, torch_key_to_path

TOL = dict(rtol=2e-4, atol=2e-4)


def seeded(module, seed=0, jitter=0.05):
    """The port module with seeded random weights, each moved by a little
    noise (so that no parameter sits at a special value such as 0 or 1)."""
    gen = torch.Generator().manual_seed(seed)
    init_random_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(jitter * torch.randn(p.shape, generator=gen))
    return module


def jax_tree(module):
    tree = {}
    for name, p in module.named_parameters():
        *parents, leaf = torch_key_to_path(name)
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return tree


def grad_close(got, want, name):
    want = np.asarray(want, np.float64)
    got = np.zeros_like(want) if got is None else got.detach().double().numpy()
    bound = 2e-4 * np.abs(want).max() + 1e-7
    err = np.abs(got - want).max()
    assert err <= bound, f"{name}: max err {err:.3e} > {bound:.3e}"


def _run(jfun, pfun, args, port, probes, dtype, grads=True):
    """Outputs and (with `grads`) gradients of both sides at `dtype`."""
    params = jax.tree.map(lambda a: a.astype(dtype), jax_tree(port)) if port is not None else {}
    jargs = [jnp.asarray(a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a)
             for a in args]
    floats = tuple(i + 1 for i, a in enumerate(args) if np.issubdtype(a.dtype, np.floating))

    def scalar(p, *a):
        outs = jfun(p, *a)
        return sum(jnp.sum(o * c.astype(o.dtype)) for o, c in zip(outs, probes)), outs

    if not grads:
        jouts = jax.jit(jfun)(params, *jargs)
        with torch.no_grad():
            return pfun(port, *[torch.from_numpy(np.array(a)) for a in jargs]), jouts, {}
    (_, jouts), jgrads = jax.jit(jax.value_and_grad(scalar, argnums=(0,) + floats,
                                                    has_aux=True))(params, *jargs)
    module = None
    if port is not None:
        module = copy.deepcopy(port).to(torch.float64 if dtype == np.float64 else torch.float32)
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    for i in floats:
        targs[i - 1].requires_grad_(True)
    pouts = pfun(module, *targs)
    sum(torch.sum(o * torch.from_numpy(c).to(o.dtype)) for o, c in zip(pouts, probes)).backward()
    grads = {f"arg {i - 1}": (targs[i - 1].grad, g) for i, g in zip(floats, jgrads[1:])}
    if module is not None:
        flat = flatten_tree(jgrads[0])
        grads.update({name: (p.grad, flat[torch_key_to_path(name)])
                      for name, p in module.named_parameters()})
    return pouts, jouts, grads


def check(jfun, pfun, args, port=None, seed=1, grad_dtype=np.float64, grads=True):
    """jfun(params, *args) and pfun(module, *tensors) each return a list of
    outputs; compare them in float32, then, at `grad_dtype`, the gradients
    (for every float argument and every parameter of `port`) of a random
    weighting of the outputs."""
    params = jax_tree(port) if port is not None else {}
    shapes = jax.eval_shape(jfun, params, *[jnp.asarray(a) for a in args])
    rng = np.random.default_rng(seed)
    probes = [rng.standard_normal(s.shape).astype(np.float32) for s in shapes]
    pouts, jouts, got = _run(jfun, pfun, args, port, probes, np.float32,
                             grads and grad_dtype == np.float32)
    assert len(pouts) == len(jouts)
    for k, (o, want) in enumerate(zip(pouts, jouts)):
        assert tuple(o.shape) == tuple(want.shape), k
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), err_msg=str(k), **TOL)
    if not grads:
        return pouts
    if grad_dtype == np.float64:
        # the JAX convs return the precision policy's float32: keep float64
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_conv, "out_dtype", lambda: jnp.float64)
            got = _run(jfun, pfun, args, port, probes, np.float64)[2]
    for name, (g, want) in got.items():
        grad_close(g, want, name)
    return pouts


def waves(shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def nhwc(fmaps):
    return [f.permute(0, 2, 3, 1) for f in fmaps]


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_gradient_reversal(alpha):
    x = waves((2, 5, 3))
    out = check(lambda p, x: [j_gradrev(x, alpha) * 1.0],
                lambda m, x: [gradient_reversal(x, alpha)], [x])
    np.testing.assert_array_equal(out[0].detach().numpy(), x)


@pytest.mark.parametrize("logscale", [True, False])
def test_snake_beta(logscale):
    port = seeded(SnakeBeta(6, logscale))
    mod = JSnakeBeta(6, logscale)
    check(lambda p, x: [mod.apply({"params": p}, x)], lambda m, x: [m(x)],
          [waves((2, 11, 6), scale=2.0)], port)


def test_kaiser_sinc_filter():
    for args in ((0.25, 0.3, 12), (0.5, 0.6, 12), (0.25, 0.3, 13), (0.0, 0.3, 12)):
        np.testing.assert_array_equal(kaiser_sinc_filter1d(*args), j_kaiser(*args))


def test_activation1d():
    port = seeded(Activation1d(6))
    mod = JActivation1d(snake_features=6)
    check(lambda p, x: [mod.apply({"params": p}, x)], lambda m, x: [m(x)],
          [waves((2, 13, 6), scale=1.0)], port)


@pytest.mark.parametrize("global_pred", [False, True], ids=["local", "global"])
def test_cnnlstm(global_pred):
    port = seeded(CNNLSTM(8, 5, 2, global_pred=global_pred))
    mod = JCNNLSTM(8, 5, 2, global_pred=global_pred)
    check(lambda p, x: mod.apply({"params": p}, x), lambda m, x: m(x),
          [waves((2, 9, 8), scale=1.0)], port)


@pytest.mark.parametrize("which", ["mpd", "mrd"])
def test_single_discriminator(which):
    port, mod = (seeded(MPD(3)), JMPD(3)) if which == "mpd" else (
        seeded(MRD(512, sample_rate=24000)), JMRD(512, sample_rate=24000))
    check(lambda p, x: mod.apply({"params": p}, x), lambda m, x: nhwc(m(x)),
          [waves((2, 600, 1))], port)


def test_discriminator_ensemble():
    port = seeded(Discriminator(periods=(2,), fft_sizes=(512,), sample_rate=24000))
    mod = JDiscriminator(rates=(), periods=(2,), fft_sizes=(512,), sample_rate=24000)

    def jfun(p, x):
        return [f for fm in mod.apply({"params": p}, x) for f in fm]

    check(jfun, lambda m, x: [f for fm in m(x) for f in nhwc(fm)], [waves((2, 600, 1))], port)


def test_train_rvq_matches_jax():
    """Train-mode RVQ with the quantizer dropout at 0: codes bit-exact, the
    output, both losses and the gradients (the codebooks' through the code
    search) at the golden tolerance."""
    port = seeded(ResidualVectorQuantize(16, 3, 32, 4, quantizer_dropout=0.0))
    mod = JRVQ(input_dim=16, n_codebooks=3, codebook_size=32, codebook_dim=4,
               quantizer_dropout=0.0)
    z = waves((2, 7, 16), scale=1.0)
    codes = {}

    def jfun(p, z):
        z_q, c, _, commit, cb = mod.apply({"params": p}, z, train=True,
                                          rngs={"dropout": jax.random.PRNGKey(0)})
        codes["jax"] = c
        return [z_q, commit, cb]

    def pfun(m, z):
        z_q, c, commit, cb = m.forward_train(z)
        codes["port"] = c
        return [z_q, commit, cb]

    check(jfun, pfun, [z], port, grad_dtype=np.float32)
    _, want, *_ = mod.apply({"params": jax_tree(port)}, jnp.asarray(z), train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})
    np.testing.assert_array_equal(codes["port"].numpy(), np.asarray(want))


LOSSES = {
    "mel": (lambda a, b: j_spectral.mel_spectrogram_loss(a, b),
            lambda a, b: p_losses.mel_spectrogram_loss(a, b)),
    "stft": (lambda a, b: j_spectral.multi_scale_stft_loss(a, b),
             lambda a, b: p_losses.multi_scale_stft_loss(a, b)),
    "l1": (j_spectral.l1_loss, p_losses.l1_loss),
    "sisdr": (j_spectral.sisdr_loss, p_losses.sisdr_loss),
    "smooth_l1": (j_smooth_l1, p_losses.smooth_l1_loss),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_wave_losses(name):
    jf, pf = LOSSES[name]
    a, b = waves((2, 4800), 1), waves((2, 4800), 2)
    check(lambda p, a, b: [jf(a, b)], lambda m, a, b: [pf(a, b)], [a, b])


def test_gan_losses():
    shapes = [(2, 5, 3, 4), (2, 7, 2, 1), (2, 6, 4), (2, 3, 1)]
    fake = [waves(s, i) for i, s in enumerate(shapes)]
    real = [waves(s, 10 + i) for i, s in enumerate(shapes)]

    def split(x):
        return [x[:2], x[2:]]

    def jfun(p, *maps):
        f, r = split(list(maps[:4])), split(list(maps[4:]))
        return [j_disc_loss(f, r), *j_gen_adv(f, r)]

    def pfun(m, *maps):
        f, r = split(list(maps[:4])), split(list(maps[4:]))
        return [p_losses.discriminator_loss(f, r), *p_losses.generator_adv_losses(f, r)]

    check(jfun, pfun, fake + real)


@pytest.mark.parametrize("name", ["cross_entropy", "focal"])
def test_classification_losses(name):
    jf, pf = (j_ce, p_losses.cross_entropy) if name == "cross_entropy" else (
        j_focal, p_losses.focal_loss)
    logits = waves((2, 6, 11), scale=2.0)
    labels = np.random.default_rng(5).integers(0, 11, (2, 6)).astype(np.int32)
    check(lambda p, x, y: [jf(x, y)], lambda m, x, y: [pf(x, y)], [logits, labels])


def test_log_norm():
    check(lambda p, x: [j_log_norm(x)], lambda m, x: [p_losses.log_norm(x)],
          [waves((2, 6, 80), scale=0.5)])


def test_normalize_f0():
    """Values only: the targets take no gradient (and the JAX function's
    masked log2 has NaN partials at the unvoiced frames)."""
    f0 = np.abs(np.random.default_rng(3).standard_normal((3, 16))).astype(np.float32) * 150
    f0[1] = 0.0  # unvoiced throughout
    f0[2, ::2] = 0.0  # half voiced
    # (no row with one voiced frame: there the JAX function divides the
    # rounding residue of log_f0 - mean by 1e-10, and two compilations of it
    # give 0 and 187.8 for that frame; the torch reference gives -10)
    check(lambda p, f: [j_normalize_f0(f)], lambda m, f: [normalize_f0(f)], [f0], grads=False)
