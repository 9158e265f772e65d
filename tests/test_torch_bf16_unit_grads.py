"""Gradients of the bf16 residual-unit ops on the CPU, through the dispatcher.

`facodec::resunit_bf16` and `facodec::resunit_bf16_f32io` (both I/O forms)
carry gradients (`register_autograd`): the backward recomputes the plain
composition under the form's policy from the saved pack, and the pack is
differentiable (`resunit.pack_bf16`), so the gradients reach the float32
effective weights, biases and alphas through the bf16 rounding. Called on
CPU tensors, the ops run their CPU implementations, as a program exported on
the CPU runs them; the gradients must equal the eager plain composition's
autograd on the float32 weights (the route a CPU training step takes), and
the ops pass `torch.library.opcheck` with inputs that want gradients.
"""

import json
import os

import pytest
import torch

from facodec_tpu_torch.__main__ import main as cli
from facodec_tpu_torch.ops.kernels import resunit
from facodec_tpu_torch.ops.precision import policy

ROUTES = ("bf16", "f32io", "f32io_act")
NAMES = ("x", "w7", "b7", "w1", "b1", "alpha1", "alpha2")


def _unit(C=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(C, C, 7, generator=g) / 15, 0.1 * torch.randn(C, generator=g),
            torch.randn(C, C, 1, generator=g) / 6, 0.1 * torch.randn(C, generator=g),
            0.5 + torch.rand(1, C, 1, generator=g), 0.5 + torch.rand(1, C, 1, generator=g))


def _x(route, B=2, T=40, C=32, seed=1):
    x = torch.randn(B, T, C, generator=torch.Generator().manual_seed(seed))
    return x.bfloat16() if route == "bf16" else x


def _op_call(route, x, w, dilation, causal):
    """The form's op on a pack made from the float32 weights (autograd on)."""
    pack = resunit.make_pack(route, *w)
    if route == "bf16":
        return torch.ops.facodec.resunit_bf16(x, *pack, dilation, causal)
    return torch.ops.facodec.resunit_bf16_f32io(x, *pack, dilation, causal, route == "f32io_act")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("dilation", [1, 9])
@pytest.mark.parametrize("route", ROUTES)
def test_op_gradients_equal_plain_autograd(route, dilation, causal):
    """x, both weights, both biases and both alphas: the op's gradients
    (through the differentiable pack) equal the plain composition's under
    the form's policy, bit for bit; every one is float32 but x's, which has
    x's dtype."""
    w = _unit()
    x = _x(route)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(x.dtype)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
        out = fn(leaves[0], leaves[1:])
        return out, torch.autograd.grad(out, leaves, cot)

    got, g_op = grads(lambda x, w: _op_call(route, x, w, dilation, causal))
    want, g_plain = grads(lambda x, w: resunit.residual_unit_reference(
        x, *w, dilation, causal, resunit.ROUTE_POLICY[route]))
    assert torch.equal(got, want)
    for name, a, b in zip(NAMES, g_op, g_plain):
        assert a.dtype == (x.dtype if name == "x" else torch.float32), name
        assert torch.equal(a, b), (name, (a - b).abs().max())
        assert a.abs().max() > 0, name


@pytest.mark.parametrize("route", ROUTES)
def test_wrapper_trains_on_the_cpu(route):
    """`fused_residual_unit` under the form's policy on the CPU (the plain
    composition) gives the op's gradients: the CPU training step's route and
    the card's agree on what they compute."""
    w = _unit(seed=3)
    x = _x(route, seed=4)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(x.dtype)
    out = {}
    for kind in ("wrapper", "op"):
        leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
        with policy(resunit.ROUTE_POLICY[route]):
            y = (resunit.fused_residual_unit(leaves[0], *leaves[1:], 3, True) if kind == "wrapper"
                 else _op_call(route, leaves[0], leaves[1:], 3, True))
        out[kind] = torch.autograd.grad(y, leaves, cot)
    for name, a, b in zip(NAMES, out["wrapper"], out["op"]):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("route", ("f32",) + ROUTES)
def test_op_gradients_under_checkpoint(route):
    """Inside a non-reentrant `checkpoint` (a `remat` step) the ops'
    backward unpacks its saved tensors once, as the checkpoint requires,
    and gives the gradients of the call without it."""
    from torch.utils.checkpoint import checkpoint

    w = _unit(seed=6)
    x = _x("f32io" if route == "f32" else route, seed=7)

    def call(x, *w):
        if route == "f32":
            return torch.ops.facodec.resunit_f32(x, *w, 3, True)
        return _op_call(route, x, w, 3, True)

    out = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
        y = (checkpoint(call, *leaves, use_reentrant=False) if remat else call(*leaves))
        out.append(torch.autograd.grad(y.float().sum(), leaves))
    for name, a, b in zip(NAMES, *out):
        assert torch.equal(a, b), name


def _grad(*ts):
    return tuple(t.detach().clone().requires_grad_(True) for t in ts)


OPCHECK_CASES = {
    "bf16": lambda: (torch.ops.facodec.resunit_bf16.default,
                     (*_grad(_x("bf16"), *resunit.pack_bf16(*_unit())), 3, False)),
    "bf16_causal": lambda: (torch.ops.facodec.resunit_bf16.default,
                            (*_grad(_x("bf16", T=20), *resunit.pack_bf16(*_unit())), 9, True)),
    "f32io": lambda: (torch.ops.facodec.resunit_bf16_f32io.default,
                      (*_grad(_x("f32io"), *resunit.pack_bf16(*_unit(), torch.float32)), 3,
                       True, False)),
    "f32io_act": lambda: (torch.ops.facodec.resunit_bf16_f32io.default,
                          (*_grad(_x("f32io"), *resunit.pack_bf16(*_unit(), torch.float32)), 9,
                           False, True)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_opcheck_with_gradients(case):
    """Schema, fake, autograd registration and the traced forward and
    backward, with every tensor input wanting a gradient."""
    op, args = OPCHECK_CASES[case]()
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_pack_is_differentiable():
    """The pack passes gradients to the effective weights, biases and alphas
    (the reciprocals, which the plain composition forms from the alphas, get
    none of their own)."""
    leaves = [t.clone().requires_grad_(True) for t in _unit()]
    pack = resunit.pack_bf16(*leaves)
    for name in ("w7", "w1", "b7", "b1", "alpha1", "alpha2"):
        assert getattr(pack, name).requires_grad, name
    with torch.no_grad():
        kept = resunit.pack_bf16(*leaves)
    assert not any(t.requires_grad for t in kept)
    for a, b in zip(pack, kept):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("env,name", [("bfloat16", "bfloat16"), ("bf16_act", "bfloat16_act")])
def test_bench_train_runs_the_policy(env, name, capsys, monkeypatch):
    """`bench train` under FACODEC_TRAIN_PRECISION trains in that policy and
    its JSON line names it; an int8 policy is refused as the step refuses
    it."""
    tiny = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny_config.yml")
    args = ["bench", "train", "--device", "cpu", "--config-path", tiny, "--fast", "--batch",
            "1", "--seg-frames", "4"]
    monkeypatch.setenv("FACODEC_TRAIN_PRECISION", env)
    result = cli(args)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert json.loads(lines[-1]) == result
    assert result["precision"] == name and result["value"] > 0
    monkeypatch.setenv("FACODEC_TRAIN_PRECISION", "int8")
    with pytest.raises(ValueError, match="inference-only"):
        cli(args)
