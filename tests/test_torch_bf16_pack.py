"""The bf16 entry's packed operands (`ops.kernels.resunit.pack_bf16`) and the
pack that `models.dac.ResidualUnit` keeps across calls, on the CPU: the
packed tensors are the per-call operands bit for bit, a kept pack is reused
until a parameter changes, and nothing is packed where the bf16 entry does
not run (gradients enabled, training, float32 activations, and any forward
on the CPU, which runs the plain version)."""

import numpy as np
import pytest
import torch

from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.ops.kernels import resunit
from facodec_tpu_torch.ops.precision import policy


def _unit(C: int, dilation: int, causal: bool, seed: int = 0) -> ResidualUnit:
    rng = np.random.default_rng(seed)
    unit = ResidualUnit(C, dilation=dilation, causal=causal)
    with torch.no_grad():
        for p in unit.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.standard_normal(p.shape).astype(np.float32)))
        for snake in (unit.block[0], unit.block[2]):
            snake.alpha.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, (1, C, 1)).astype(np.float32)))
    return unit.eval()


def _x(B: int, T: int, C: int, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).bfloat16()


def _weights(unit: ResidualUnit):
    snake1, conv7, snake2, conv1 = unit.block
    return (conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
            snake1.alpha, snake2.alpha)


def _kept(unit: ResidualUnit, x: torch.Tensor):
    """The pack the unit's card forward would read for x: `kept_pack` of the
    kernel form `unit_route` picks under the current policy."""
    return unit.kept_pack(x, resunit.unit_route(x.dtype, x.shape[-1]))


PACKED = ("w7", "w1", "b7", "b1", "alpha1", "recip1", "alpha2", "recip2")


def _same_pack(a: resunit.Bf16Pack, b: resunit.Bf16Pack) -> bool:
    return all(torch.equal(getattr(a, name), getattr(b, name)) for name in PACKED)


@pytest.mark.parametrize("C", [32, 96])
def test_pack_equals_per_call_operands(C):
    """The kept pack holds w7 as (out, tap * C + in), w1, the biases in bf16,
    the alphas and their snake reciprocals, bit for bit as they are made
    from the effective weights for one call."""
    unit = _unit(C, 3, True)
    with torch.no_grad():
        pack = _kept(unit, _x(1, 8, C))
        w7, b7, w1, b1, a1, a2 = _weights(unit)
        assert torch.equal(pack.w7, w7.permute(0, 2, 1).to(torch.bfloat16).reshape(C, 7 * C))
        assert torch.equal(pack.w1, w1[:, :, 0].to(torch.bfloat16))
        assert torch.equal(pack.b7, b7.to(torch.bfloat16))
        assert torch.equal(pack.b1, b1.to(torch.bfloat16))
        for got, alpha in ((pack.alpha1, a1), (pack.alpha2, a2)):
            assert torch.equal(got, alpha.reshape(C))
        for got, alpha in ((pack.recip1, a1), (pack.recip2, a2)):
            assert torch.equal(got, (1.0 / (alpha + 1e-9)).reshape(C))
        fresh = resunit.pack_bf16(*_weights(unit))
    for name in PACKED:
        assert torch.equal(getattr(pack, name), getattr(fresh, name)), name
    # the pack is the op's operands and nothing else: the TMA maps are
    # encoded by the op's CUDA implementation
    assert pack._fields == PACKED


@pytest.mark.parametrize("C,dilation,causal,T", [(32, 1, True, 40), (64, 9, True, 20),
                                                 (96, 3, False, 33), (64, 9, False, 1)])
def test_cpu_forward_keeps_no_pack(C, dilation, causal, T):
    """On the CPU a unit's bf16 forward is the plain version under the
    bfloat16_act policy, the bits of `fused_residual_unit`, and packs
    nothing: only the card's kernel reads a pack."""
    unit = _unit(C, dilation, causal)
    x = _x(2, T, C)
    with torch.no_grad(), policy("bfloat16_act"):
        got = unit(x)
        want = resunit.fused_residual_unit(x, *_weights(unit), dilation, causal)
    assert not unit._packs
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_second_call_reuses_the_pack():
    unit = _unit(64, 1, True)
    x = _x(1, 16, 64)
    with torch.no_grad():
        first = _kept(unit, x)
        assert _kept(unit, x[:, :5]) is first
        assert _kept(unit, x) is first


@pytest.mark.parametrize("which", ["weight_v", "weight_g", "bias", "alpha", "conv1x1"])
def test_in_place_update_repacks(which):
    """An in-place update of any parameter (an optimizer step, a loaded
    state dict) bumps its version: the next call packs anew, from the new
    values."""
    unit = _unit(32, 3, True)
    x = _x(1, 12, 32)
    snake1, conv7, snake2, conv1 = unit.block
    param = {"weight_v": conv7.weight_v, "weight_g": conv7.weight_g, "bias": conv7.bias,
             "alpha": snake2.alpha, "conv1x1": conv1.weight_v}[which]
    with torch.no_grad():
        first = _kept(unit, x)
        param.add_(0.25)  # weight norm makes a scale of weight_v a no-op
        second = _kept(unit, x)
        want = resunit.pack_bf16(*_weights(unit))
        again = _kept(unit, x)
    assert second is not first and again is second
    assert not _same_pack(first, second)
    assert _same_pack(second, want)


def test_load_state_dict_repacks():
    unit, other = _unit(32, 1, True, seed=0), _unit(32, 1, True, seed=5)
    x = _x(1, 10, 32)
    with torch.no_grad():
        first = _kept(unit, x)
        unit.load_state_dict(other.state_dict())
        got = _kept(unit, x)
        want = _kept(other, x)
    assert got is not first
    assert _same_pack(got, want)


@pytest.mark.parametrize("case", ["grad", "training", "float32"])
def test_nothing_packed_where_the_entry_does_not_run(case):
    """The bf16 entry is forward only: with gradients enabled or in training
    the unit packs nothing (and float32 activations under the float32
    policy take the float32 entry)."""
    unit = _unit(32, 1, True)
    x = _x(1, 10, 32)
    if case == "float32":
        x = x.float()
    if case == "training":
        unit.train()
    pol = "float32" if case == "float32" else "bfloat16_act"
    with torch.set_grad_enabled(case == "grad"), policy(pol):
        assert _kept(unit, x) is None
        unit(x)
    assert not unit._packs


@pytest.mark.parametrize("fault,error,match", [
    ("float32_x", TypeError, "x must be"), ("width", ValueError, "pack.w7 has shape"),
    ("dtype", TypeError, "pack.w1 must be"), ("not_contiguous", ValueError, "contiguous"),
    ("cpu", ValueError, "card only")])
def test_packed_entry_checks_its_operands(fault, error, match):
    """The packed entry checks x and every packed operand before it runs,
    and it runs on the card only: a sound pack on the CPU is refused too."""
    C = 32
    unit = _unit(C, 1, True)
    x = _x(1, 10, C)
    with torch.no_grad():
        pack = _kept(unit, x)
        if fault == "float32_x":
            x = x.float()
        elif fault == "width":
            pack = resunit.pack_bf16(*_weights(_unit(64, 1, True)))
        elif fault == "dtype":
            pack = pack._replace(w1=pack.w1.float())
        elif fault == "not_contiguous":
            pack = pack._replace(w7=pack.w7.t().contiguous().t())
        with pytest.raises(error, match=match):
            resunit.fused_residual_unit_packed(x, pack, 1, True)
