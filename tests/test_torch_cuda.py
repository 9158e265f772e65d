"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips where torch sees no CUDA device. This file
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch

from facodec_tpu_torch.api import FACodec, FARedecoder, convert_voice, float32_exact
from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.kernels import resunit, vq
from facodec_tpu_torch.utils.signals import sweep_wave

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# Every flagship width at d = 1 and 9, batch 4: T = 50 is shorter than one
# time tile (64 or 128 rows) and, at d = 9, than the 54-row pad (pad1d's
# zero-extend); T = 1000 leaves a ragged last tile for both tile heights.
FLAGSHIP_CASES = [(4, C, d, T) for C in (64, 96, 128, 192, 256, 384, 512, 768)
                  for d, T in ((1, 1000), (9, 50), (9, 1000))]
# The redecoder's non-causal decoder widths at d = 9 around its (27, 27)
# pad: T = 20 and 27 zero-extend to 28 rows before the reflect, T = 28 does not.
SHORT_CASES = [(4, C, 9, T) for C in (96, 768) for T in (20, 27, 28)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,C,dilation,T", [(2, 32, 3, 500), (2, 64, 1, 1000), (2, 96, 9, 777),
                                            (2, 192, 3, 40), (2, 768, 9, 1000)]
                         + FLAGSHIP_CASES + SHORT_CASES)
def test_resunit_kernel_matches_plain(B, C, dilation, T, causal):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(C + dilation)
    x = torch.randn(B, T, C, device="cuda", generator=g)
    w7 = torch.randn(C, C, 7, device="cuda", generator=g) / (7 * C) ** 0.5
    w1 = torch.randn(C, C, 1, device="cuda", generator=g) / C ** 0.5
    b7, b1 = (0.1 * torch.randn(C, device="cuda", generator=g) for _ in range(2))
    a1, a2 = (0.5 + torch.rand(1, C, 1, device="cuda", generator=g) for _ in range(2))
    args = (x, w7, b7, w1, b1, a1, a2, dilation, causal)
    before = resunit.fused_residual_unit.launches
    with float32_exact():
        want = resunit.residual_unit_reference(*args)
        got = resunit.fused_residual_unit(*args)
    assert resunit.fused_residual_unit.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_resunit_kernel_rejects_odd_width():
    _need_cuda()
    C = 48
    args = [torch.zeros(1, 100, C, device="cuda"), torch.zeros(C, C, 7, device="cuda"),
            torch.zeros(C, device="cuda"), torch.zeros(C, C, 1, device="cuda"),
            torch.zeros(C, device="cuda"), torch.ones(1, C, 1, device="cuda"),
            torch.ones(1, C, 1, device="cuda")]
    with pytest.raises(ValueError):
        resunit.fused_residual_unit(*args, dilation=1, causal=True)


# The bf16 entry (the hybrid decode's units): every flagship width and
# dilation, causal and not, batch 1 and 4, T = 1 and 53 (below the 54-row pad
# at d = 9: pad1d's zero-extend) and 4800 (many tiles, a ragged last one).
BF16_CASES = [(B, C, d, T) for C in (64, 96, 128, 192, 256, 384, 512, 768) for d in (1, 3, 9)
              for B in (1, 4) for T in (1, 53, 4800)]
BF16_MAX_ULPS = 2


def _bf16_unit_args(B, C, dilation, T, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, C, device="cuda", generator=g).to(torch.bfloat16)
    w7 = torch.randn(C, C, 7, device="cuda", generator=g) / (7 * C) ** 0.5
    w1 = torch.randn(C, C, 1, device="cuda", generator=g) / C ** 0.5
    b7, b1 = (0.1 * torch.randn(C, device="cuda", generator=g) for _ in range(2))
    a1, a2 = (0.5 + torch.rand(1, C, 1, device="cuda", generator=g) for _ in range(2))
    return x, w7, b7, w1, b1, a1, a2


def _check_bf16_entry(args, dilation, causal):
    """One bf16 launch and no float32 one; no element more than 2 bf16 ulps
    (at resunit.bf16_error_scale) from the plain version under the
    bfloat16_act policy. Prints the bit-equal share."""
    x = args[0]
    args = (*args, dilation, causal)
    before = (resunit.fused_residual_unit.launches, resunit.fused_residual_unit.bf16_launches)
    with float32_exact():
        got = resunit.fused_residual_unit(*args)
        torch.cuda.synchronize()
        assert (resunit.fused_residual_unit.launches,
                resunit.fused_residual_unit.bf16_launches) == (before[0], before[1] + 1)
        want = resunit.residual_unit_reference(*args)
        scale = resunit.bf16_error_scale(*args)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == x.shape
    ulps = resunit.bf16_ulps(got, want, scale)
    equal = (got == want).float().mean().item()
    print(f"{tuple(x.shape)} d={dilation} causal={causal}: {equal:.4%} bit-equal, worst "
          f"{ulps.max().item():.2f} ulps")
    assert ulps.max().item() <= BF16_MAX_ULPS, ulps.max().item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,C,dilation,T", BF16_CASES)
def test_resunit_bf16_entry_matches_plain(B, C, dilation, T, causal):
    _need_cuda()
    _check_bf16_entry(_bf16_unit_args(B, C, dilation, T, C + dilation + T), dilation, causal)


# The regimes of the wgmma kernel's tiling (csrc/resunit_bf16.cu): T at the
# edges of its 64- and 128-row tiles (C = 768 takes 64 rows, C = 96 and 192
# 128); fewer row tiles than SMs and many more; batch 8; the hybrid decode's
# largest unit (C = 96, T = 240,000, weights resident) and its widest at
# d = 9, non-causal; widths past the flagship's (C = 1024 with 64-wide weight
# slices, 1280 with 32-wide ones) and ragged N tiles (C = 160, 544).
BF16_TILING_CASES = (
    [(2, C, 3, T, True) for C in (96, 192, 768) for T in (63, 64, 65, 127, 128, 129)]
    + [(1, 384, 9, 300, True), (2, 192, 1, 40000, False), (8, 192, 1, 500, True),
       (8, 768, 3, 129, False), (8, 96, 9, 1000, True), (4, 96, 1, 240000, True),
       (4, 768, 9, 4800, False), (2, 1024, 9, 70, True), (1, 1280, 3, 100, False),
       (3, 160, 3, 300, True), (2, 544, 1, 130, False)])


@pytest.mark.parametrize("B,C,dilation,T,causal", BF16_TILING_CASES)
def test_resunit_bf16_entry_tiling(B, C, dilation, T, causal):
    _need_cuda()
    _check_bf16_entry(_bf16_unit_args(B, C, dilation, T, 7 * C + dilation + T), dilation, causal)


# Units too wide for a 64-row s2 tile beside two weight stages in shared
# memory: s2 goes through the device scratch (C >= 1440 at d = 9). The last
# width that fits at d = 9, the first that does not, and C = 2048 over more
# row tiles than SMs (a CTA takes two tiles through the scratch).
BF16_WIDE_CASES = [(1, 1408, 9, 200, True, False), (2, 1440, 9, 300, False, True),
                   (1, 2048, 1, 9000, True, True)]


@pytest.mark.parametrize("B,C,dilation,T,causal,spill", BF16_WIDE_CASES)
def test_resunit_bf16_entry_wide(B, C, dilation, T, causal, spill):
    _need_cuda()
    plan = resunit.bf16_plan(B, T, C, dilation)
    assert plan["spill"] == spill, plan
    _check_bf16_entry(_bf16_unit_args(B, C, dilation, T, C + dilation + T), dilation, causal)


def test_resunit_bf16_packed_after_in_place_update():
    """A ResidualUnit under bfloat16_act keeps its packed operands across
    calls (and their TMA maps stay encoded, per address); an in-place weight
    update repacks, and the kernel then follows the new weights. One bf16
    launch a call; the packed call gives the unpacked entry's bits."""
    from facodec_tpu_torch.models.dac import ResidualUnit
    from facodec_tpu_torch.ops.precision import policy
    _need_cuda()
    C, d = 192, 3
    torch.manual_seed(0)
    unit = ResidualUnit(C, dilation=d, causal=True).cuda().eval()
    with torch.no_grad():
        for prm in unit.parameters():
            prm.copy_(0.1 * torch.randn_like(prm) + (1.0 if prm.shape == (1, C, 1) else 0.0))
    x = _bf16_unit_args(2, C, d, 500, 1)[0]
    with torch.no_grad(), float32_exact(), policy("bfloat16_act"):
        for step in range(2):
            before = resunit.fused_residual_unit.bf16_launches
            got = unit(x)
            torch.cuda.synchronize()
            assert resunit.fused_residual_unit.bf16_launches == before + 1
            pack = unit.kept_pack(x, "bf16")
            assert resunit.tma_maps(pack.w7, pack.w1) is resunit.tma_maps(pack.w7, pack.w1)
            snake1, conv7, snake2, conv1 = unit.block
            args = (conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
                    snake1.alpha, snake2.alpha)
            assert torch.equal(got, resunit.fused_residual_unit(x, *args, d, True))
            _check_bf16_entry((x, *args), d, True)
            conv7.weight_v.add_(0.05 * torch.randn_like(conv7.weight_v))
            conv1.bias.add_(0.3)
        assert unit.kept_pack(x, "bf16") is not pack


@pytest.mark.parametrize("fault", ["strided", "float16", "weight_bf16"])
def test_resunit_bf16_entry_rejects(fault):
    _need_cuda()
    C = 64
    x = torch.zeros(2, 100, C, device="cuda", dtype=torch.bfloat16)
    w7, w1 = torch.zeros(C, C, 7, device="cuda"), torch.zeros(C, C, 1, device="cuda")
    if fault == "strided":
        x = torch.zeros(2, 100, 2 * C, device="cuda", dtype=torch.bfloat16)[:, :, ::2]
    elif fault == "float16":
        x = x.half()
    else:
        w7 = w7.to(torch.bfloat16)
    args = [x, w7, torch.zeros(C, device="cuda"), w1, torch.zeros(C, device="cuda"),
            torch.ones(1, C, 1, device="cuda"), torch.ones(1, C, 1, device="cuda")]
    before = resunit.fused_residual_unit.bf16_launches
    with pytest.raises(ValueError if fault == "strided" else TypeError):
        resunit.fused_residual_unit(*args, dilation=1, causal=True)
    assert resunit.fused_residual_unit.bf16_launches == before


# ------------------------------------------ float32-in/out forms and int8 unit
def _f32_unit_args(B, C, dilation, T, seed):
    x, *w = _bf16_unit_args(B, C, dilation, T, seed)
    return (x.float() * 1.3, *w)


def _check_packed_form(route, args, dilation, causal):
    """One launch of `route`'s kernel on its pack, against the plain version
    under its policy: float32 out, no element more than 2 bf16 ulps (at
    resunit.bf16_error_scale) off; for the int8 unit, its row maxima, its
    quantized padded input and its conv7 output bit-equal."""
    x, w = args[0], args[1:]
    pack = resunit.make_pack(route, *w)
    counter = {"f32io": "f32io_launches", "f32io_act": "f32io_act_launches",
               "int8": "int8_launches"}[route]
    before = getattr(resunit.fused_residual_unit, counter)
    with torch.no_grad(), float32_exact():
        got = resunit.run_packed(route, x, pack, dilation, causal)
        torch.cuda.synchronize()
        assert getattr(resunit.fused_residual_unit, counter) == before + 1
        if route == "int8":
            amax = resunit.int8_row_amax_reference(x, w[4])
            parts = resunit.int8_unit_parts(x, amax, pack, dilation, causal)
            want = parts["out"]
            B, T, C = x.shape
            c7 = torch.empty(B, T, C, device="cuda")
            q1 = torch.empty(B, T + 6 * dilation, C, dtype=torch.int8, device="cuda")
            pl, ext = resunit.reflect_extent(T, dilation, causal)
            got_amax = resunit.launch_int8_amax(x, pack.alpha1, pack.recip1)
            again = resunit.launch_int8(x, got_amax, pack, dilation, pl, ext, c7=c7, q1=q1)
            torch.cuda.synchronize()
            assert torch.equal(got_amax, amax)
            assert torch.equal(q1, parts["q1"]) and torch.equal(c7, parts["c7"])
            assert torch.equal(again, got)
        else:
            want = resunit.residual_unit_reference(x, *w, dilation, causal,
                                                   resunit.ROUTE_POLICY[route])
        scale = resunit.bf16_error_scale(x, *w, dilation, causal, route)
    assert got.dtype == want.dtype == torch.float32 and got.shape == x.shape
    ulps = resunit.bf16_ulps(got, want, scale)
    equal = (got == want).float().mean().item()
    print(f"{route} {tuple(x.shape)} d={dilation} causal={causal}: {equal:.4%} bit-equal, worst "
          f"{ulps.max().item():.2f} ulps")
    assert ulps.max().item() <= BF16_MAX_ULPS, ulps.max().item()


# The float32-in/out forms at every flagship width and dilation, T = 53 (the
# pad's zero-extend at d = 9) and 1000 (a ragged last tile), causal; and a
# few non-causal.
F32IO_CASES = ([(4, C, d, T, True) for C in (64, 96, 128, 192, 256, 384, 512, 768)
                for d in (1, 3, 9) for T in (53, 1000)]
               + [(2, C, 9, 700, False) for C in (96, 384, 768)])


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("B,C,dilation,T,causal", F32IO_CASES)
def test_resunit_f32io_forms_match_plain(B, C, dilation, T, causal, act):
    _need_cuda()
    _check_packed_form("f32io_act" if act else "f32io",
                       _f32_unit_args(B, C, dilation, T, C + dilation + T), dilation, causal)


# The int8 unit at the flagship's width (C = 768, every dilation; T = 1, 53
# and the decode's 4800 rows) and at narrower widths that thresholds below
# the default quantize, with a ragged last N tile (C = 96, 160).
INT8_CASES = ([(4, 768, d, T, True) for d in (1, 3, 9) for T in (1, 53, 4800)]
              + [(2, 768, 9, 300, False), (2, 384, 3, 1000, True), (2, 512, 9, 333, True),
                 (3, 96, 1, 500, True), (2, 160, 3, 129, False)])


@pytest.mark.parametrize("B,C,dilation,T,causal", INT8_CASES)
def test_resunit_int8_matches_plain(B, C, dilation, T, causal):
    _need_cuda()
    _check_packed_form("int8", _f32_unit_args(B, C, dilation, T, 3 * C + dilation + T),
                       dilation, causal)


# The edges of the int8 unit's tiling (csrc/resunit_int8.cu: 64-row tiles
# on a persistent grid, N tiles of up to 256 channels, each split between
# two consumer warpgroups): fewer row tiles than SMs (B = 1, T = 100); 133
# tiles (7 x 19, one past the SM count: one CTA takes a second tile); T not
# a multiple of the tile at d = 9, causal and not; C = 96 and 160 at d = 9
# (one N tile, ragged at 160); C = 384 (two N tiles of 192); the widest
# units the mma.sync kernel it replaced took (C = 800 at d = 9, 992 at
# d = 1); and a unit too wide for two weight stages beside its q1 tile
# (C = 2048 at d = 9), which the entry refuses.
INT8_TILING_CASES = [(1, 768, 3, 100, True), (7, 768, 9, 1200, False), (2, 768, 9, 1001, True),
                     (2, 768, 9, 1001, False), (2, 96, 9, 777, True), (2, 160, 9, 300, True),
                     (2, 384, 9, 500, False), (1, 800, 9, 200, True), (1, 992, 1, 200, False)]
INT8_REFUSED = (1, 2048, 9, 100, True)


@pytest.mark.parametrize("B,C,dilation,T,causal", INT8_TILING_CASES + [INT8_REFUSED])
def test_resunit_int8_tiling(B, C, dilation, T, causal):
    _need_cuda()
    args = _f32_unit_args(B, C, dilation, T, 5 * C + dilation + T)
    if (B, C, dilation, T, causal) == INT8_REFUSED:
        x, pack = args[0], resunit.pack_int8(*args[1:])
        pl, ext = resunit.reflect_extent(T, dilation, causal)
        with torch.no_grad(), pytest.raises(RuntimeError, match="refuses"):
            amax = resunit.launch_int8_amax(x, pack.alpha1, pack.recip1)
            resunit.launch_int8(x, amax, pack, dilation, pl, ext)
        return
    _check_packed_form("int8", args, dilation, causal)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_resunit_int8_deterministic(dilation):
    """The flagship decode's int8 units (C = 768, T = 4800, batch 4): three
    launches give the same q1, c7 and out bits: the persistent walk changes
    no sum's order."""
    _need_cuda()
    B, T, C = 4, 4800, 768
    x, *w = _f32_unit_args(B, C, dilation, T, 11 * dilation)
    pack = resunit.pack_int8(*w)
    pl, ext = resunit.reflect_extent(T, dilation, True)
    runs = []
    with torch.no_grad():
        amax = resunit.launch_int8_amax(x, pack.alpha1, pack.recip1)
        for _ in range(3):
            c7 = torch.empty(B, T, C, device="cuda")
            q1 = torch.empty(B, T + 6 * dilation, C, dtype=torch.int8, device="cuda")
            out = resunit.launch_int8(x, amax, pack, dilation, pl, ext, c7=c7, q1=q1)
            runs.append((out, c7, q1))
        torch.cuda.synchronize()
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


def test_residual_unit_routes_by_policy(monkeypatch):
    """ResidualUnit on the card under each policy: the kernel form of its
    route, one launch each (the int8 unit two: row maxima, then the unit);
    a bf16 x into a quantizing conv7, and a quantizing 1x1, raise."""
    from facodec_tpu_torch.models.dac import ResidualUnit
    from facodec_tpu_torch.ops import precision
    _need_cuda()
    monkeypatch.setattr(precision, "INT8_MIN_FANIN", 7 * 256)
    unit = ResidualUnit(256, dilation=3, causal=True).cuda().eval()
    x = _f32_unit_args(2, 256, 3, 300, 1)[0]
    f = resunit.fused_residual_unit
    names = ("launches", "bf16_launches", "f32io_launches", "f32io_act_launches",
             "int8_amax_launches", "int8_launches")
    cases = [("float32", x, "launches"), ("hybrid_int8", x, "launches"),
             ("bfloat16", x, "f32io_launches"), ("bfloat16_act", x.bfloat16(), "bf16_launches"),
             ("int8", x, ("int8_amax_launches", "int8_launches"))]
    with torch.no_grad(), float32_exact():
        for name, xin, want in cases:
            before = {n: getattr(f, n) for n in names}
            with precision.policy(name):
                out = unit(xin)
            torch.cuda.synchronize()
            moved = {n for n in names if getattr(f, n) != before[n]}
            assert moved == set(want if isinstance(want, tuple) else (want,)), (name, moved)
            assert out.dtype == (torch.bfloat16 if name == "bfloat16_act" else torch.float32)
        monkeypatch.setattr(precision, "INT8_MIN_FANIN", 7 * 256 + 1)
        with precision.policy("int8"):
            before = f.f32io_act_launches
            assert unit(x).dtype == torch.float32 and f.f32io_act_launches == before + 1
            monkeypatch.setattr(precision, "INT8_MIN_FANIN", 7 * 256)
            with pytest.raises(TypeError, match="float32 x"):
                unit(x.bfloat16())
            monkeypatch.setattr(precision, "INT8_MIN_FANIN", 256)
            with pytest.raises(ValueError, match="quantizes the 1x1"):
                unit(x)


# The flagship's W8A8 convs outside the unit (torch._int_mm): the decoder's
# first conv, its two wide transposed convs, the encoder's last down-conv.
INT_MM_CASES = [(1024, 1536, 7, 1, False), (1536, 768, 12, 6, True), (768, 384, 10, 5, True),
                (512, 1024, 12, 6, False)]


@pytest.mark.parametrize("I,O,K,stride,transpose", INT_MM_CASES)
def test_int8_convs_bit_equal_to_float64(I, O, K, stride, transpose):
    from facodec_tpu_torch.nn import conv
    _need_cuda()
    g = torch.Generator().manual_seed(I + K)
    x = torch.randn(2, 201, I, generator=g)
    w = torch.randn(*((I, O, K) if transpose else (O, I, K)), generator=g) / (I * K) ** 0.5
    b = 0.1 * torch.randn(O, generator=g)
    xq, _ = conv.quantize_dynamic(x, (1, 2))
    wq, _ = conv.quantize_dynamic(w, (0, 2) if transpose else (1, 2))
    if transpose:
        want = conv.int8_conv_transpose1d(xq, wq, stride)
        got = conv.int8_conv_transpose1d(xq.cuda(), wq.cuda(), stride)
    else:
        want = conv.int8_conv1d(xq, wq, stride, 1, 0, 1)
        got = conv.int8_conv1d(xq.cuda(), wq.cuda(), stride, 1, 0, 1)
    assert got.dtype == torch.int32 and torch.equal(got.cpu().double(), want)
    # the whole W8A8 conv: the card's bits are the CPU's
    full = conv.w8a8_conv(x, w, b, transpose=transpose, stride=stride)
    full_card = conv.w8a8_conv(x.cuda(), w.cuda(), b.cuda(), transpose=transpose, stride=stride)
    assert torch.equal(full_card.cpu(), full)


@pytest.mark.parametrize("case", ["f32io", "f32io_act", "int8_amax", "int8"])
def test_new_resunit_ops_opcheck(case):
    """`torch.library.opcheck` of the new ops on CUDA tensors."""
    _need_cuda()
    x, *w = _f32_unit_args(2, 64, 3, 90, 4)
    if case.startswith("f32io"):
        op = torch.ops.facodec.resunit_bf16_f32io.default
        args = (x, *resunit.make_pack(case, *w), 3, True, case == "f32io_act")
    elif case == "int8_amax":
        pack = resunit.pack_int8(*w)
        op, args = torch.ops.facodec.resunit_int8_amax.default, (x, pack.alpha1, pack.recip1)
    else:
        op = torch.ops.facodec.resunit_int8.default
        args = (x, resunit.int8_row_amax_reference(x, w[4]), *resunit.pack_int8(*w), 3, True)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_hybrid_int8_codec_on_card(monkeypatch):
    """A small hybrid_int8 codec whose thresholds quantize what the
    flagship's do (the decoder's first wide transposed convs, block 0's
    conv7s): the launches of one round trip (12 float32 encoder units, then
    3 int8 units of two launches, 3 float32-in/out act units, 6 bf16 units,
    6 VQ searches), float32's codes, and the CPU's decode of the same codes
    within 2.5e-2 in RMS and under 8e-2 of the peak at the worst sample.
    The worst-sample limit is the port's for two faithful bf16 decodes
    (tests/test_torch_precision.py); the RMS limit is set from the readings
    on an H100 (PERF.md, PR 14): this codec's random weights amplify a
    flipped bf16 rounding, so its hybrid_int8 decode stands 2.13e-2 RMS from
    the CPU's, and its plain hybrid decode, with no int8 step, 2.07e-2."""
    from facodec_tpu_torch.ops import precision
    _need_cuda()
    monkeypatch.setattr(precision, "INT8_MIN_FANIN", 7 * 256)
    codec = FACodec.from_fields(SMALL_CODEC, seed=2, device="cuda", precision="hybrid_int8")
    cpu = FACodec.from_fields(SMALL_CODEC, seed=2, device="cpu", precision="hybrid_int8")
    f32 = FACodec(codec.encoder, codec.quantizer, codec.decoder)
    w = sweep_wave(2, 1.0, seed=3)
    f = codec.encode(w)
    codec.decode(f)
    f_ = resunit.fused_residual_unit
    names = ("launches", "bf16_launches", "f32io_launches", "f32io_act_launches",
             "int8_amax_launches", "int8_launches")
    before = [getattr(f_, n) for n in names] + [vq.nearest_code.launches]
    f = codec.encode(w)
    y = codec.decode(f)
    torch.cuda.synchronize()
    after = [getattr(f_, n) for n in names] + [vq.nearest_code.launches]
    assert [b - a for a, b in zip(before, after)] == [12, 6, 0, 3, 3, 3, 6]
    want = f32.encode(w)
    for name in ("codes_p", "codes_c", "codes_r"):
        np.testing.assert_array_equal(getattr(f, name), getattr(want, name))
    y_cpu = cpu.decode(f)
    err = np.abs(y - y_cpu).max() / np.abs(y_cpu).max()
    rms = np.sqrt(np.mean((y - y_cpu) ** 2) / np.mean(y_cpu ** 2))
    assert rms <= 2.5e-2 and err < 8e-2, (rms, err)


def _unit_args(B, T, C, dilation, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed + C + dilation)
    x = torch.randn(B, T, C, device="cuda", generator=g)
    halo = torch.randn(B, 6 * dilation, C, device="cuda", generator=g)
    w7 = torch.randn(C, C, 7, device="cuda", generator=g) / (7 * C) ** 0.5
    w1 = torch.randn(C, C, 1, device="cuda", generator=g) / C ** 0.5
    b7, b1 = (0.1 * torch.randn(C, device="cuda", generator=g) for _ in range(2))
    a1, a2 = (0.5 + torch.rand(1, C, 1, device="cuda", generator=g) for _ in range(2))
    return x, halo, (w7, b7, w1, b1, a1, a2, dilation)


# The halo entry at every flagship unit width and dilation, batch 1 and 4,
# with chunks shorter than, equal to and longer than the 6d-row halo (54 rows
# at d = 9; T = 24 is the 4-frame chunk of encoder stage 4 and decoder stage 1).
STREAM_CASES = [(B, C, d, T) for C in (64, 128, 256, 512, 768, 384, 192, 96)
                for d in (1, 3, 9) for T in (1, 6, 24, 53, 54, 55, 300) for B in (1, 4)]


@pytest.mark.parametrize("B,C,dilation,T", STREAM_CASES)
def test_resunit_halo_entry_matches_plain(B, C, dilation, T):
    """A steady chunk: output within 1e-5 of the plain version, the new halo
    bit-equal, one launch."""
    _need_cuda()
    x, halo, rest = _unit_args(B, T, C, dilation)
    before = resunit.fused_residual_unit_stream.launches
    with float32_exact():
        want, want_halo = resunit.residual_unit_stream_reference(x, halo, *rest)
        got, got_halo = resunit.fused_residual_unit_stream(x, halo, *rest)
    torch.cuda.synchronize()
    assert resunit.fused_residual_unit_stream.launches == before + 1
    assert torch.equal(got_halo, want_halo)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,dilation,T", [(C, d, T) for C in (64, 768, 96) for d in (1, 9)
                                          for T in (6 * d + 1, 300)])
def test_resunit_halo_entry_first_chunk(C, dilation, T):
    """A stream's first chunk (no halo): the causal reflect, as the one-shot
    entry pads, and the last 6d padded rows as the new halo."""
    _need_cuda()
    x, _, rest = _unit_args(4, T, C, dilation, seed=1)
    with float32_exact():
        want, want_halo = resunit.residual_unit_stream_reference(x, None, *rest)
        got, got_halo = resunit.fused_residual_unit_stream(x, None, *rest)
        one_shot = resunit.fused_residual_unit(x, *rest, True)
    assert torch.equal(got_halo, want_halo)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, one_shot)


@pytest.mark.parametrize("fault", ["strided", "float64", "short_first"])
def test_resunit_halo_entry_rejects(fault):
    _need_cuda()
    x, halo, rest = _unit_args(2, 30, 64, 9)
    if fault == "strided":
        halo = torch.randn(2, 54, 128, device="cuda")[:, :, ::2]
    elif fault == "float64":
        halo = halo.double()
    else:
        halo = None  # a first chunk of 30 <= 54 rows
    before = resunit.fused_residual_unit_stream.launches
    with pytest.raises(TypeError if fault == "float64" else ValueError):
        resunit.fused_residual_unit_stream(x, halo, *rest)
    assert resunit.fused_residual_unit_stream.launches == before


@pytest.mark.parametrize("M", [1, 37, 3200])
def test_vq_kernel_matches_plain(M):
    _need_cuda()
    rng = np.random.default_rng(M)
    cb = torch.from_numpy(rng.standard_normal((1024, 8)).astype(np.float32)).cuda()
    cb[700] = cb[10]
    lat = torch.from_numpy(rng.standard_normal((M, 8)).astype(np.float32)).cuda()
    lat[: (M + 1) // 2] = 2.5 * cb[10]
    with float32_exact():
        want_idx, want_zq = vq_math.nearest_code(lat, cb)
    before = vq.nearest_code.launches
    idx, zq = vq.nearest_code(lat, cb)
    assert vq.nearest_code.launches == before + 1
    assert bool((idx[: (M + 1) // 2] == 10).all())
    assert torch.equal(idx, want_idx) and torch.equal(zq, want_zq)


# The kernel sums e.c in a fixed FMA order; cuBLAS's product in the plain
# version may round differently, so an index may differ where the plain
# top-2 gap is a float32 near-tie (chip_smoke.py's VQ_TIE_GAP, VQ_TIE_SHARE).
VQ_TIE_GAP = 1e-6
VQ_TIE_SHARE = 1e-3


def _vq_launch(lat, cb):
    before = vq.nearest_code.launches
    idx, zq = vq.nearest_code(lat, cb)
    torch.cuda.synchronize()
    assert vq.nearest_code.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == lat.shape[:-1] and zq.shape == lat.shape
    return idx, zq


def _assert_vq_matches_plain(lat, cb, idx, zq):
    with float32_exact():
        want_idx, want_zq = vq_math.nearest_code(lat, cb)
        dist = vq_math.code_distances(lat, cb)
    differ = idx != want_idx
    if cb.shape[0] > 1:
        top2 = torch.topk(dist, 2, dim=-1, largest=False).values
        assert not bool((differ & (top2[..., 1] - top2[..., 0] >= VQ_TIE_GAP)).any())
    assert int(differ.sum()) <= VQ_TIE_SHARE * idx.numel()
    assert torch.equal(zq[~differ], want_zq[~differ])
    assert torch.equal(zq, cb[idx.long()])


@pytest.mark.parametrize("N", [1, 1000, 1024])
@pytest.mark.parametrize("M", [1, 31, 3201, 16000])
def test_vq_kernel_shapes(M, N):
    """Ragged and large row counts, books of one code, of a ragged code
    split (1000 is no multiple of 64) and of the main path's 1024."""
    _need_cuda()
    rng = np.random.default_rng(M * 7 + N)
    cb = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32)).cuda()
    lat = torch.from_numpy(rng.standard_normal((M, 8)).astype(np.float32)).cuda()
    idx, zq = _vq_launch(lat, cb)
    assert int(idx.min()) >= 0 and int(idx.max()) < N
    _assert_vq_matches_plain(lat, cb, idx, zq)


def test_vq_kernel_zero_and_nan_rows():
    """An all-zero row is clamped at norm 1e-12 and scores |c|^2 alone; a
    row of NaNs scores NaN against every code and gets code 0."""
    _need_cuda()
    rng = np.random.default_rng(5)
    cb = torch.from_numpy(rng.standard_normal((1024, 8)).astype(np.float32)).cuda()
    lat = torch.from_numpy(rng.standard_normal((100, 8)).astype(np.float32)).cuda()
    lat[3] = 0.0
    lat[7] = float("nan")
    lat[8, 2] = float("nan")
    idx, zq = _vq_launch(lat, cb)
    assert int(idx[7]) == 0 and int(idx[8]) == 0
    assert torch.equal(zq, cb[idx.long()])
    with float32_exact():
        dist = vq_math.code_distances(lat[3:4], cb)[0]
    # every code scores |c|^2, 1 up to rounding: the kernel's pick is one
    # of the least within a near-tie
    assert bool(dist[idx[3].long()] - dist.min() < VQ_TIE_GAP)
    keep = torch.ones(100, dtype=torch.bool, device="cuda")
    keep[[3, 7, 8]] = False
    _assert_vq_matches_plain(lat[keep], cb, idx[keep], zq[keep])


@pytest.mark.parametrize("first,copy,N", [
    (10, 700, 1024),    # different lanes
    (5, 37, 1024),      # one lane, the two codes of one step
    (5, 69, 1024),      # one lane, two steps
    (3, 2500, 3000),    # two chunks of the staged book
    (1023, 2047, 3000),  # the last code of a chunk and the last of the next
])
def test_vq_kernel_duplicates_take_the_first(first, copy, N):
    _need_cuda()
    rng = np.random.default_rng(first + copy)
    cb = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32)).cuda()
    cb[copy] = cb[first]
    lat = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32)).cuda()
    lat[:100] = 2.5 * cb[first]
    lat[100:150] = 0.5 * cb[first]
    idx, zq = _vq_launch(lat, cb)
    assert bool((idx[:150] == first).all())
    _assert_vq_matches_plain(lat, cb, idx, zq)


# A small codec and redecoder whose residual units are all kernel widths
# (C % 32 == 0): encoder units 32-256, decoder units 256-32.
SMALL_CODEC = dict(
    encoder=dict(d_model=32, strides=(2, 5, 5, 6), d_latent=64, causal=True, lstm=1),
    quantizer=dict(in_dim=64, n_p_codebooks=1, n_c_codebooks=2, n_t_codebooks=2,
                   n_r_codebooks=3, codebook_size=32, codebook_dim=8, quantizer_dropout=0.5,
                   causal=True, separate_prosody_encoder=True, timbre_norm=True,
                   style_hidden_dim=32, prosody_hidden_dim=16),
    decoder=dict(input_channel=64, channels=512, rates=(6, 5, 5, 2), causal=True, lstm=1),
)
SMALL_REDECODER = dict(
    encoder=dict(n_p_codebooks=1, n_c_codebooks=2, codebook_size=32, embed_dim=32,
                 n_layers=16, causal=False, gin_channels=64, out_dim=64),
    decoder=dict(input_channel=64, channels=512, rates=(6, 5, 5, 2), causal=False, lstm=1),
)


def test_streaming_session_card_matches_cpu():
    """One seed on both devices, 4-frame chunks (primed, then T < 6d at the
    d = 9 units of encoder stage 4 and decoder stage 1): the card's session
    (halo entry, VQ kernel) against the CPU's (plain versions), with the
    limits chip_smoke.py holds the card to; 24 halo-entry and 6 VQ launches
    per steady chunk, and none of the one-shot entry."""
    _need_cuda()
    from facodec_tpu_torch.models.streaming import StreamingFACodec

    wave = sweep_wave(2, 40 * 300 / 24000, seed=13)
    out = {}
    for device in ("cpu", "cuda"):
        codec = FACodec.from_fields(SMALL_CODEC, seed=5, device=device, n_c=2)
        sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder, chunk_frames=4,
                                n_c=2)
        w = torch.from_numpy(wave).to(device)
        timbre = torch.from_numpy(codec.timbre_of(wave)).to(device)
        est, dst = sess.init_encode_state(2), sess.init_decode_state(2)
        waves, codes = [], []
        for i in range(0, w.shape[1], 1200):
            before = (resunit.fused_residual_unit.launches,
                      resunit.fused_residual_unit_stream.launches, vq.nearest_code.launches)
            est, dst, y, c = sess.roundtrip_chunk(est, dst, w[:, i : i + 1200], timbre)
            after = (resunit.fused_residual_unit.launches,
                     resunit.fused_residual_unit_stream.launches, vq.nearest_code.launches)
            launched = tuple(a - b for a, b in zip(after, before))
            if y is None:
                continue
            if device == "cuda":
                assert launched == (0, 24, 6), launched
            waves.append(y.cpu().numpy())
            codes.append(torch.cat(c, 1).cpu().numpy())
        out[device] = np.concatenate(waves, 1), np.concatenate(codes, -1)
    (w_cpu, c_cpu), (w_gpu, c_gpu) = out["cpu"], out["cuda"]
    assert w_gpu.shape == w_cpu.shape and np.isfinite(w_gpu).all()
    assert (c_gpu == c_cpu).mean() >= 0.99
    assert float(np.abs(w_gpu - w_cpu).max()) <= 1e-3


def test_convert_voice_card_matches_cpu():
    """One seed on both devices: the card's convert_voice (kernels) equals
    the CPU's (plain versions) and launches 36 residual units and 10 VQ
    searches."""
    _need_cuda()
    src, tgt = sweep_wave(2, 0.5, seed=11), sweep_wave(2, 0.5, seed=12)
    out = {}
    for device in ("cpu", "cuda"):
        codec = FACodec.from_fields(SMALL_CODEC, seed=3, device=device, n_c=1)
        red = FARedecoder.from_fields(SMALL_REDECODER, seed=4, device=device)
        before = resunit.fused_residual_unit.launches, vq.nearest_code.launches
        out[device] = convert_voice(codec, red, src, tgt)
        after = resunit.fused_residual_unit.launches, vq.nearest_code.launches
        launched = (after[0] - before[0], after[1] - before[1])
        assert launched == ((0, 0) if device == "cpu" else (36, 10)), launched
    assert out["cuda"].shape == src.shape and np.isfinite(out["cuda"]).all()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ training
UNIT_GRADS = ("x", "w7", "b7", "w1", "b1", "alpha1", "alpha2")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,C,dilation,T", [(4, 64, 1, 24000), (4, 512, 9, 480), (4, 768, 9, 480),
                                            (4, 96, 3, 1000), (2, 192, 9, 50)])
def test_resunit_gradients_match_plain(B, C, dilation, T, causal):
    """The float32 entry's gradient (its custom op's): one kernel launch forward, and
    its gradients for x, both weights, both biases and both alphas within
    1e-4 of max|g| of the plain composition's autograd."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(C + dilation + T)
    base = [torch.randn(B, T, C, device="cuda", generator=g),
            torch.randn(C, C, 7, device="cuda", generator=g) / (7 * C) ** 0.5,
            0.1 * torch.randn(C, device="cuda", generator=g),
            torch.randn(C, C, 1, device="cuda", generator=g) / C ** 0.5,
            0.1 * torch.randn(C, device="cuda", generator=g),
            0.5 + torch.rand(1, C, 1, device="cuda", generator=g),
            0.5 + torch.rand(1, C, 1, device="cuda", generator=g)]
    cot = torch.randn(B, T, C, device="cuda", generator=g)
    out = {}
    with float32_exact():
        for name, fn in (("kernel", resunit.fused_residual_unit),
                         ("plain", resunit.residual_unit_reference)):
            leaves = [t.clone().requires_grad_(True) for t in base]
            before = resunit.fused_residual_unit.launches
            y = fn(*leaves, dilation, causal)
            grads = torch.autograd.grad(y, leaves, cot)
            launched = resunit.fused_residual_unit.launches - before
            assert launched == (1 if name == "kernel" else 0)
            out[name] = y, grads
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-4, atol=1e-4)
    for n, a, b in zip(UNIT_GRADS, out["kernel"][1], out["plain"][1]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item(), n


def test_forward_only_entries_refuse_gradients():
    """The bf16 entry and the halo entry serve only: asked for a gradient
    they raise; under no_grad they run."""
    _need_cuda()
    C = 64
    w = [torch.randn(C, C, 7, device="cuda") / 21, torch.zeros(C, device="cuda"),
         torch.randn(C, C, 1, device="cuda") / 8, torch.zeros(C, device="cuda"),
         torch.ones(1, C, 1, device="cuda"), torch.ones(1, C, 1, device="cuda")]
    w[0].requires_grad_(True)
    x = torch.randn(1, 100, C, device="cuda")
    with pytest.raises(RuntimeError, match="forward only"):
        resunit.fused_residual_unit(x.bfloat16(), *w, 1, True)
    with pytest.raises(RuntimeError, match="forward only"):
        resunit.fused_residual_unit_stream(x, None, *w, 1)
    with torch.no_grad():
        resunit.fused_residual_unit(x.bfloat16(), *w, 1, True)
        resunit.fused_residual_unit_stream(x, None, *w, 1)


@pytest.mark.parametrize("M", [37, 3200])
def test_vq_gradients_match_plain_gather(M):
    """nearest_code's gradient (the custom op's): one launch; the codebook gradient is
    the plain gather's (rows scatter-added into the selected codes), and the
    latents' gradient is zero."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(M)
    lat = torch.randn(M, 8, device="cuda", generator=g).requires_grad_(True)
    cb = torch.randn(1024, 8, device="cuda", generator=g).requires_grad_(True)
    cot = torch.randn(M, 8, device="cuda", generator=g)
    before = vq.nearest_code.launches
    idx, zq = vq.nearest_code(lat, cb)
    assert vq.nearest_code.launches == before + 1
    g_lat, g_cb = torch.autograd.grad(zq, (lat, cb), cot)
    cb_p = cb.detach().clone().requires_grad_(True)
    (g_plain,) = torch.autograd.grad(cb_p[idx.long()], cb_p, cot)
    assert torch.count_nonzero(g_lat) == 0
    assert (g_cb - g_plain).abs().max().item() <= 1e-6 * g_plain.abs().max().item()


# The training step at widths the kernels take (every residual unit C % 32
# == 0, codebook_dim 8), small enough for the CPU leg.
TRAIN_FIELDS = dict(
    SMALL_CODEC,
    encoder=dict(d_model=32, strides=(15, 20), d_latent=64, causal=True, lstm=1),
    quantizer=dict(SMALL_CODEC["quantizer"], quantizer_dropout=0.0, prob_random_mask_residual=0.0),
    decoder=dict(input_channel=64, channels=128, rates=(20, 15), causal=True, lstm=1),
    discriminator=dict(rates=(), periods=(2, 3), fft_sizes=(512,), sample_rate=24000),
    fa_predictors=dict(in_dim=64, use_gr_content_f0=False, use_gr_prosody_phone=False,
                       use_gr_residual_f0=True, use_gr_residual_phone=True,
                       use_gr_timbre_content=True, use_gr_timbre_prosody=False,
                       use_gr_x_timbre=True, norm_f0=True, timbre_norm=True,
                       use_gr_content_global_f0=True, n_phone_classes=32, n_speakers=16),
)


def _no_dropout(models):
    for m in models.values():
        for sub in m.modules():
            for attr in ("p_dropout", "dropout"):
                if isinstance(getattr(sub, attr, None), float):
                    setattr(sub, attr, 0.0)
    return models


def _step_card_vs_cpu(teacher_file=None):
    """One seed on both devices, every draw off: the card's step (kernels,
    12 residual units and 6 VQ searches in its one generator forward) against
    the CPU's (plain versions): every loss and gradient norm within 1e-3
    relative, and every module's parameters moved alike. With a JDC file,
    each device's step runs that teacher inline."""
    from facodec_tpu_torch.models.jdc import load_jdc_checkpoint
    from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch, to_device
    from facodec_tpu_torch.train.loop import build_models
    from facodec_tpu_torch.train.optimizers import build_optimizers
    from facodec_tpu_torch.train.step import make_codec_train_step

    ds = PseudoDataset(length=2, seed=0, min_s=1.0, max_s=2.0, n_phones=32, n_speakers=16)
    seg = segment_batch(collate([ds[0], ds[1]], 80), 8, generator=torch.Generator().manual_seed(0))
    out = {}
    for device in ("cpu", "cuda"):
        models = _no_dropout(build_models(TRAIN_FIELDS, 3, device))
        teacher = load_jdc_checkpoint(teacher_file, device) if teacher_file else None
        step = make_codec_train_step(models, build_optimizers(models), f0_teacher=teacher)
        before = resunit.fused_residual_unit.launches, vq.nearest_code.launches
        metrics, _ = step(to_device(seg, device), None)
        launched = (resunit.fused_residual_unit.launches - before[0],
                    vq.nearest_code.launches - before[1])
        assert launched == ((0, 0) if device == "cpu" else (12, 6)), launched
        out[device] = {k: float(v) for k, v in metrics.items()}, {
            k: [p.detach().cpu() for p in m.parameters()] for k, m in models.items()}
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out["cpu"], out["cuda"]
    for k in m_cpu:
        assert np.isfinite(m_gpu[k]) and abs(m_gpu[k] - m_cpu[k]) <= 1e-3 * abs(m_cpu[k]), k
    for k in p_cpu:
        for a, b in zip(p_gpu[k], p_cpu[k]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def test_train_step_card_matches_cpu():
    _need_cuda()
    _step_card_vs_cpu()


def test_train_step_with_teacher_card_matches_cpu(jdc_file):
    """The same with the JDC teacher inline on each device."""
    _need_cuda()
    _step_card_vs_cpu(jdc_file)


def test_run_training_on_card(tmp_path):
    """run_training on the card: 2 steps of 12 residual-unit launches and 6
    VQ searches each, a checkpoint, a resume to step 3."""
    _need_cuda()
    from facodec_tpu_torch.train.data import PseudoDataset
    from facodec_tpu_torch.train.loop import latest_checkpoint, run_training

    def ds():
        return PseudoDataset(length=4, seed=0, min_s=1.0, max_s=3.0, n_phones=32, n_speakers=16)

    before = resunit.fused_residual_unit.launches, vq.nearest_code.launches
    state = run_training(fields=TRAIN_FIELDS, dataset=ds(), max_steps=2, device="cuda",
                         log_dir=str(tmp_path), log_writer=False, batch_size=2, max_len=8,
                         save_interval=2)
    assert (resunit.fused_residual_unit.launches - before[0],
            vq.nearest_code.launches - before[1]) == (24, 12)
    assert state.step == 2 and all(np.isfinite(v) for v in state.metrics.values())
    assert latest_checkpoint(str(tmp_path)).endswith("_step_00002.pth")
    state = run_training(fields=TRAIN_FIELDS, dataset=ds(), max_steps=3, device="cuda",
                         log_dir=str(tmp_path), log_writer=False, batch_size=2, max_len=8)
    assert state.step == 3


# Redecoder training at kernel widths: the frozen codec of TRAIN_FIELDS (6
# causal units, 6 searches) and a non-causal decoder of 6 units.
RED_TRAIN_FIELDS = dict(
    codec=dict(encoder=TRAIN_FIELDS["encoder"], quantizer=TRAIN_FIELDS["quantizer"]),
    encoder=dict(SMALL_REDECODER["encoder"], n_layers=4, p_dropout=0.2),
    decoder=dict(input_channel=64, channels=128, rates=(20, 15), causal=False, lstm=1),
    discriminator=TRAIN_FIELDS["discriminator"],
)


def _launches():
    return resunit.fused_residual_unit.launches, vq.nearest_code.launches


def _red_setup(device, seed=3):
    from facodec_tpu_torch.train.optimizers import build_optimizers
    from facodec_tpu_torch.train.redecoder_loop import build_frozen_codec, build_redecoder_models

    codec = build_frozen_codec(RED_TRAIN_FIELDS["codec"], device)
    models = build_redecoder_models(RED_TRAIN_FIELDS, seed, device)
    return codec, models, build_optimizers(models)


def _red_batch(device):
    from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch, to_device

    ds = PseudoDataset(length=2, seed=0, min_s=1.0, max_s=2.0)
    seg = segment_batch(collate([ds[0], ds[1]], 80), 8, generator=torch.Generator().manual_seed(0))
    return to_device({k: seg[k] for k in ("wave_seg", "full_waves", "wave_lens")}, device)


def test_redecoder_step_card_matches_cpu():
    """One seed on both devices, the dropout off: the card's redecoder step
    (6 frozen units without a graph, 6 non-causal units through the
    Function, 6 searches) against the CPU's, within 1e-3 relative."""
    _need_cuda()
    from facodec_tpu_torch.train.redecoder_step import make_redecoder_train_step

    out = {}
    for device in ("cpu", "cuda"):
        codec, models, optimizers = _red_setup(device)
        models["encoder"].encoder.p_dropout = 0.0
        before = _launches()
        metrics, _ = make_redecoder_train_step(codec, models, optimizers)(_red_batch(device), None)
        launched = tuple(a - b for a, b in zip(_launches(), before))
        assert launched == ((0, 0) if device == "cpu" else (12, 6)), launched
        out[device] = {k: float(v) for k, v in metrics.items()}
    for k, v in out["cpu"].items():
        assert np.isfinite(out["cuda"][k]) and abs(out["cuda"][k] - v) <= 1e-3 * abs(v), k


@pytest.mark.parametrize("stage", ["codec", "redecoder"])
def test_split_and_remat_steps_on_card(stage):
    """Dropout on, one generator seed: the split and remat steps' metrics
    within 1e-4 relative of the fused step's on the card, and the launches
    each adds (the split step's second forward, remat's recompute)."""
    _need_cuda()
    from facodec_tpu_torch.train import redecoder_step, step
    from facodec_tpu_torch.train.loop import build_models
    from facodec_tpu_torch.train.optimizers import build_optimizers

    if stage == "codec":
        fields = dict(TRAIN_FIELDS, quantizer=SMALL_CODEC["quantizer"])
        fused, split = step.make_codec_train_step, step.make_codec_train_step_split
        extra = (12, 6)

        def setup():
            models = build_models(fields, 3, "cuda")
            return (models, build_optimizers(models)), _batch_codec()
    else:
        fused = redecoder_step.make_redecoder_train_step
        split = redecoder_step.make_redecoder_train_step_split
        extra = (6, 0)

        def setup():
            return _red_setup("cuda"), _red_batch("cuda")

    runs = {}
    for name, make, remat in (("fused", fused, False), ("split", split, False),
                              ("remat", fused, True)):
        args, batch = setup()
        before = _launches()
        metrics, _ = make(*args, remat=remat)(batch, torch.Generator(device="cuda").manual_seed(4))
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      tuple(a - b for a, b in zip(_launches(), before)))
    base, base_launches = runs["fused"]
    assert base_launches == (12, 6)
    for name in ("split", "remat"):
        metrics, launched = runs[name]
        assert launched == (12 + extra[0], 6 + extra[1]), (name, launched)
        for k, v in base.items():
            assert abs(metrics[k] - v) <= 1e-4 * abs(v), (name, k, metrics[k], v)


def _batch_codec():
    from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch, to_device

    ds = PseudoDataset(length=2, seed=0, min_s=1.0, max_s=2.0, n_phones=32, n_speakers=16)
    return to_device(segment_batch(collate([ds[0], ds[1]], 80), 8,
                                   generator=torch.Generator().manual_seed(0)), "cuda")


def test_run_redecoder_training_on_card(tmp_path):
    """run_redecoder_training on the card: 2 steps of 12 residual-unit
    launches and 6 VQ searches each, the frozen codec unchanged, a
    checkpoint, a resume to step 3."""
    _need_cuda()
    from facodec_tpu_torch.train.data import PseudoDataset
    from facodec_tpu_torch.train.loop import latest_checkpoint
    from facodec_tpu_torch.train.redecoder_loop import build_frozen_codec, run_redecoder_training

    def run(max_steps, **kw):
        return run_redecoder_training(fields=RED_TRAIN_FIELDS, max_steps=max_steps,
                                      dataset=PseudoDataset(length=4, seed=0, min_s=1.0,
                                                            max_s=3.0),
                                      log_dir=str(tmp_path), log_writer=False, batch_size=2,
                                      max_len=8, **kw)

    before = _launches()
    state = run(2, save_interval=2)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (24, 12)
    assert state.step == 2 and all(np.isfinite(v) for v in state.metrics.values())
    seeded = build_frozen_codec(RED_TRAIN_FIELDS["codec"], "cpu")
    for k, m in state.frozen.items():
        for n, t in m.state_dict().items():
            assert torch.equal(t.cpu(), seeded[k].state_dict()[n]), f"{k}.{n}"
    assert latest_checkpoint(str(tmp_path)).endswith("_step_00002.pth")
    assert run(3).step == 3


# ------------------------------------------------------------------ own data
# The JDC teacher's F0, card against CPU, of max|F0| (chip_smoke.py's limit).
TEACHER_TOL = 1e-3


@pytest.fixture(scope="module")
def jdc_file(tmp_path_factory):
    """A seeded JDC state dict in the reference's layout, as a file."""
    from facodec_tpu_torch.models.jdc import random_reference_state_dict

    path = tmp_path_factory.mktemp("jdc") / "bst.t7"
    torch.save({"net": random_reference_state_dict(0)}, path)
    return str(path)


@pytest.mark.parametrize("B,T", [(1, 80), (4, 80), (1, 2400)])
def test_jdc_teacher_card_matches_cpu(jdc_file, B, T):
    """The teacher on the card (cuDNN convolutions and LSTM, TF32 off inside
    its forward whatever the global flags say) against the CPU's."""
    _need_cuda()
    from facodec_tpu_torch.models.jdc import load_jdc_checkpoint

    mel = torch.randn(B, T, 80, generator=torch.Generator().manual_seed(T + B)) - 2.0
    f0 = {}
    for device in ("cpu", "cuda"):
        with torch.no_grad():
            f0[device] = load_jdc_checkpoint(jdc_file, device)(mel.to(device))[0].cpu()
    gap = (f0["cuda"] - f0["cpu"]).abs().max().item()
    print(f"JDC B={B} T={T}: max |F0 card - F0 cpu| {gap:.3e} Hz of max|F0| "
          f"{f0['cpu'].abs().max().item():.1f}")
    assert f0["cuda"].shape == (B, T) and torch.isfinite(f0["cuda"]).all()
    assert gap <= TEACHER_TOL * f0["cpu"].abs().max().item()


def test_extract_targets_jdc_on_card(tmp_path, jdc_file):
    """`extract_targets --teachers jdc --device cuda` writes each wav's F0
    within the teacher's limit of the same command on the CPU."""
    _need_cuda()
    from scipy.io import wavfile

    from facodec_tpu_torch.cli import extract_targets

    wavs = {}
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        d.mkdir()
        rows = []
        for i, seconds in enumerate((1.0, 2.5)):
            path = str(d / f"u{i}.wav")
            wavfile.write(path, 24000, (0.5 * sweep_wave(1, seconds, seed=i)[0] * 32767
                                        ).astype(np.int16))
            rows.append(f"{path}\t{i}\ten\ttext\tphones\n")
        (d / "list.txt").write_text("".join(rows))
        assert extract_targets.main(["--manifest", str(d / "list.txt"), "--teachers", "jdc",
                                     "--jdc-ckpt", jdc_file, "--device", device]) == 0
        wavs[device] = [np.load(r.split("\t")[0] + ".targets.npz")["f0"] for r in rows]
    for got, want in zip(wavs["cuda"], wavs["cpu"]):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= TEACHER_TOL * np.abs(want).max()


# The scorecard, card against CPU, on one seed: codes >= 0.99 equal; the
# decodes differ by float32 rounding, so the losses within 1e-3 relative,
# SNR, SI-SDR and MCD within 0.05 dB, STOI within 1e-3, the F0 probes'
# correlations and voicing agreements within 0.05 (a frame's voicing at the
# 0.3 threshold can flip), NaN where the CPU's is NaN.
SCORECARD_TOL = dict(mel_l1=("rel", 1e-3), stft_l1=("rel", 1e-3), snr_db=("abs", 0.05),
                     si_sdr_db=("abs", 0.05), mcd_db=("abs", 0.05), stoi=("abs", 1e-3),
                     f0_corr_prosody=("abs", 0.05), f0_corr_content=("abs", 0.05),
                     voicing_agree_prosody=("abs", 0.05), voicing_agree_content=("abs", 0.05))


def test_evaluate_utterance_card_matches_cpu():
    """`evaluate_utterance` at kernel widths: 24 residual-unit launches for
    the round trip, 12 for each of the two subset decodes, 6 VQ searches."""
    _need_cuda()
    from facodec_tpu_torch.cli.evaluate import evaluate_utterance

    wave = 0.5 * sweep_wave(1, 2.0, seed=21)[0]
    cards, codes = {}, {}
    for device in ("cpu", "cuda"):
        codec = FACodec.from_fields(SMALL_CODEC, seed=5, device=device, n_c=2)
        before = resunit.fused_residual_unit.launches, vq.nearest_code.launches
        cards[device] = evaluate_utterance(codec, wave)
        launched = (resunit.fused_residual_unit.launches - before[0],
                    vq.nearest_code.launches - before[1])
        assert launched == ((0, 0) if device == "cpu" else (48, 6)), launched
        f = codec.encode(wave)
        codes[device] = np.concatenate([f.codes_p, f.codes_c, f.codes_r], axis=1)
    assert (codes["cuda"] == codes["cpu"]).mean() >= 0.99
    got, want = cards["cuda"], cards["cpu"]
    print("scorecard card / cpu: " + ", ".join(
        f"{k} {got[k]:.6g} / {want[k]:.6g}" for k in SCORECARD_TOL))
    for k, (kind, tol) in SCORECARD_TOL.items():
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
            continue
        limit = tol * abs(want[k]) if kind == "rel" else tol
        assert abs(got[k] - want[k]) <= limit, (k, got[k], want[k])


# ------------------------------------------------ the custom ops under export
class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _through_export(fn, *args):
    """fn's exported program (torch.export on the card's tensors), run on args."""
    with torch.no_grad():
        program = torch.export.export(_Call(fn), args, strict=False)
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert any(t.startswith("facodec.") for t in targets), targets
        return program.module()(*args)


@pytest.mark.parametrize("causal", [True, False])
def test_resunit_f32_op_through_export(causal):
    """`facodec::resunit_f32` in an exported program launches the kernel
    once, within the kernel's tolerance of the plain version."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    B, T, C, d = 2, 700, 192, 9
    x = torch.randn(B, T, C, device="cuda", generator=g)
    w7 = torch.randn(C, C, 7, device="cuda", generator=g) / (7 * C) ** 0.5
    w1 = torch.randn(C, C, 1, device="cuda", generator=g) / C ** 0.5
    b7, b1 = (0.1 * torch.randn(C, device="cuda", generator=g) for _ in range(2))
    a1, a2 = (0.5 + torch.rand(1, C, 1, device="cuda", generator=g) for _ in range(2))
    args = (x, w7, b7, w1, b1, a1, a2)
    before = resunit.fused_residual_unit.launches
    with float32_exact():
        got = _through_export(lambda *t: resunit.fused_residual_unit(*t, d, causal), *args)
        torch.cuda.synchronize()
        assert resunit.fused_residual_unit.launches == before + 1
        want = resunit.residual_unit_reference(*args, d, causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_resunit_bf16_op_through_export(causal):
    """`facodec::resunit_bf16` on a pack made by graph ops inside the
    exported program: one bf16 launch, the eager packed entry's bits, and
    within the bf16 entry's ulps of the plain version."""
    _need_cuda()
    d = 3
    x, *weights = _bf16_unit_args(2, 384, d, 500, 11)

    def unit(x, *w):
        return resunit.fused_residual_unit_packed(x, resunit.pack_bf16(*w), d, causal)

    before = resunit.fused_residual_unit.bf16_launches
    with float32_exact():
        got = _through_export(unit, x, *weights)
        torch.cuda.synchronize()
        assert resunit.fused_residual_unit.bf16_launches == before + 1
        with torch.no_grad():
            want = unit(x, *weights)
    assert torch.equal(got, want)
    _check_bf16_entry((x, *weights), d, causal)


def test_nearest_code_op_through_export():
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    lat = torch.randn(4, 800, 8, device="cuda", generator=g)
    cb = torch.randn(1024, 8, device="cuda", generator=g)
    before = vq.nearest_code.launches
    idx, zq = _through_export(vq.nearest_code, lat, cb)
    torch.cuda.synchronize()
    assert vq.nearest_code.launches == before + 1
    want_idx, want_zq = vq.nearest_code(lat, cb)
    assert torch.equal(idx, want_idx) and torch.equal(zq, want_zq)
    _assert_vq_matches_plain(lat, cb, idx, zq)


@pytest.mark.parametrize("first", [True, False])
def test_resunit_halo_op_through_export(first):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    B, T, C, d = 2, 64, 128, 3
    x = torch.randn(B, T, C, device="cuda", generator=g)
    halo = None if first else torch.randn(B, 6 * d, C, device="cuda", generator=g)
    w = [torch.randn(C, C, 7, device="cuda", generator=g) / 30,
         0.1 * torch.randn(C, device="cuda", generator=g),
         torch.randn(C, C, 1, device="cuda", generator=g) / 11,
         0.1 * torch.randn(C, device="cuda", generator=g),
         0.5 + torch.rand(1, C, 1, device="cuda", generator=g),
         0.5 + torch.rand(1, C, 1, device="cuda", generator=g)]
    if first:
        def chunk(x, *w):
            return resunit.fused_residual_unit_stream(x, None, *w, d)
        args = (x, *w)
    else:
        def chunk(x, h, *w):
            return resunit.fused_residual_unit_stream(x, h, *w, d)
        args = (x, halo, *w)
    before = resunit.fused_residual_unit_stream.launches
    with float32_exact():
        out, new_halo = _through_export(chunk, *args)
        torch.cuda.synchronize()
        assert resunit.fused_residual_unit_stream.launches == before + 1
        want, want_halo = resunit.residual_unit_stream_reference(x, halo, *w, d)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(new_halo, want_halo)


@pytest.mark.parametrize("precision", ["float32", "hybrid", "bfloat16", "int8"])
def test_exported_codec_on_card_matches_live(tmp_path, precision):
    """A small codec's artifact on the card: codes equal to the live codec's,
    waves within phase 13's limits (1e-5 max abs float32, 1e-3 err/scale
    hybrid and bfloat16) and bit-equal under int8, and the live path's
    launches. The int8 case takes the flagship's decoder width (1536) at
    the default threshold, so that it quantizes what the flagship's decode
    does: the first two transposed convs through `torch._int_mm`, block 0's
    units (C = 768) in the int8 unit, block 1's in the float32-in/out act
    form; no encoder conv or unit quantizes, as at the flagship."""
    _need_cuda()
    from facodec_tpu_torch.utils import export

    fields = SMALL_CODEC
    if precision == "int8":
        fields = dict(SMALL_CODEC, decoder=dict(SMALL_CODEC["decoder"], channels=1536))
    codec = FACodec.from_fields(fields, seed=5, device="cuda", precision=precision)
    export.export_codec(codec, str(tmp_path), batch=2, seconds=1.0,
                        functions=("encode_masked", "reconstruct_masked"))
    exp = export.ExportedCodec(str(tmp_path))
    params = export.codec_params(codec)
    w = torch.from_numpy(sweep_wave(2, 1.0, seed=9)).cuda()
    lens = torch.tensor([24000, 15000], dtype=torch.int32, device="cuda")
    f_ = resunit.fused_residual_unit
    counters = (f_, "launches"), (f_, "bf16_launches"), (f_, "f32io_launches"), \
        (f_, "f32io_act_launches"), (f_, "int8_amax_launches"), (f_, "int8_launches"), \
        (vq.nearest_code, "launches")

    def counts():
        torch.cuda.synchronize()
        return [getattr(f, a) for f, a in counters]

    c0 = counts()
    got = exp.reconstruct_masked(params, w, lens)
    c1 = counts()
    want = codec.decode_latent(codec.encode_tensor(w, lens)[0])
    c2 = counts()
    assert [b - a for a, b in zip(c0, c1)] == [b - a for a, b in zip(c1, c2)]
    codes = exp.encode_masked(params, w, lens)[:3]
    for a, b in zip(codes, codec.encode_tensor(w, lens)[1]):
        assert torch.equal(a, b)
    if precision == "float32":
        assert (got - want).abs().max().item() <= 1e-5
    elif precision == "int8":
        assert [b - a for a, b in zip(c0, c1)] == [0, 18, 0, 3, 3, 3, 6]
        nodes = Counter(str(n.target) for n in exp.program("reconstruct_masked").graph.nodes
                        if n.op == "call_function")
        assert (nodes["facodec.resunit_int8_amax.default"], nodes["facodec.resunit_int8.default"],
                nodes["aten._int_mm.default"]) == (3, 3, 2), nodes
        assert torch.equal(got, want)
    else:
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3


# ------------------------------------------------------------ data parallelism
DP_FIELDS = dict(TRAIN_FIELDS, quantizer=dict(SMALL_CODEC["quantizer"], quantizer_dropout=0.5,
                                              prob_random_mask_residual=0.75))


def _dp_batch(n=4):
    from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch

    ds = PseudoDataset(length=n, seed=0, min_s=1.0, max_s=2.0, n_phones=32, n_speakers=16)
    return segment_batch(collate([ds[i] for i in range(n)]), 8,
                         generator=torch.Generator().manual_seed(0))


def _dp_spawn(world, spec_path, out, *args):
    from facodec_tpu_torch.parallel import ranks

    ranks.spawn_ranks(world, [os.path.join(os.path.dirname(__file__), "dp_harness.py"),
                              str(spec_path), str(out), *args], timeout=600)


def test_two_gloo_ranks_on_one_card_match_one_process(tmp_path):
    """Two ranks on cuda:0 over gloo, 2 rows each of a 4-row batch with
    every draw on, fused and split: the reduced gradients within 1e-4 of
    max|g| per module (the card's gradient standard, chip_smoke.py's
    DP_GRAD_TOL: the card's backward sums some gradients by atomic adds, so
    the one process is not bit-stable either), metrics and updated
    parameters (rtol 2e-3, atol 2e-4) against the one-process step on the
    card, and each rank's launches a step (12 residual-unit and 6 VQ in
    the fused step, twice that in the split step) those of the one process."""
    _need_cuda()
    import dp_harness

    specs = [dict(kind="codec", fields=DP_FIELDS, batch=_dp_batch(), split=s) for s in (0, 1)]
    torch.save(specs, tmp_path / "spec.pt")
    _dp_spawn(2, tmp_path / "spec.pt", tmp_path, "--device", "cuda:0", "--backend", "gloo")
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for i, spec in enumerate(specs):
        one = dp_harness.run_steps(spec, "cuda")
        # the split step runs the generator forward twice
        assert one["launches"] == [[12 * (1 + i), 6 * (1 + i)]]
        for r in range(2):
            assert got[r][i]["launches"] == one["launches"]
        gaps = {}
        for mod, grads in one["grads"].items():
            pairs = [(a, b) for a, b in zip(got[0][i]["grads"][mod], grads) if b is not None]
            scale = max(float(b.abs().max()) for _, b in pairs)
            gaps[mod] = max(float((a - b).abs().max()) for a, b in pairs) / scale
        print(f"split {i}: gradient gaps of max|g| {gaps}")
        assert max(gaps.values()) <= 1e-4, gaps
        for k, v in one["metrics"][0].items():
            np.testing.assert_allclose(got[0][i]["metrics"][0][k], v, rtol=2e-3, atol=2e-4,
                                       err_msg=k)
        for k, v in one["params"].items():
            torch.testing.assert_close(got[0][i]["params"][k], v, rtol=2e-3, atol=2e-4, msg=k)
            assert torch.equal(got[0][i]["params"][k], got[1][i]["params"][k]), k


def test_nccl_world_one_is_bit_equal(tmp_path):
    """One NCCL rank (the torchrun environment at world size 1): two steps
    whose gradients go through the all-reduce, bit-equal to the plain
    process's, codec and redecoder. Both run PyTorch's deterministic
    algorithms (`dp_harness.deterministic`): the card's backward otherwise
    sums some gradients by atomic adds, and two plain steps differ in the
    last bits."""
    _need_cuda()
    import dp_harness

    batch = _dp_batch()
    specs = [dict(kind="codec", fields=DP_FIELDS, batch=batch, steps=2, deterministic=True),
             dict(kind="redecoder", fields=RED_TRAIN_FIELDS, steps=2, deterministic=True,
                  batch={k: batch[k] for k in ("wave_seg", "full_waves", "wave_lens")})]
    torch.save(specs, tmp_path / "spec.pt")
    _dp_spawn(1, tmp_path / "spec.pt", tmp_path, "--device", "cuda")
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    for spec, res in zip(specs, got):
        one = dp_harness.run_steps(spec, "cuda")
        assert res["reduced"][0][0] > 0 and one["reduced"] == [[0, 0], [0, 0]]
        assert res["metrics"] == one["metrics"]
        for k, v in one["params"].items():
            assert torch.equal(res["params"][k], v), k


def test_two_replicas_on_one_card_match_unsharded():
    """shard_inference(["cuda:0", "cuda:0"]) at batch 3 (the pad path):
    codes equal to the unsharded codec's and the timbre within 1e-5; the
    waves within 1e-3 err/scale of the unsharded codec on each replica's
    rows (rows 0-1, then row 2 and a zero row: the same batches), and
    against the unsharded batch-3 call the float32 waves within 1e-5. A
    replica's hybrid decode is another batch's than the batch-3 call's,
    which moves its worst sample by a few bf16 output ulps (2.03e-2 of the
    peak at these widths on the card, 1.12e-2 at the flagship's in
    chip_smoke.py phase 14d): held as tests/test_torch_precision.py holds
    two faithful bf16 decodes, within 2e-2 (HYBRID_BF16) in RMS and 8e-2
    at the worst sample."""
    _need_cuda()
    from facodec_tpu_torch.utils.signals import sweep_wave

    w = sweep_wave(3, 1.0)
    padded = np.concatenate([w, np.zeros_like(w[:1])])
    for precision in ("float32", "hybrid"):
        codec = FACodec.from_fields(SMALL_CODEC, seed=0, device="cuda", precision=precision)
        want_f, want = codec.encode(w), codec.reconstruct(w)
        same = np.concatenate([codec.reconstruct(padded[:2]), codec.reconstruct(padded[2:])])[:3]
        codec.shard_inference(["cuda:0", "cuda:0"])
        before = resunit.fused_residual_unit.launches + resunit.fused_residual_unit.bf16_launches
        got_f, got = codec.encode(w), codec.reconstruct(w)
        after = resunit.fused_residual_unit.launches + resunit.fused_residual_unit.bf16_launches
        codec.replicas.close()
        assert after > before
        for name in ("codes_p", "codes_c", "codes_r"):
            np.testing.assert_array_equal(getattr(got_f, name), getattr(want_f, name))
        np.testing.assert_allclose(got_f.timbre, want_f.timbre, rtol=1e-5, atol=1e-5)
        assert np.abs(got - same).max() <= 1e-3 * np.abs(same).max()
        if precision == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            gap = np.abs(got - want).max() / np.abs(want).max()
            rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
            print(f"hybrid, 2 replicas against the batch-3 call: err/scale {gap:.3e} at the "
                  f"worst sample, {rms:.3e} in RMS")
            assert rms <= 2e-2 and gap < 8e-2, (rms, gap)


# The kernels' launches in one flagship round trip of the bench, by policy:
# the float32 entry, the bf16 entry, its act form, the int8 unit's two
# launches and the VQ search (facodec_tpu_torch/bench.py).
BENCH_LAUNCHES = {"float32": [24, 0, 0, 0, 0, 6], "hybrid": [12, 12, 0, 0, 0, 6],
                  "bfloat16_act": [0, 24, 0, 0, 0, 6], "hybrid_int8": [12, 6, 3, 3, 3, 6]}


@pytest.fixture(scope="module")
def bench_codec():
    from facodec_tpu_torch import bench
    _need_cuda()
    return bench.build_codec(torch.device("cuda"), "float32")


@pytest.mark.parametrize("policy", list(BENCH_LAUNCHES))
def test_bench_round_trip_launches(bench_codec, policy):
    """`bench.timed_rtf`'s call (`reconstruct_tensor` under the policy) at
    flagship width, batch 1 x 1 s: each kernel form launched as its route
    asks, and a finite wave of the input's shape."""
    from facodec_tpu_torch import bench
    codec = bench.with_policy(bench_codec, policy)
    wave = bench.bench_wave(1, 1.0, codec.device)
    codec.reconstruct_tensor(wave)
    f_ = resunit.fused_residual_unit
    names = ("launches", "bf16_launches", "f32io_act_launches", "int8_amax_launches",
             "int8_launches")
    before = [getattr(f_, n) for n in names] + [vq.nearest_code.launches]
    y = codec.reconstruct_tensor(wave)
    torch.cuda.synchronize()
    after = [getattr(f_, n) for n in names] + [vq.nearest_code.launches]
    assert [b - a for a, b in zip(before, after)] == BENCH_LAUNCHES[policy]
    assert y.shape == wave.shape and bool(torch.isfinite(y).all())


# ------------------------------------------- tensor parallelism, validate, webui
TP_DP_FIELDS = dict(DP_FIELDS, fa_predictors=dict(DP_FIELDS["fa_predictors"], n_speakers=4096,
                                                  n_phone_classes=33))


def test_two_gloo_tp_ranks_on_one_card_match_one_process(tmp_path):
    """Two ranks on cuda:0 over gloo as data 1 x model 2 (the speaker heads
    and their biases and `timbre_linear` split by rows, the 33-class phone
    heads refused), every draw on, fused and split: each rank launches the
    one process's kernels a step, and the gradients and parameters gathered
    whole and the metrics hold to the one-process step on the card with
    the data-parallel case's tolerances."""
    _need_cuda()
    import dp_harness

    specs = [dict(kind="codec", fields=TP_DP_FIELDS, batch=_dp_batch(), split=s,
                  tensor_parallel=2, min_elems=1024) for s in (0, 1)]
    torch.save(specs, tmp_path / "spec.pt")
    _dp_spawn(2, tmp_path / "spec.pt", tmp_path, "--device", "cuda:0", "--backend", "gloo")
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for i, spec in enumerate(specs):
        one = dp_harness.run_steps(spec, "cuda")
        assert one["launches"] == [[12 * (1 + i), 6 * (1 + i)]]
        for r in range(2):
            assert got[r][i]["launches"] == one["launches"]
            assert got[r][i]["rows"] == [0, 4] and got[r][i]["model"][0][0] > 0
        assert len(got[0][i]["sharded"]) == 5 and got[0][i]["sharded"] == got[1][i]["sharded"]
        gaps = {}
        for mod, grads in one["grads"].items():
            pairs = [(a, b) for a, b in zip(got[0][i]["grads"][mod], grads) if b is not None]
            scale = max(float(b.abs().max()) for _, b in pairs)
            gaps[mod] = max(float((a - b).abs().max()) for a, b in pairs) / scale
        print(f"split {i}: gradient gaps of max|g| {gaps}")
        assert max(gaps.values()) <= 1e-4, gaps
        for k, v in one["metrics"][0].items():
            np.testing.assert_allclose(got[0][i]["metrics"][0][k], v, rtol=2e-3, atol=2e-4,
                                       err_msg=k)
        for k, v in one["params"].items():
            torch.testing.assert_close(got[0][i]["params"][k], v, rtol=2e-3, atol=2e-4, msg=k)
            assert torch.equal(got[0][i]["params"][k], got[1][i]["params"][k]), k


# SMALL_CODEC in the reference schema, as JSON (no pyyaml on the card's machine)
SMALL_CONFIG = dict(preprocess_params=dict(sr=24000), model_params=dict(
    causal=True, lstm=1, norm_f0=True, use_gr_content_f0=False, use_gr_prosody_phone=False,
    use_gr_timbre_prosody=False, separate_prosody_encoder=True, n_c_codebooks=2,
    timbre_norm=True, use_gr_content_global_f0=True, latent_dim=64, codebook_size=32,
    style_hidden_dim=32, prosody_hidden_dim=16,
    DAC=dict(encoder_dim=32, encoder_rates=[2, 5, 5, 6], decoder_dim=512,
             decoder_rates=[6, 5, 5, 2], sr=24000)))


def test_validate_on_card_against_cpu_golden(tmp_path, capsys):
    """`validate --golden` on the card from a seeded checkpoint in the
    reference's layout, the golden made by the port on the CPU: the JSON
    line and an exit code that agrees with it, codes >= 0.99 equal to the
    golden's (chip_smoke.py's card-vs-CPU rule), mel_l1 within 0.05 (the
    JAX package's test threshold for random weights), and the kernels
    launched."""
    _need_cuda()
    import argparse
    import json

    from facodec_tpu_torch.cli import validate

    config = str(tmp_path / "config.json")
    with open(config, "w") as f:
        json.dump(SMALL_CONFIG, f)
    cpu = FACodec.from_config(config, seed=5, device="cpu")
    ckpt = str(tmp_path / "pytorch_model.bin")
    torch.save({k: getattr(cpu, k).state_dict() for k in ("encoder", "quantizer", "decoder")},
               ckpt)
    wave = validate._test_wave("", 1.0)
    g = cpu.encode(wave[None])
    golden = str(tmp_path / "golden.npz")
    np.savez(golden, codes_p=g.codes_p, codes_c=g.codes_c, codes_r=g.codes_r, timbre=g.timbre,
             recon=cpu.reconstruct(wave[None]))
    p = argparse.ArgumentParser()
    validate.add_args(p)
    before = resunit.fused_residual_unit.launches, vq.nearest_code.launches
    rc = validate.main(p.parse_args(["--ckpt", ckpt, "--config", config, "--golden", golden,
                                     "--seconds", "1.0", "--mel-threshold", "0.05"]))
    torch.cuda.synchronize()
    assert resunit.fused_residual_unit.launches > before[0] and vq.nearest_code.launches > before[1]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    print(out)
    assert rc == (0 if out["pass"] else 1)
    assert out["mel_l1"] <= 0.05
    card = FACodec.from_config(config, ckpt, device="cuda").encode(wave[None])
    same = sum(int((getattr(card, n) == getattr(g, n)).sum()) for n in ("codes_p", "codes_c",
                                                                        "codes_r"))
    total = sum(getattr(g, n).size for n in ("codes_p", "codes_c", "codes_r"))
    assert same / total >= 0.99


def test_webui_handlers_card_equal_cpu():
    """`webui.make_handlers` on the card against the same handlers on the
    CPU (one seed each): do_reconstruct on 1 s of int16 at 16 kHz and
    do_convert on two 0.5 s clips within 33 LSB (1e-3 of full scale, the
    float32 round trip's card-vs-CPU rule), with the kernels launched."""
    _need_cuda()
    from facodec_tpu_torch import webui

    def handlers(device):
        return webui.make_handlers(FACodec.from_fields(SMALL_CODEC, seed=0, device=device),
                                   FARedecoder.from_fields(SMALL_REDECODER, seed=1,
                                                           device=device))

    card, host = handlers("cuda"), handlers("cpu")
    rng = np.random.default_rng(0)
    rec_in = (16000, (0.3 * np.sin(np.arange(16000) * 0.05) * 32767).astype(np.int16))
    vc_in = tuple((24000, (0.2 * rng.standard_normal(12000) * 32767).astype(np.int16))
                  for _ in range(2))
    for i, args in ((0, (rec_in,)), (1, vc_in)):
        before = resunit.fused_residual_unit.launches, vq.nearest_code.launches
        got = card[i](*args)
        assert resunit.fused_residual_unit.launches > before[0]
        assert vq.nearest_code.launches > before[1]
        want = host[i](*args)
        assert got[0] == want[0] == 24000 and got[1].dtype == np.int16
        assert got[1].shape == want[1].shape
        assert np.abs(got[1].astype(np.int32) - want[1].astype(np.int32)).max() <= 33


# ------------------------------------------------- W8A8 LSTM recurrence
# csrc/lstm_int8.cu against its plain version: batch 1, 4, 33 and 128 (RT =
# 1, 4; at H = 1536 shared memory holds 16 rows a chunk, so 33 rows are three
# chunks and the 128 streams of a full BatchedStreamGroup eight), widths from
# a one-unit CTA to the decoder's 1536, one step to 64. y and hT within 1e-3, cT within 2e-3:
# both sum the int8 products exactly and round alike, so they part only
# where expf or tanhf differ in a last bit and a quantized h then rounds
# the other way.
LSTM_INT8_CASES = [(B, H, T) for B in (1, 4, 33, 128) for H in (16, 96, 1536)
                   for T in (1, 7, 64)]
LSTM_INT8_TOL = dict(y=1e-3, hT=1e-3, cT=2e-3)


def _lstm_int8_args(B, H, T, given, seed=0):
    from facodec_tpu_torch.ops.kernels import lstm

    g = torch.Generator(device="cuda").manual_seed(seed + B + H + T)
    w_hh = (2 * torch.rand(4 * H, H, device="cuda", generator=g) - 1) / H ** 0.5
    x_proj = 0.5 * torch.randn(B, T, 4 * H, device="cuda", generator=g)
    h0, c0 = ((0.5 * torch.randn(B, H, device="cuda", generator=g)) if given
              else torch.zeros(B, H, device="cuda") for _ in range(2))
    return (x_proj, *lstm.quantize_weight(w_hh), h0, c0)


def _assert_lstm_close(got, want):
    for name, a, b in zip(("y", "hT", "cT"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        err = float((a - b).abs().max())
        assert err <= LSTM_INT8_TOL[name], (name, err)


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("B,H,T", LSTM_INT8_CASES)
def test_lstm_int8_kernel_matches_plain(B, H, T, given):
    _need_cuda()
    from facodec_tpu_torch.ops.kernels import lstm

    args = _lstm_int8_args(B, H, T, given)
    before = lstm.lstm_int8.launches
    got = lstm.lstm_int8(*args)
    assert lstm.lstm_int8.launches == before + 1
    want = lstm.lstm_int8_reference(*args)
    torch.cuda.synchronize()
    _assert_lstm_close(got, want)
    assert torch.equal(got[0][:, -1], got[1])
    p = lstm.plan(B, H, args[0].device)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert p["ctas"] <= sms and p["ctas"] * p["units_a_cta"] >= H
    if H == 1536 and B > 4:
        assert p["rows_a_chunk"] < B  # the batch runs in several row chunks


@pytest.mark.parametrize("split", [1, 13, 63])
def test_lstm_int8_kernel_chunked_equals_one_shot(split):
    """Carrying (h, c) across a chunk boundary gives the one-shot bits."""
    _need_cuda()
    from facodec_tpu_torch.ops.kernels import lstm

    x_proj, w_q, w_scale, h0, c0 = _lstm_int8_args(4, 1536, 64, True)
    y, hT, cT = lstm.lstm_int8(x_proj, w_q, w_scale, h0, c0)
    ya, ha, ca = lstm.lstm_int8(x_proj[:, :split].contiguous(), w_q, w_scale, h0, c0)
    yb, hb, cb = lstm.lstm_int8(x_proj[:, split:].contiguous(), w_q, w_scale, ha, ca)
    assert torch.equal(y, torch.cat([ya, yb], 1))
    assert torch.equal(hT, hb) and torch.equal(cT, cb)
    assert torch.equal(lstm.lstm_int8(x_proj, w_q, w_scale, h0, c0)[0], y)  # deterministic


@pytest.mark.parametrize("fault", ["strided", "float64", "w_q_shape", "odd_width"])
def test_lstm_int8_kernel_rejects(fault):
    _need_cuda()
    from facodec_tpu_torch.ops.kernels import lstm

    args = list(_lstm_int8_args(2, 96, 5, False))
    if fault == "strided":
        args[0] = torch.zeros(2, 10, 384, device="cuda")[:, ::2]
    elif fault == "float64":
        args[3] = args[3].double()
    elif fault == "odd_width":  # the kernel reads h's rows as float4s
        args = list(_lstm_int8_args(2, 18, 5, False))
    else:
        args[1] = args[1].t().contiguous()
    before = lstm.lstm_int8.launches
    with pytest.raises((ValueError, TypeError)):
        lstm.lstm_int8(*args)
    assert lstm.lstm_int8.launches == before


def test_lstm_int8_opcheck():
    _need_cuda()
    args = _lstm_int8_args(2, 32, 5, True)
    result = torch.library.opcheck(torch.ops.facodec.lstm_int8.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_slstm_int8_card_matches_cpu(monkeypatch):
    """A 2-layer SLSTM under bfloat16_act and the flag: two launches, the
    card's output and state against the CPU's (the plain version) within the
    kernel's limits, and the flagless route launches nothing."""
    _need_cuda()
    from facodec_tpu_torch.nn.lstm import SLSTM
    from facodec_tpu_torch.ops import precision
    from facodec_tpu_torch.ops.kernels import lstm

    monkeypatch.setenv("FACODEC_LSTM_INT8", "1")
    monkeypatch.setenv("FACODEC_LSTM_INT8_MIN_BYTES", "0")
    torch.manual_seed(0)
    cpu = SLSTM(256, 2).eval()
    card = SLSTM(256, 2).eval()
    card.load_state_dict(cpu.state_dict())
    card.cuda()
    x = torch.randn(3, 40, 256).bfloat16()
    with torch.no_grad(), precision.policy("bfloat16_act"), float32_exact():
        before = lstm.lstm_int8.launches
        y, (h, c) = card(x.cuda(), return_state=True)
        assert lstm.lstm_int8.launches == before + 2
        want = cpu(x, return_state=True)
        monkeypatch.setenv("FACODEC_LSTM_INT8", "0")
        card(x.cuda())
        assert lstm.lstm_int8.launches == before + 2
    _assert_lstm_close((y.cpu(), h.cpu(), c.cpu()), (want[0], *want[1]))


def test_hybrid_codec_int8_lstm_on_card(monkeypatch):
    """The small codec's hybrid decode with the flag (the decoder's 512-wide
    SLSTM qualifies at a lowered threshold): one launch a decode, none
    without the flag and none in the float32 encode; float32's codes; the
    CPU's flagged decode of the same codes within the hybrid card test's
    limits (2.5e-2 in RMS, under 8e-2 of the peak at the worst sample)."""
    _need_cuda()
    from facodec_tpu_torch.ops.kernels import lstm

    monkeypatch.setenv("FACODEC_LSTM_INT8_MIN_BYTES", "0")
    codec = FACodec.from_fields(SMALL_CODEC, seed=2, device="cuda", precision="hybrid")
    cpu = FACodec.from_fields(SMALL_CODEC, seed=2, device="cpu", precision="hybrid")
    w = sweep_wave(2, 1.0, seed=3)
    monkeypatch.setenv("FACODEC_LSTM_INT8", "1")
    before = lstm.lstm_int8.launches
    f = codec.encode(w)
    assert lstm.lstm_int8.launches == before
    y = codec.decode(f)
    torch.cuda.synchronize()
    assert lstm.lstm_int8.launches == before + 1
    want = FACodec(codec.encoder, codec.quantizer, codec.decoder).encode(w)
    for name in ("codes_p", "codes_c", "codes_r"):
        np.testing.assert_array_equal(getattr(f, name), getattr(want, name))
    y_cpu = cpu.decode(f)
    err = np.abs(y - y_cpu).max() / np.abs(y_cpu).max()
    rms = np.sqrt(np.mean((y - y_cpu) ** 2) / np.mean(y_cpu ** 2))
    assert rms <= 2.5e-2 and err < 8e-2, (rms, err)
    monkeypatch.setenv("FACODEC_LSTM_INT8", "0")
    codec.decode(f)
    assert lstm.lstm_int8.launches == before + 1


def test_streamed_hybrid_decode_int8_lstm_on_card(monkeypatch):
    """A StreamingFACodec decode under bfloat16_act with the flag (the
    decoder's 512-wide SLSTM qualifies at a lowered threshold), a first
    chunk of the decoder's span and then 4-frame chunks: one launch a chunk,
    the card's wave against the CPU's session within the hybrid card test's
    limits, and the card's final (h, c) within the kernel's."""
    _need_cuda()
    from facodec_tpu_torch.models.streaming import StreamingFACodec, min_first_frames_decoder
    from facodec_tpu_torch.ops import precision
    from facodec_tpu_torch.ops.kernels import lstm

    monkeypatch.setenv("FACODEC_LSTM_INT8", "1")
    monkeypatch.setenv("FACODEC_LSTM_INT8_MIN_BYTES", "0")
    outs = torch.from_numpy(np.random.default_rng(23).standard_normal((2, 40, 64))
                            .astype(np.float32))
    got = {}
    for device in ("cpu", "cuda"):
        codec = FACodec.from_fields(SMALL_CODEC, seed=5, device=device)
        first = -(-min_first_frames_decoder(codec.decoder.rates) // 4) * 4
        sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder, chunk_frames=4)
        bounds = [0, *range(first, 40, 4), 40]
        st, waves, launched = sess.init_decode_state(2), [], set()
        with precision.policy("bfloat16_act"):
            for i, j in zip(bounds, bounds[1:]):
                before = lstm.lstm_int8.launches
                st, y = sess.decode_chunk(st, outs[:, i:j].to(device))
                launched.add(lstm.lstm_int8.launches - before)
                waves.append(y.float().cpu())
        assert launched == ({1} if device == "cuda" else {0}), launched
        h, c = st[0]["model_1"]  # the decoder SLSTM's (h, c)
        got[device] = torch.cat(waves, 1).numpy(), h.cpu(), c.cpu()
    (w_cpu, h_cpu, c_cpu), (w_gpu, h_gpu, c_gpu) = got["cpu"], got["cuda"]
    assert w_gpu.shape == w_cpu.shape == (2, 40 * 300) and np.isfinite(w_gpu).all()
    err = np.abs(w_gpu - w_cpu).max() / np.abs(w_cpu).max()
    rms = np.sqrt(np.mean((w_gpu - w_cpu) ** 2) / np.mean(w_cpu ** 2))
    assert rms <= 2.5e-2 and err < 8e-2, (rms, err)
    assert float((h_gpu - h_cpu).abs().max()) <= LSTM_INT8_TOL["hT"]
    assert float((c_gpu - c_cpu).abs().max()) <= LSTM_INT8_TOL["cT"]


def test_exported_flagged_decode_on_card(monkeypatch, tmp_path):
    """The small codec's hybrid decode exported on the card with the flag:
    one `facodec::lstm_int8` node and no `aten.lstm`; the program launches
    the kernel once a call with the flag unset, and its wave is within phase
    13's 1e-3 err/scale of the live flagged decode."""
    _need_cuda()
    from facodec_tpu_torch.ops.kernels import lstm
    from facodec_tpu_torch.utils import export

    monkeypatch.setenv("FACODEC_LSTM_INT8_MIN_BYTES", "0")
    monkeypatch.setenv("FACODEC_LSTM_INT8", "1")
    codec = FACodec.from_fields(SMALL_CODEC, seed=5, device="cuda", precision="hybrid")
    export.export_codec(codec, str(tmp_path), batch=2, seconds=1.0, functions=("decode",))
    exp = export.ExportedCodec(str(tmp_path))
    nodes = Counter(str(n.target) for n in exp.program("decode").graph.nodes
                    if n.op == "call_function")
    assert nodes["facodec.lstm_int8.default"] == 1 and nodes["aten.lstm.input"] == 0
    w = torch.from_numpy(sweep_wave(2, 1.0, seed=9)).cuda()
    _, codes, timbre = codec.encode_tensor(w)
    want = codec.decode_tensor(*codes, timbre)
    monkeypatch.setenv("FACODEC_LSTM_INT8", "0")
    before = lstm.lstm_int8.launches
    got = exp.decode(export.codec_params(codec), *codes, timbre)
    torch.cuda.synchronize()
    assert lstm.lstm_int8.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-3
