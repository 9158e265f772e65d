"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips where torch sees no CUDA device. This file
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

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
    """A ResidualUnit under bfloat16_act keeps its packed operands (and TMA
    maps) across calls; an in-place weight update repacks, and the kernel
    then follows the new weights. One bf16 launch a call; the packed call
    gives the unpacked entry's bits."""
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
            pack = unit.bf16_pack(x)
            assert pack.maps is not None
            snake1, conv7, snake2, conv1 = unit.block
            args = (conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
                    snake1.alpha, snake2.alpha)
            assert torch.equal(got, resunit.fused_residual_unit(x, *args, d, True))
            _check_bf16_entry((x, *args), d, True)
            conv7.weight_v.add_(0.05 * torch.randn_like(conv7.weight_v))
            conv1.bias.add_(0.3)
        assert unit.bf16_pack(x) is not pack


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
    """The float32 entry's autograd.Function: one kernel launch forward, and
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
    """nearest_code's autograd.Function: one launch; the codebook gradient is
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


def test_train_step_card_matches_cpu():
    """One seed on both devices, every draw off: the card's step (kernels,
    12 residual units and 6 VQ searches in its one generator forward) against
    the CPU's (plain versions): every loss and gradient norm within 1e-3
    relative, and every module's parameters moved alike."""
    _need_cuda()
    from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch, to_device
    from facodec_tpu_torch.train.loop import build_models
    from facodec_tpu_torch.train.optimizers import build_optimizers
    from facodec_tpu_torch.train.step import make_codec_train_step

    ds = PseudoDataset(length=2, seed=0, min_s=1.0, max_s=2.0, n_phones=32, n_speakers=16)
    seg = segment_batch(collate([ds[0], ds[1]], 80), 8, generator=torch.Generator().manual_seed(0))
    out = {}
    for device in ("cpu", "cuda"):
        models = _no_dropout(build_models(TRAIN_FIELDS, 3, device))
        step = make_codec_train_step(models, build_optimizers(models))
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
