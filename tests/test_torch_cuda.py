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
