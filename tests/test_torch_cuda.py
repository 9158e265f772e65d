"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips where torch sees no CUDA device. This file
imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from facodec_tpu_torch.api import float32_exact
from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.kernels import resunit, vq

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("C,dilation,T", [(32, 3, 500), (64, 1, 1000), (96, 9, 777),
                                          (192, 3, 40), (768, 9, 1000)])
def test_resunit_kernel_matches_plain(C, dilation, T, causal):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(C + dilation)
    x = torch.randn(2, T, C, device="cuda", generator=g)
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
