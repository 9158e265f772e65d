"""The port's kernel modules against the JAX package, on the CPU.

Each kernel wrapper of facodec_tpu_torch runs its plain PyTorch version on a
CPU tensor; these tests hold that version against the JAX module on the same
numpy inputs: the XLA path and the Pallas kernel in interpret mode. The CUDA
kernels are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facodec_tpu.models.dac import ResidualUnit as JResidualUnit
from facodec_tpu.nn.activations import sin2 as jsin2
from facodec_tpu.ops.fused import enable_fused
from facodec_tpu.ops.pallas.vq import nearest_code_pallas
from facodec_tpu.ops.vq_math import nearest_code as jnearest_code
from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.nn.activations import sin2
from facodec_tpu_torch.ops.kernels import resunit, vq
from facodec_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX package's golden tolerance


@pytest.fixture(autouse=True)
def _reset_flag():
    yield
    enable_fused(False)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_residual_unit_matches_jax(dilation, causal, backend):
    C, T = 64, 4800
    x = (0.5 * np.random.default_rng(dilation).standard_normal((1, T, C))).astype(np.float32)
    junit = JResidualUnit(C, dilation=dilation, causal=causal)
    params = junit.init(jax.random.PRNGKey(dilation), jnp.asarray(x))["params"]
    # the flag is read while tracing: one fresh jit per setting
    enable_fused(backend == "pallas")
    want = np.asarray(jax.jit(lambda p, v: junit.apply({"params": p}, v))(params, x))

    unit = ResidualUnit(C, dilation=dilation, causal=causal)
    load_jax_params(unit, params)
    with torch.no_grad():
        got = unit(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _vq_case(case):
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 100, 8)).astype(np.float32)
    cb = rng.standard_normal((1024, 8)).astype(np.float32)
    if case == "duplicate_rows":
        # equal rows score equal: the first index must win
        cb[700] = cb[10]
        cb[901] = cb[3]
        lat[0, :50] = 2.5 * cb[10]
        lat[1, :50] = 0.5 * cb[3]
    return lat, cb


@pytest.mark.parametrize("reference", ["vq_math", "pallas"])
@pytest.mark.parametrize("case", ["random", "duplicate_rows"])
def test_nearest_code_matches_jax(case, reference):
    lat, cb = _vq_case(case)
    if reference == "pallas":
        want_idx, want_zq = nearest_code_pallas(jnp.asarray(lat), jnp.asarray(cb), interpret=True)
    else:
        want_idx, want_zq = jnearest_code(jnp.asarray(lat), jnp.asarray(cb))
    idx, zq = vq.nearest_code(torch.from_numpy(lat), torch.from_numpy(cb))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(zq.numpy(), np.asarray(want_zq))
    if case == "duplicate_rows":
        assert (idx[0, :50] == 10).all() and (idx[1, :50] == 3).all()


def test_sin2_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.linspace(-4e4, 4e4, 400_001, dtype=np.float32),
        rng.uniform(-10, 10, 100_000).astype(np.float32),
    ])
    want = np.asarray(jax.jit(jsin2)(jnp.asarray(x)))
    got = sin2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _resunit_args(C=64, T=300, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, T, C, generator=g, dtype=dtype),
            torch.randn(C, C, 7, generator=g, dtype=dtype), torch.zeros(C, dtype=dtype),
            torch.randn(C, C, 1, generator=g, dtype=dtype), torch.zeros(C, dtype=dtype),
            torch.ones(1, C, 1, dtype=dtype), torch.ones(1, C, 1, dtype=dtype)]


@pytest.mark.parametrize("fault", ["dtype", "weight_shape", "rank"])
def test_resunit_wrapper_rejects(fault):
    args = _resunit_args(dtype=torch.float64 if fault == "dtype" else torch.float32)
    if fault == "weight_shape":
        args[1] = args[1][:, :, :5]
    if fault == "rank":
        args[0] = args[0][0]
    before = resunit.fused_residual_unit.launches
    with pytest.raises(TypeError if fault == "dtype" else ValueError):
        resunit.fused_residual_unit(*args, dilation=1, causal=True)
    assert resunit.fused_residual_unit.launches == before


@pytest.mark.parametrize("fault", ["dtype", "width"])
def test_vq_wrapper_rejects(fault):
    lat = torch.zeros(4, 8, dtype=torch.float64 if fault == "dtype" else torch.float32)
    cb = torch.ones(16, 8 if fault == "dtype" else 4)
    before = vq.nearest_code.launches
    with pytest.raises(TypeError if fault == "dtype" else ValueError):
        vq.nearest_code(lat, cb)
    assert vq.nearest_code.launches == before


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """a rounded to TF32 (10 mantissa bits), ties away from zero, as
    `cvt.rna.tf32.f32` rounds it."""
    bits = a.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_3xtf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as csrc/resunit.cu takes it: hi = tf32(x), lo = x - hi, each
    k-step of 8 sums lo*hi' + hi*lo' + hi*hi' (TF32 products are exact in
    float32) into a fresh float32 sum, which is then added to the running one."""
    ah = _tf32_rna(a)
    bh = _tf32_rna(b)
    al, bl = a - ah, b - bh
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = acc + (al[:, s] @ bh[s] + ah[:, s] @ bl[s] + ah[:, s] @ bh[s])
    return acc


@pytest.mark.parametrize("C", [64, 256, 768])
def test_3xtf32_sum_keeps_float32_error(C):
    """The conv7's reduction (K = 7 * C) in 3xTF32 stays within 4x the error
    of a float32 product against float64; one TF32 product does not."""
    rng = np.random.default_rng(C)
    K = 7 * C
    a = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 64)) / np.sqrt(K)).astype(np.float32))
    exact = a.double() @ b.double()
    err_f32 = ((a @ b).double() - exact).abs().max().item()
    err_3x = (_split_3xtf32_matmul(a, b).double() - exact).abs().max().item()
    err_tf32 = ((_tf32_rna(a) @ _tf32_rna(b)).double() - exact).abs().max().item()
    assert err_3x <= 4 * err_f32, (err_3x, err_f32)
    assert err_tf32 >= 50 * err_f32, (err_tf32, err_f32)


def test_tf32_rna_rounds_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(_tf32_rna(x), want)
