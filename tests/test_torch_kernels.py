"""The port's GEMM and Matérn-GP wrappers against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; they are held
against ``repro.kernels.ops`` (the Pallas kernels in interpret mode) and
``repro.kernels.ref`` on the same numpy inputs, with the shapes, dtypes, ν
values and tolerances of ``tests/test_kernels.py``. The tests that launch
the CUDA kernels are in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.gp_fast import IncrementalGP as JaxIncrementalGP
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core.gp_fast import IncrementalGP
from repro_torch.kernels import gemm as kgemm
from repro_torch.kernels import matern_gp as kgp
from repro_torch.kernels import ops, ref
from repro_torch.launch.roofline import SMEM_PER_BLOCK

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


# -- GEMM --------------------------------------------------------------------

@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (256, 384, 512),
                                   (512, 128, 256)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gemm_shapes_dtypes_match_reference(M, N, K, dtype):
    rng = np.random.default_rng(0)
    a_np, b_np = rng.normal(size=(M, K)), rng.normal(size=(K, N))
    ja, jb = jnp.asarray(a_np, dtype), jnp.asarray(b_np, dtype)
    ta = torch.from_numpy(a_np).to(TORCH_DTYPE[dtype])
    tb = torch.from_numpy(b_np).to(TORCH_DTYPE[dtype])
    out = ops.gemm(ta, tb, block_m=128, block_n=128, block_k=128)
    assert out.dtype == ta.dtype and out.shape == (M, N)
    tol = 1e-4 if dtype == jnp.float32 else 3e-2
    for want in (jref.gemm(ja, jb),
                 jops.gemm(ja, jb, block_m=128, block_n=128, block_k=128)):
        np.testing.assert_allclose(_np32(out), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("bm,bn,bk", [(64, 64, 64), (128, 64, 256)])
def test_gemm_block_configs_match_reference(bm, bn, bk):
    rng = np.random.default_rng(1)
    a_np, b_np = rng.normal(size=(256, 256)), rng.normal(size=(256, 256))
    ja, jb = jnp.asarray(a_np, jnp.float32), jnp.asarray(b_np, jnp.float32)
    out = ops.gemm(torch.from_numpy(a_np).float(),
                   torch.from_numpy(b_np).float(),
                   block_m=bm, block_n=bn, block_k=bk)
    for want in (jref.gemm(ja, jb),
                 jops.gemm(ja, jb, block_m=bm, block_n=bn, block_k=bk)):
        np.testing.assert_allclose(_np32(out), np.asarray(want),
                                   rtol=1e-4, atol=1e-3)


def test_gemm_rejects_indivisible():
    a = torch.zeros((100, 128))
    b = torch.zeros((128, 128))
    with pytest.raises(ValueError, match="not divisible"):
        ops.gemm(a, b, block_m=64, block_n=64, block_k=64)
    with pytest.raises(ValueError, match="inner dims"):
        ops.gemm(torch.zeros((64, 64)), torch.zeros((128, 64)),
                 block_m=64, block_n=64, block_k=64)


def test_cpu_tensors_leave_launch_counters_at_zero():
    kgemm.launches = kgp.launches = 0
    a = torch.randn(128, 128)
    ops.gemm(a, a, block_m=64, block_n=64, block_k=64)
    g = _gp_state(13, 256, 6, "matern32")[0]
    x_obs, vinv, w, mask, _, _ = ops.gp_inputs_from_incremental(g)
    ops.gp_posterior(*(torch.from_numpy(x) for x in
                       (g.Xc.astype(np.float32), x_obs, vinv, w, mask)),
                     block_n=128)
    assert kgemm.launches == 0 and kgp.launches == 0


# -- Matérn GP posterior -------------------------------------------------------

def _gp_state(t, N, d, nu, seed=5):
    """The same observations fed to the port's and the reference's
    IncrementalGP (numpy inputs, one seed)."""
    rng = np.random.default_rng(seed)
    Xc = rng.random((N, d)).astype(np.float32)
    g = IncrementalGP(Xc, max_obs=64, kernel=nu, ell=2.0)
    jg = JaxIncrementalGP(Xc, max_obs=64, kernel=nu, ell=2.0)
    for _ in range(t):
        x, y = Xc[rng.integers(N)], float(rng.normal(10, 3))
        g.add(x, y)
        jg.add(x, y)
    return g, jg, Xc


@pytest.mark.parametrize("t,N,d", [(13, 512, 6), (37, 1024, 15)])
@pytest.mark.parametrize("nu", ["matern32", "matern52"])
def test_gp_posterior_matches_reference_and_engine(t, N, d, nu):
    g, jg, Xc = _gp_state(t, N, d, nu)
    packed = ops.gp_inputs_from_incremental(g)
    jpacked = jops.gp_inputs_from_incremental(jg)
    for mine, theirs in zip(packed, jpacked):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))
    x_obs, vinv, w, mask, y_mean, y_std = packed
    mean_k, var_k = ops.gp_posterior(
        *(torch.from_numpy(x) for x in (Xc, x_obs, vinv, w, mask)),
        ell=2.0, nu=nu, block_n=256)
    mean_k, var_k = mean_k.numpy(), var_k.numpy()
    # against the JAX oracle and the Pallas kernel in interpret mode: the
    # variance is well conditioned -> tight; the mean is amplified by
    # ||L^-1||*||w||, so it is bounded by a fraction of its range
    m_j, v_j = jref.gp_posterior(jnp.asarray(Xc), jnp.asarray(x_obs),
                                 jnp.asarray(vinv), jnp.asarray(w), 2.0, nu)
    m_p, v_p = jops.gp_posterior(jnp.asarray(Xc), jnp.asarray(x_obs),
                                 jnp.asarray(vinv), jnp.asarray(w),
                                 jnp.asarray(mask), ell=2.0, nu=nu,
                                 block_n=256)
    for m_r, v_r in ((m_j, v_j), (m_p, v_p)):
        np.testing.assert_allclose(var_k, np.asarray(v_r), rtol=3e-3,
                                   atol=1e-4)
        m_r = np.asarray(m_r)
        rng_m = m_r.max() - m_r.min() + 1e-9
        assert np.abs(mean_k - m_r).max() < 0.03 * rng_m
    # behavioral: fp32 posterior vs the float64 incremental engine
    mu_k = y_mean + y_std * mean_k
    mu_i, _ = g.predict()
    assert np.abs(mu_k - mu_i).max() < 0.05 * (mu_i.max() - mu_i.min())
    assert len(set(np.argsort(mu_k)[:20]) & set(np.argsort(mu_i)[:20])) >= 18


@pytest.mark.parametrize("nu", ["matern12", "matern32", "matern52", "rbf"])
def test_plain_gp_posterior_every_nu_matches_float64_engine(nu):
    """All four ν against the reference's float64 incremental engine. The
    padded, masked call equals the unpadded one, and the smooth kernels
    also match the JAX oracle. (Matérn-1/2 is left out of the oracle check:
    at an observed point the oracle's matmul-form distance cancels to
    ~1e-7 instead of 0, and the kink at r = 0 turns that into ~7e-4 of
    variance; the port's ordered sums cancel to exactly 0.)"""
    g, jg, Xc = _gp_state(21, 384, 8, nu, seed=9)
    x_obs, vinv, w, mask, y_mean, y_std = ops.gp_inputs_from_incremental(g)
    t = g.t
    mean, var = ref.gp_posterior(
        torch.from_numpy(Xc), torch.from_numpy(x_obs[:t]),
        torch.from_numpy(vinv[:t, :t]), torch.from_numpy(w[:t]), 2.0, nu)
    mean, var = mean.numpy(), var.numpy()
    mu_i, sd_i = jg.predict()
    np.testing.assert_allclose(var, (sd_i / y_std) ** 2, rtol=3e-3,
                               atol=1e-4)
    mu_k = y_mean + y_std * mean
    assert np.abs(mu_k - mu_i).max() < 0.05 * (mu_i.max() - mu_i.min())
    assert len(set(np.argsort(mu_k)[:20]) & set(np.argsort(mu_i)[:20])) >= 18
    mean_p, var_p = ref.gp_posterior(
        *(torch.from_numpy(x) for x in (Xc, x_obs, vinv, w)), 2.0, nu,
        mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(var_p.numpy(), var)
    if nu != "matern12":
        m_j, v_j = jref.gp_posterior(jnp.asarray(Xc), jnp.asarray(x_obs[:t]),
                                     jnp.asarray(vinv[:t, :t]),
                                     jnp.asarray(w[:t]), 2.0, nu)
        np.testing.assert_allclose(var, np.asarray(v_j), rtol=3e-3,
                                   atol=1e-4)
        m_j = np.asarray(m_j)
        assert np.abs(mean - m_j).max() < 0.03 * (m_j.max() - m_j.min())


def test_gp_rejects_untileable_candidates():
    x = torch.zeros((300, 4))
    obs = torch.zeros((128, 4))
    with pytest.raises(ValueError, match="not divisible"):
        ops.gp_posterior(x, obs, torch.eye(128), torch.zeros(128),
                         torch.zeros(128), block_n=128)


def test_gp_smem_model_matches_the_kernel_layout():
    # Ks (T x 32, rows padded to 40) + the L^-1 ring (2 x 64 x 64, rows
    # padded to 68) + 3 T-vectors + x_cand tile (32 x odd d) + |x_cand|^2
    # + the 2 x 4 x 32 cross-warp reduction, fp32; x_obs is not staged
    assert kgp.gp_smem_bytes(256, 15) == 4 * (256 * 40 + 2 * 64 * 68
                                              + 3 * 256 + 32 * 15 + 32
                                              + 256)
    # two blocks share an SM's 228 KB at the paper's T = 256 (1 KB each
    # reserved by the runtime); T = 512 and T = 1024 (513 to 1024
    # observations) still fit one, up to d = 16 and past it
    assert 2 * (kgp.gp_smem_bytes(256, 15) + 1024) <= 228 * 1024
    assert kgp.gp_smem_bytes(512, 15) <= SMEM_PER_BLOCK
    assert kgp.gp_smem_bytes(1024, 16) <= SMEM_PER_BLOCK
    assert kgp.gp_smem_bytes(1024, 64) <= SMEM_PER_BLOCK
    assert kgp.gp_smem_bytes(2048, 15) > SMEM_PER_BLOCK
