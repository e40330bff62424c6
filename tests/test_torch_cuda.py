"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and skip elsewhere; they import nothing of
JAX, so they run on a card's host that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

import torch

from repro_torch.core.gp_fast import IncrementalGP
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import gemm as kgemm
from repro_torch.kernels import matern_gp as kgp


@pytest.fixture
def card():
    """cuda:0, or a skip where there is none (decided per test, never at
    import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gp_inputs(t, N, d, nu, device, seed=5):
    rng = np.random.default_rng(seed)
    Xc = rng.random((N, d)).astype(np.float32)
    g = IncrementalGP(Xc, max_obs=64, kernel=nu, ell=2.0)
    for _ in range(t):
        g.add(Xc[rng.integers(N)], float(rng.normal(10, 3)))
    return [torch.from_numpy(x).to(device) for x in
            (Xc,) + ops.gp_inputs_from_incremental(g)[:4]]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-3)),
                                       (torch.bfloat16, (3e-2, 3e-2))])
@pytest.mark.parametrize("blocks", [(64, 64, 64), (128, 128, 64),
                                    (128, 64, 256)])
def test_gemm_kernel_matches_plain(card, dtype, tol, blocks):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(256, 512))).to(card, dtype)
    b = torch.from_numpy(rng.normal(size=(512, 384))).to(card, dtype)
    bm, bn, bk = blocks
    if 384 % bn:
        pytest.skip("block_n does not tile N=384")
    kgemm.launches = 0
    got = kgemm.gemm(a, b, block_m=bm, block_n=bn, block_k=bk)
    want = ref.gemm(a, b)
    torch.cuda.synchronize()
    assert kgemm.launches == 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


def test_gemm_refused_launch_raises_launch_refused(card):
    """1,024 threads of 115 registers exceed the SM's 65,536: the card
    refuses the launch, which the objective journals as invalid."""
    a = torch.zeros((1024, 1024), device=card)
    kgemm.launches = 0
    with pytest.raises(_build.LaunchRefused):
        kgemm.gemm(a, a, block_m=256, block_n=256, block_k=64)
    assert kgemm.launches == 0
    torch.cuda.synchronize()                  # the context is intact


@pytest.mark.parametrize("nu", ["matern12", "matern32", "matern52", "rbf"])
@pytest.mark.parametrize("t,N,d", [(13, 512, 6), (37, 1024, 15)])
def test_gp_kernel_matches_plain(card, nu, t, N, d):
    args = _gp_inputs(t, N, d, nu, card)
    kgp.launches = 0
    mean_k, var_k = kgp.gp_posterior(*args, ell=2.0, nu=nu, block_n=256)
    mean_r, var_r = ref.gp_posterior(*args[:4], 2.0, nu, mask=args[4])
    torch.cuda.synchronize()
    assert kgp.launches == 1
    torch.testing.assert_close(var_k, var_r, rtol=3e-3, atol=1e-4)
    rng_m = float(mean_r.max() - mean_r.min())
    assert float((mean_k - mean_r).abs().max()) < 0.03 * rng_m


def test_gp_kernel_takes_t_512(card):
    """A warm-started run pads T to 512: the kernel runs it (about 104 KB
    of shared memory) and agrees with its plain version."""
    args = _gp_inputs(37, 1024, 15, "matern32", card)
    x_obs = torch.zeros((512, 15), device=card)
    x_obs[:128] = args[1]
    vinv = torch.zeros((512, 512), device=card)
    vinv[:128, :128] = args[2]
    w = torch.zeros(512, device=card)
    w[:128] = args[3]
    mask = torch.zeros(512, device=card)
    mask[:128] = args[4]
    mean_k, var_k = kgp.gp_posterior(args[0], x_obs, vinv, w, mask,
                                      block_n=128)
    mean_r, var_r = ref.gp_posterior(args[0], x_obs, vinv, w, 2.0,
                                     mask=mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(var_k, var_r, rtol=3e-3, atol=1e-4)
    rng_m = float(mean_r.max() - mean_r.min())
    assert float((mean_k - mean_r).abs().max()) < 0.03 * rng_m
