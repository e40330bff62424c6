"""Plain PyTorch versions of the port's kernels (the allclose references).

Mirrors ``repro/kernels/ref.py``: the same arithmetic, written with torch
tensor ops. The kernel wrappers take these only for tensors on the CPU; on
the card they are what the CUDA kernels are checked against.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)

NUS = ("matern12", "matern32", "matern52", "rbf")


# -- tiled GEMM -------------------------------------------------------------

def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B accumulated in fp32, cast back to A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


# -- Matérn GP posterior (the paper's exhaustive-prediction hot loop) --------

def matern_cov(r: torch.Tensor, ell: float, nu: str = "matern32"
               ) -> torch.Tensor:
    s = r * (1.0 / ell)
    if nu == "matern12":
        return torch.exp(-s)
    if nu == "matern32":
        t = SQRT3 * s
        return (1.0 + t) * torch.exp(-t)
    if nu == "matern52":
        t = SQRT5 * s
        return (1.0 + t + (5.0 / 3.0) * torch.square(s)) * torch.exp(-t)
    if nu == "rbf":
        return torch.exp(-0.5 * torch.square(s))
    raise ValueError(nu)


def gp_posterior(x_cand: torch.Tensor, x_obs: torch.Tensor,
                 vinv_rows: torch.Tensor, w: torch.Tensor, ell: float,
                 nu: str = "matern32", mask=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior over candidates given precomputed L^-1 rows.

    x_cand (N,d), x_obs (t,d), vinv_rows = L^{-1} (t,t) lower, w = L^{-1}y (t,)
    mean = (L^{-1}K_oc)^T w ; var = 1 - colsum((L^{-1}K_oc)^2).
    ``mask`` (t,) zeroes the covariance rows of padded observations, as the
    kernel does; the reference package's oracle has no padding to mask.

    The expanded distance's three sums run over d in index order, each
    product and sum rounded on its own — the order the CUDA kernel rounds
    in. Near r = 0 the expansion cancels, and the Matérn-1/2 kink turns a
    last-bit difference in d2 into a visible one in the covariance.
    """
    o_sq = torch.zeros_like(x_obs[:, 0])
    c_sq = torch.zeros_like(x_cand[:, 0])
    dot = torch.zeros((x_obs.shape[0], x_cand.shape[0]), dtype=x_obs.dtype,
                      device=x_obs.device)
    for k in range(x_obs.shape[1]):
        o_sq = o_sq + x_obs[:, k] * x_obs[:, k]
        c_sq = c_sq + x_cand[:, k] * x_cand[:, k]
        dot = dot + x_obs[:, k, None] * x_cand[None, :, k]
    d2 = (o_sq[:, None] + c_sq[None, :]) - 2.0 * dot
    r = torch.sqrt(torch.clamp(d2, min=0.0))
    K = matern_cov(r, ell, nu)               # (t, N)
    if mask is not None:
        K = K * mask[:, None]
    V = vinv_rows @ K                         # (t, N)
    mean = V.T @ w
    var = torch.clamp(1.0 - torch.sum(V * V, dim=0), min=1e-12)
    return mean, var
