"""Plain PyTorch versions of the port's kernels (the allclose references).

Mirrors ``repro/kernels/ref.py``: the same arithmetic, written with torch
tensor ops, plus the flash-decode split pass and combine (the reference
keeps those beside its kernel, ``repro/kernels/flash_decode.py``). The
kernel wrappers take these only for tensors on the CPU; on the card they are
what the CUDA kernels are checked against.
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


# -- flash attention ---------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Attention, causal unless ``causal=False`` (the reference's
    default and its full mode). q (B,S,H,hd), k/v (B,S,KV,hd) with KV
    dividing H (KV == H is the reference's MHA core; a smaller KV is
    expanded, head h reading KV head h // G as ``jnp.repeat`` does). fp32
    softmax, probabilities cast to v's dtype before the product, result in
    q's dtype."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask[None, None], -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


# -- flash decode (split pass + combine) --------------------------------------

def decode_split(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, bias: torch.Tensor, num_splits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split pass of flash decode, as whole-split softmax sums.

    q (B,H,hd); caches (B,S,KV,hd); bias (B,Sp) fp32, 0 valid / -inf masked,
    with Sp >= S a multiple of ``num_splits`` (slots past S are padding and
    must be masked). Returns unnormalized partials o (B,KV,splits,G,hd) and
    m, l (B,KV,splits,G), fp32: per split, m = max score, l = Σ exp(s − m),
    o = Σ exp(s − m)·v with the weights cast to v's dtype. A split whose
    every slot is masked gives m = −inf, l = 0, o = 0."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    Sp = bias.shape[1]
    G = H // KV
    if Sp > S:
        pad = (0, 0, 0, 0, 0, Sp - S)
        k_cache = torch.nn.functional.pad(k_cache, pad)
        v_cache = torch.nn.functional.pad(v_cache, pad)
    L = Sp // num_splits
    qg = q.reshape(B, KV, G, hd)
    kk = k_cache.reshape(B, num_splits, L, KV, hd)
    vv = v_cache.reshape(B, num_splits, L, KV, hd)
    # both products accumulate in fp32 from the stored values, as the
    # kernel's do (the reference's preferred_element_type=float32)
    s = torch.einsum("bkgh,bnlkh->bkngl", qg.float(),
                     kk.float()) * (hd ** -0.5)
    s = s + bias.reshape(B, 1, num_splits, 1, L)
    m = s.amax(dim=-1)                                      # (B,KV,n,G)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])                    # exp(-inf) = 0
    l = p.sum(dim=-1)
    o = torch.einsum("bkngl,bnlkh->bkngh", p.to(v_cache.dtype).float(),
                     vv.float())
    return o, m, l


def combine_partials(o_part: torch.Tensor, m_part: torch.Tensor,
                     l_part: torch.Tensor) -> torch.Tensor:
    """Merge per-split (o, m, l) into normalized attention (B,KV,G,hd) fp32:
    weight each split by exp(m_i − max m), normalize by the merged l. Copy of
    the reference's ``_combine_partials_jnp`` (``flash_decode.py:78``)."""
    m_tot = m_part.amax(dim=2)                               # (B,KV,G)
    m_safe = torch.where(torch.isfinite(m_tot), m_tot,
                         torch.zeros_like(m_tot))
    w = torch.where(torch.isfinite(m_part),
                    torch.exp(m_part - m_safe[:, :, None, :]),
                    torch.zeros_like(m_part))
    l_tot = torch.sum(w * l_part, dim=2)                     # (B,KV,G)
    o = torch.sum(w[..., None] * o_part, dim=2)              # (B,KV,G,hd)
    return o / torch.clamp(l_tot, min=1e-30)[..., None]


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
