"""Kernel wrappers + tunable config spaces + the Hopper resource model.

Port of ``repro/kernels/ops.py`` for all five kernels: GEMM, Matérn-GP
posterior, flash attention and split-KV flash decode. Each kernel exposes a
SearchSpace (the reference's grid and constraints) whose invalid
region is the card's resource model — threads per block, shared memory per
block, registers, the block sizes the kernel is built for — in place of the
reference's TPU VMEM budget: the structure the paper tunes on GPUs. An
invalid config is the paper's invalid configuration: journaled as NaN and
never fitted to the surrogate.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.searchspace import Param, SearchSpace
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import matern_gp as _mgp
from repro_torch.launch.roofline import (MAX_REGS_PER_THREAD, REGS_PER_SM,
                                         SMEM_PER_BLOCK)

#: Registers per thread of the GEMM kernel's builds, by dtype bytes, as
#: ``_build.lib().gemm_attrs`` reports them (nvcc 12.8, sm_90a): fp32 holds
#: 64 accumulators, the 64 of a ring stage's partial sum and the split
#: fragments; bf16 the 64 accumulators and its fragments. Phase 1 of
#: ``chip_smoke.py`` fails when a build reports another count, so this
#: model and the card stay in step.
GEMM_REGS_PER_THREAD = {4: 224, 2: 128}

#: The card allocates a warp's registers in units of 256: 8 a thread.
REG_ALLOC_UNIT = 8


def allocated_regs(regs: int) -> int:
    """Registers the card sets aside for a thread that uses ``regs``."""
    return -(-regs // REG_ALLOC_UNIT) * REG_ALLOC_UNIT


# -- GEMM ---------------------------------------------------------------

def gemm(a, b, block_m=128, block_n=128, block_k=64):
    return _gemm.gemm(a, b, block_m=block_m, block_n=block_n,
                      block_k=block_k)


def gemm_config_space(M: int = 1024, N: int = 1024, K: int = 1024) -> SearchSpace:
    """BO target: thread-block tile shapes. The grid and constraints are the
    reference's, so the space and its fingerprint match; invalid = over the
    card's resources (checked by the objective, not the constraints)."""
    vals = (64, 128, 256, 512, 1024)
    params = [Param("block_m", vals), Param("block_n", vals),
              Param("block_k", vals)]
    cons = [lambda c: M % c["block_m"] == 0,
            lambda c: N % c["block_n"] == 0,
            lambda c: K % c["block_k"] == 0]
    return SearchSpace(params, cons, name="cuda_gemm")


def gemm_valid(cfg: Dict, dtype_bytes: int = 4) -> bool:
    """Hopper resource model of one GEMM block: a warp per 64x32 tile of C,
    32 threads up to the kernel's launch bound (256 in fp32, 512 in bf16);
    a cp.async ring of at least 2 stages of padded A and B tiles within 227
    KB of shared memory (fewer than 2 is a static invalid); and the block's
    registers, as the card allocates them, within the SM's 65,536 (each
    thread within 255)."""
    regs = GEMM_REGS_PER_THREAD[dtype_bytes]
    bm, bn, bk = cfg["block_m"], cfg["block_n"], cfg["block_k"]
    threads = _gemm.gemm_threads(bm, bn)
    smem = _gemm.gemm_smem_bytes(bm, bn, bk, dtype_bytes)
    return (bm % _gemm.WARP_M == 0 and bn % _gemm.WARP_N == 0
            and 32 <= threads <= _gemm.MAX_THREADS[dtype_bytes]
            and smem <= SMEM_PER_BLOCK
            and regs <= MAX_REGS_PER_THREAD
            and threads * allocated_regs(regs) <= REGS_PER_SM)


# -- flash attention -----------------------------------------------------

def flash_attention(q, k, v, block_q=128, block_kv=128, causal=True):
    return _fa.flash_attention(q, k, v, block_q=block_q, block_kv=block_kv,
                               causal=causal)


def flash_config_space(S: int = 4096) -> SearchSpace:
    """The reference's grid and constraints."""
    vals = (128, 256, 512, 1024, 2048)
    params = [Param("block_q", vals), Param("block_kv", vals)]
    cons = [lambda c: S % c["block_q"] == 0, lambda c: S % c["block_kv"] == 0]
    return SearchSpace(params, cons, name="cuda_flash")


def flash_valid(cfg: Dict, hd: int, dtype: torch.dtype) -> bool:
    """Hopper resource model of one flash block: a head dim the kernel is
    built for, blocks in whole 64-row sub-tiles, and the block's shared
    memory within 227 KB. bf16: the q sub-tile and the ring of
    max(2, min(8, block_kv / 64)) K/V stages (at hd 256 only block_kv 128
    fits the reference's grid: 2 stages and 128 query rows take 193 KB).
    Registers bind one block of at most two warpgroups to an SM: 128 fp32
    accumulators a thread at hd 256, 256 threads within the SM's 65,536.
    fp32: the q sub-tile, one staged K/V chunk and the 64 x block_kv score
    tile (at hd 256: block_kv 128 and 256 fit, 512 does not). ``block_q``
    sets the grid only; the kernels stream it."""
    bq, bkv = cfg["block_q"], cfg["block_kv"]
    return (hd in _fa.HEAD_DIMS and bq % _fa.SUB_TILE == 0
            and bkv % _fa.SUB_TILE == 0
            and _fa.flash_smem_bytes(bq, bkv, hd, dtype) <= SMEM_PER_BLOCK)


# -- flash decode (single-token cache attention) --------------------------

def decode_attention(q, k_cache, v_cache, cache_pos, cur_pos, window=None,
                     block_kv=512, num_splits=1, combine="kernel", bias=None):
    """Split-KV flash decode over the cache, semantics-matched to
    ``models.layers._decode_attention``: q (B, 1, H, hd), caches
    (B, S, KV, hd), ``cache_pos`` (B, S) absolute positions (-1 = empty
    slot), ``cur_pos`` (B,) the position being decoded. Slot validity —
    empty, future, or evicted by a rolling ``window`` — becomes an additive
    fp32 bias row (0 / -inf). A capacity that does not tile into
    ``num_splits × block_kv`` is padded with masked slots: the reference
    pads K and V too; here only the bias is padded, and the kernel reads no
    slot past the cache. ``bias``, when given, is that row already built
    by :func:`decode_bias` for this cache and tile. Returns (B, 1, H, hd)."""
    if bias is None:
        bias = decode_bias(cache_pos, cur_pos, window, num_splits * block_kv)
    out = _fd.flash_decode(q[:, 0], k_cache, v_cache, bias,
                           block_kv=block_kv, num_splits=num_splits,
                           combine=combine)
    return out[:, None]


def decode_bias(cache_pos, cur_pos, window, tile: int):
    """The (B, Sp) fp32 validity bias of a cache: 0 where a slot holds a
    position in ``(cur_pos - window, cur_pos]``, -inf where it is empty,
    in the future or evicted, and -inf padding up to a multiple of
    ``tile`` (a padding slot is an empty one)."""
    pad = (-cache_pos.shape[1]) % tile
    if pad:
        cache_pos = torch.nn.functional.pad(cache_pos, (0, pad), value=-1)
    valid = (cache_pos >= 0) & (cache_pos <= cur_pos[:, None])
    if window is not None:
        valid &= cache_pos > cur_pos[:, None] - window
    return torch.where(valid, 0.0, -math.inf).to(torch.float32)


def decode_config_space(S: int = 2048) -> SearchSpace:
    """BO target for the decode cell: KV tile length, split count, and the
    cross-split combine. ``S`` is the cache capacity; splits whose leading
    tiles already cover the whole cache are pure overhead and constrained
    out. The reference's grid."""
    params = [Param("block_kv", (128, 256, 512, 1024)),
              Param("num_splits", (1, 2, 4, 8)),
              Param("combine", _fd.COMBINE_STRATEGIES)]
    cons = [lambda c: c["block_kv"] * (c["num_splits"] - 1) < S]
    return SearchSpace(params, cons, name="cuda_flash_decode")


def decode_valid(cfg: Dict, G: int = 1, hd: int = 128) -> bool:
    """Hopper resource model of one split block: a head dim the kernel is
    built for, at most 16 query heads per KV head (a block holds all the
    rows of its head group), and its shared memory (the K/V ring of 64-slot
    tiles, as deep as fits, q and the score tiles) within 227 KB in fp32
    and bf16: at most 226 KB, for every ``block_kv``, which sets the
    splits' length and not the block's tile."""
    return (hd in _fd.HEAD_DIMS and 1 <= G <= _fd.MAX_GROUP
            and all(_fd.decode_smem_bytes(G, hd, b) <= SMEM_PER_BLOCK
                    for b in (2, 4)))


# -- Matérn GP posterior ---------------------------------------------------

def gp_posterior(x_cand, x_obs, vinv_rows, w, mask, ell=2.0, nu="matern32",
                 block_n=512):
    return _mgp.gp_posterior(x_cand, x_obs, vinv_rows, w, mask, ell=ell,
                             nu=nu, block_n=block_n)


def gp_inputs_from_incremental(gp, pad_T: Optional[int] = None):
    """Package an IncrementalGP state as padded kernel inputs (numpy)."""
    from repro_torch.core.gp_fast import forward_substitute

    t = gp.t
    T = pad_T or max(128, 1 << (t - 1).bit_length())
    d = gp.dim
    x_obs = np.zeros((T, d), np.float32)
    x_obs[:t] = gp.X[:t]
    # invert the Cholesky factor in float64 — GP kernel matrices are
    # ill-conditioned and an fp32 inverse loses ~1% of the posterior mean.
    # Triangular solve against identity (O(t²) per rhs column), NOT
    # np.linalg.inv of the full padded factor: the generic inverse is O(T³)
    # on every packaging call and ignores the triangular structure.
    vinv = np.zeros((T, T), np.float32)
    vinv[:t, :t] = forward_substitute(
        gp.L[:t, :t], np.eye(t, dtype=np.float64)).astype(np.float32)
    yv = gp.y[:t]
    y_mean, y_std = float(yv.mean()), max(float(yv.std()), 1e-12)
    w = np.zeros(T, np.float32)
    w[:t] = forward_substitute(gp.L[:t, :t], (yv - y_mean) / y_std)
    mask = np.zeros(T, np.float32)
    mask[:t] = 1.0
    return x_obs, vinv, w, mask, y_mean, y_std


def gp_config_space(N: int = 16384) -> SearchSpace:
    vals = (128, 256, 512, 1024, 2048, 4096)
    params = [Param("block_n", vals)]
    return SearchSpace(params, [lambda c: N % c["block_n"] == 0],
                       name="cuda_matern_gp")


def gp_valid(cfg: Dict, T: int = 256, d: int = 16) -> bool:
    """Hopper resource model of one GP block: ``block_n`` a multiple of the
    32-candidate sub-panel, T a multiple of the 64-row L⁻¹ tile, and the
    shared memory for T observations of dimension d, the K panel and the
    L⁻¹ ring (which ``block_n`` does not change: a block streams its
    candidates) within 227 KB."""
    return (cfg["block_n"] % _mgp.TILE == 0 and T % _mgp.T_MULTIPLE == 0
            and _mgp.gp_smem_bytes(T, d) <= SMEM_PER_BLOCK)
