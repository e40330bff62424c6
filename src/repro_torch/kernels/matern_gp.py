"""Fused Matérn GP posterior: the paper's §III-G exhaustive-prediction loop.

Port of ``repro/kernels/matern_gp.py``. The kernel is ``csrc/matern_gp.cu``
(its header gives the bound and the design): per candidate, the Matérn
covariance column against the padded observations, ``V = L⁻¹K`` over the
lower triangle (3xTF32 on the tensor cores, L⁻¹ staged in 64x64 tiles),
then ``mean = Vᵀw`` and ``var = max(1 − ΣV², 1e-12)``, with
V kept out of device memory. The tunable is ``block_n``, the candidates one
thread block streams; its resource model is ``kernels.ops.gp_valid``.

A CPU tensor takes the plain version (``kernels.ref.gp_posterior``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build, ref

#: Kernel launches by :func:`gp_posterior` (never by the plain version),
#: and the same launches by (covariance, padded observations T).
launches = 0
launches_by: Counter = Counter()

#: When True, each launch is timed with CUDA events (one synchronize per
#: call) and added to ``launch_ms``; off by default.
time_launches = False
launch_ms = 0.0

NU_CODE = {"matern12": 0, "matern32": 1, "matern52": 2, "rbf": 3}

#: Candidates per sub-panel, and the edge of the L⁻¹ tiles (the kernel's
#: observation-row granularity).
TILE = 32
T_MULTIPLE = 64
#: Warps along a 64-row panel of V (the cross-warp reduction's depth),
#: and the slots of the L⁻¹ tile ring.
WARPS_M = 4
L_SLOTS = 2


def gp_smem_bytes(T: int, d: int) -> int:
    """Shared memory one block needs (``smem_floats`` in the source): the
    K panel (T rows of 32 candidates, padded to 40), the two-slot ring
    of 64x64 L⁻¹ tiles (rows padded to 68), three T-vectors, the
    candidate sub-panel and the cross-warp reduction, fp32. The
    observations themselves are read through L1, not staged."""
    return 4 * (T * (TILE + 8) + L_SLOTS * T_MULTIPLE * (T_MULTIPLE + 4)
                + 3 * T + TILE * (d | 1) + TILE + 2 * WARPS_M * TILE)


def gp_posterior(x_cand: torch.Tensor, x_obs: torch.Tensor,
                 vinv_rows: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                 *, ell: float = 2.0, nu: str = "matern32", block_n: int = 512):
    """x_cand (N,d); x_obs (T,d) padded; vinv_rows = L⁻¹ (T,T), lower-
    triangular; w (T,) = L⁻¹ỹ zero-padded; mask (T,) 1 for real obs. All
    fp32. Returns (mean (N,), var (N,))."""
    global launches, launch_ms
    N, d = x_cand.shape
    T = x_obs.shape[0]
    if N % block_n:
        raise ValueError(f"N={N} not divisible by block_n={block_n}")
    if nu not in NU_CODE:
        raise ValueError(nu)
    if (x_obs.shape != (T, d) or vinv_rows.shape != (T, T)
            or w.shape != (T,) or mask.shape != (T,)):
        raise ValueError(
            f"shapes x_cand {tuple(x_cand.shape)}, x_obs {tuple(x_obs.shape)}"
            f", vinv {tuple(vinv_rows.shape)}, w {tuple(w.shape)}, mask "
            f"{tuple(mask.shape)} do not fit one (N,d)/(T,d)/(T,T) problem")
    args = (x_cand, x_obs, vinv_rows, w, mask)
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("gp_posterior takes fp32 tensors")
    if any(t.device != x_cand.device for t in args):
        raise ValueError("gp_posterior operands on different devices")
    if x_cand.device.type == "cpu":
        return ref.gp_posterior(x_cand, x_obs, vinv_rows, w, ell, nu,
                                mask=mask)
    if x_cand.device.type != "cuda":
        raise ValueError(f"gp_posterior runs on cuda or cpu, not "
                         f"{x_cand.device}")
    if block_n % TILE or T % T_MULTIPLE:
        raise ValueError(f"kernel needs block_n % {TILE} == 0 and "
                         f"T % {T_MULTIPLE} == 0, got {block_n}, {T}")
    _build.refuse_grad("gp_posterior", *args)
    args = tuple(t.contiguous() for t in args)
    mean = torch.empty(N, dtype=torch.float32, device=x_cand.device)
    var = torch.empty_like(mean)
    if any(t.data_ptr() % 16 for t in args + (mean, var)):
        raise ValueError("gp_posterior needs 16-byte aligned operands")
    lib = _build.lib()
    stream = _build.stream_of(x_cand)
    with torch.cuda.device(x_cand.device):
        if time_launches:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        code = lib.gp_posterior_f32(
            *(t.data_ptr() for t in args), mean.data_ptr(), var.data_ptr(),
            N, T, d, 1.0 / ell, NU_CODE[nu], block_n, stream)
        _build.check(code, f"gp_posterior N={N} T={T} d={d} "
                           f"block_n={block_n}")
        launches += 1
        launches_by[nu, T] += 1
        if time_launches:
            t1.record()
            t1.synchronize()
            launch_ms += t0.elapsed_time(t1)
    return mean, var
