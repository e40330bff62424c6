"""Tiled GEMM: the paper's GEMM tuning target, as a hand-written CUDA kernel.

Port of ``repro/kernels/gemm.py``. The kernel is ``csrc/gemm.cu`` (its
header gives the bound and the design); this module is its wrapper. The
tunable is the same block shape (``block_m``, ``block_n``, ``block_k``) the
TPU kernel exposed, here the shared-memory tiles of one thread block; its
resource model is ``kernels.ops.gemm_valid``.

A CPU tensor takes the plain version (``kernels.ref.gemm``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: Kernel launches by :func:`gemm` (never by the plain version).
launches = 0

_ENTRY = {torch.float32: "gemm_f32", torch.bfloat16: "gemm_bf16"}


def gemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
         block_n: int = 128, block_k: int = 64) -> torch.Tensor:
    """C = A @ B. A (M,K), B (K,N), same dtype (fp32 or bf16), fp32
    accumulation, result in A's dtype."""
    global launches
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dims differ: A {tuple(a.shape)}, "
                         f"B {tuple(b.shape)}")
    if M % block_m or N % block_n or K % block_k:
        raise ValueError(f"dims ({M},{N},{K}) not divisible by blocks "
                         f"({block_m},{block_n},{block_k})")
    if a.dtype != b.dtype or a.dtype not in _ENTRY:
        raise TypeError(f"gemm takes fp32 or bf16 pairs, got {a.dtype}, "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"A on {a.device}, B on {b.device}")
    if a.device.type == "cpu":
        return ref.gemm(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on cuda or cpu, not {a.device}")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    for t in (a, b, c):
        if t.data_ptr() % 16:
            raise ValueError("gemm needs 16-byte aligned operands")
    lib = _build.lib()
    with torch.cuda.device(a.device):
        code = getattr(lib, _ENTRY[a.dtype])(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
            block_m, block_n, block_k, _build.stream_of(a))
    _build.check(code, f"gemm {M}x{N}x{K} blocks "
                       f"({block_m},{block_n},{block_k})")
    launches += 1
    return c


def gemm_smem_bytes(block_m: int, block_n: int, block_k: int,
                    dtype_bytes: int = 4) -> int:
    """Shared memory one block stages: the A and B tiles."""
    return (block_m * block_k + block_k * block_n) * dtype_bytes


def gemm_threads(block_m: int, block_n: int) -> int:
    """Threads per block: one per 8x8 accumulator tile."""
    return (block_m // 8) * (block_n // 8)
