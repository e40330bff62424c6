"""Tiled GEMM: the paper's GEMM tuning target, as a hand-written CUDA kernel.

Port of ``repro/kernels/gemm.py``. The kernel is ``csrc/gemm.cu`` (its
header gives the bounds and the design): fp32 as 3xTF32 and bf16 on the
tensor cores, 64x32 of C a warp, A and B tiles through a ring of cp.async
stages. This module is its wrapper and the layout's resource model. The
tunable is the same block shape (``block_m``, ``block_n``, ``block_k``) the
TPU kernel exposed, here the shared-memory tiles of one thread block; the
ring's depth follows from it. The resource model is
``kernels.ops.gemm_valid``.

A CPU tensor takes the plain version (``kernels.ref.gemm``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.launch.roofline import SMEM_PER_BLOCK

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
    _build.refuse_grad("gemm", a, b)
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


#: C tile of one warp (rows, cols): 4 x 4 mma fragments.
WARP_M, WARP_N = 64, 32
#: Deepest cp.async ring the kernel builds.
MAX_STAGES = 4
#: Most threads a block, by dtype bytes: the kernel's launch bound, 8 warps
#: of 224 registers a thread in fp32, 16 of 128 in bf16.
MAX_THREADS = {4: 256, 2: 512}
#: Row pads of the A and B tiles in shared memory, in elements, by dtype
#: bytes: fragment loads then hit distinct banks, rows stay 16-byte aligned.
PAD = {4: (4, 8), 2: (8, 8)}


def gemm_stage_bytes(block_m: int, block_n: int, block_k: int,
                     dtype_bytes: int = 4) -> int:
    """One stage of the ring: the padded A and B tiles."""
    pad_a, pad_b = PAD[dtype_bytes]
    return (block_m * (block_k + pad_a)
            + block_k * (block_n + pad_b)) * dtype_bytes


def gemm_stages(block_m: int, block_n: int, block_k: int,
                dtype_bytes: int = 4) -> int:
    """Ring depth: as many stages as fit 227 KB, at most 4 (``ring_stages``
    in the source). Below 2 the kernel refuses the shape."""
    return min(MAX_STAGES, SMEM_PER_BLOCK // gemm_stage_bytes(
        block_m, block_n, block_k, dtype_bytes))


def gemm_smem_bytes(block_m: int, block_n: int, block_k: int,
                    dtype_bytes: int = 4) -> int:
    """Shared memory one block stages: its ring, at least the 2 stages the
    design needs (so a shape with room for fewer is over the limit)."""
    stages = max(2, gemm_stages(block_m, block_n, block_k, dtype_bytes))
    return stages * gemm_stage_bytes(block_m, block_n, block_k, dtype_bytes)


def gemm_threads(block_m: int, block_n: int) -> int:
    """Threads per block: a warp per 64x32 tile of C."""
    return (block_m // WARP_M) * (block_n // WARP_N) * 32
