"""Flash attention (prefill), causal or full, as a hand-written CUDA kernel.

Port of ``repro/kernels/flash_attention.py``. The kernel is
``csrc/flash_attention.cu`` (its header gives the bound and the design):
bf16 runs on the tensor cores (wgmma), fp32 on the CUDA cores. This module
is its wrapper. The tunables are the reference's ``block_q`` (query rows
per thread block: the grid) and ``block_kv`` (keys the bf16 kernel keeps
in flight: its ring of 64-key stages; the fp32 kernel's score tile); the
resource model is ``kernels.ops.flash_valid``.

A CPU tensor takes the plain version (``kernels.ref.attention``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

#: Kernel launches by :func:`flash_attention` (never by the plain version).
launches = 0

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}

#: Head dims the kernel is built for, and the granularity of its blocks
#: (query rows per warpgroup or sub-tile, keys per staged tile).
HEAD_DIMS = (64, 128, 256)
SUB_TILE = 64
#: The bf16 kernel's ring: stages of SUB_TILE keys, block_kv / 64 of them
#: within these bounds.
MIN_STAGES, MAX_STAGES = 2, 8


def flash_stages(block_kv: int) -> int:
    """Stages of the bf16 kernel's K/V ring (``stages_for`` in the
    source)."""
    return max(MIN_STAGES, min(MAX_STAGES, block_kv // SUB_TILE))


def flash_smem_bytes(block_q: int, block_kv: int, hd: int,
                     dtype: torch.dtype) -> int:
    """Shared memory one block needs. bf16 (``tc::smem_bytes`` in the
    source): 1 KB of alignment slack, the q sub-tile of one or two 64-row
    warpgroups (two when ``block_q`` is a multiple of 128), and the ring of
    K and V stages. fp32 (``cc::smem_floats``): the q sub-tile and one
    staged K or V chunk, the 64 x block_kv score tile, and the per-row
    (m, l, corr)."""
    if dtype == torch.float32:
        return 4 * (hd * SUB_TILE + SUB_TILE * hd + SUB_TILE * block_kv
                    + 3 * SUB_TILE)
    rows = 2 * SUB_TILE if block_q % (2 * SUB_TILE) == 0 else SUB_TILE
    return 1024 + 2 * rows * hd + flash_stages(block_kv) * 2 * SUB_TILE * hd * 2


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 128, block_kv: int = 128,
                    causal: bool = True) -> torch.Tensor:
    """Attention, causal (the reference's default) or full with
    ``causal=False``. q (B,S,H,hd); k, v (B,S,KV,hd) with KV dividing H
    (KV == H is the reference's MHA core). fp32 or bf16, all three alike;
    fp32 softmax; result (B,S,H,hd) in q's dtype."""
    global launches
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B,S,H,hd) / "
                         "(B,S,KV,hd)")
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{KV} KV heads do not divide {H} heads")
    if S % block_q or S % block_kv:
        raise ValueError(f"S={S} not divisible by blocks "
                         f"({block_q},{block_kv})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes fp32 or bf16, got {q.dtype},"
                        f" {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands on different devices")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if hd not in HEAD_DIMS or block_q % SUB_TILE or block_kv % SUB_TILE:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS} and blocks that "
                         f"are multiples of {SUB_TILE}, got hd={hd}, "
                         f"blocks ({block_q},{block_kv})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError("flash_attention needs 16-byte aligned operands")
    lib = _build.lib()
    with torch.cuda.device(q.device):
        code = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, H, KV, hd, block_q, block_kv, int(causal),
            _build.stream_of(q))
    _build.check(code, f"flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
                       f"blocks ({block_q},{block_kv}) causal={causal}")
    launches += 1
    return o
