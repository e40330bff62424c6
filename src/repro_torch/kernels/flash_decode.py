"""Split-KV flash decode: one new token over the KV cache, as two
hand-written CUDA kernels.

Port of ``repro/kernels/flash_decode.py``. The kernels are in
``csrc/flash_decode.cu`` (its header gives the bound and the design):
:func:`decode_split` scans ``num_splits`` ranges of the cache in
``block_kv`` tiles and returns unnormalized ``(o, m, l)`` partials, and
:func:`decode_combine` folds the splits. :func:`flash_decode` is the
reference's entry point: the split pass, then the combine by the combine
kernel (``combine="kernel"``) or by tensor ops (``combine="torch"``, the
reference's ``"jax"`` strategy; on the card it is a tuning choice, whose
tensor ops run there too).

The split kernel's grid is planned here, in :func:`decode_plan`: each
split is cut into chunks, one block each, so that the grid fills the card;
the kernel folds a split's chunks back into that split's partials, so
:func:`decode_split` returns what the plain version returns.

A CPU tensor takes the plain versions (``kernels.ref.decode_split`` and
``combine_partials``); a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, ref

COMBINE_STRATEGIES = ("torch", "kernel")

#: Kernel launches by :func:`decode_split` and :func:`decode_combine`
#: (never by the plain versions).
split_launches = 0
combine_launches = 0

_SPLIT = {torch.float32: "decode_split_f32", torch.bfloat16: "decode_split_bf16"}
_COMBINE = {torch.float32: "decode_combine_f32",
            torch.bfloat16: "decode_combine_bf16"}

#: Head dims the split kernel is built for, query rows a block holds, its
#: threads per block, the slots it stages per tile, and the blocks its grid
#: aims for (one per SM of an H100).
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
THREADS = 256
TILE = 64
FILL_BLOCKS = 132

#: Per-split arrival counters of the split kernel, per (device, stream):
#: zeroed once, and reset by the kernel after each use.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def decode_stages(hd: int, dtype_bytes: int) -> int:
    """Stages of the split kernel's K/V ring (``split_stages`` in the
    source): two where they take at most 128 KB, else one."""
    return 2 if 4 * TILE * hd * dtype_bytes <= 131072 else 1


def decode_smem_bytes(G: int, hd: int, dtype_bytes: int) -> int:
    """Shared memory of one split block (``split_smem_bytes`` in the
    source): the K/V ring, q in fp32, the 64 x 8 score tile, the per-row
    (m, l, corr), the slot groups' end reduction, the slots' valid flags."""
    ring = decode_stages(hd, dtype_bytes) * 2 * TILE * hd * dtype_bytes
    floats = (G * hd + MAX_GROUP * TILE + 3 * MAX_GROUP
              + (2 * THREADS // hd) * G * hd)
    return ring + 4 * floats + 4 * (TILE + 4)


def decode_plan(B: int, KV: int, S: int, Sp: int, num_splits: int
                ) -> Tuple[int, int]:
    """The split kernel's grid: ``(C, chunk)``, each split's slots below
    ``S`` cut into ``C`` chunks of ``chunk`` slots (a multiple of the
    64-slot tile), one block each. A chunk takes the fewest tiles that
    bring ``B x KV x num_splits x C`` to ``FILL_BLOCKS``, and at least
    one: where the fullest split has the tiles, the grid reaches
    ``FILL_BLOCKS``."""
    L = Sp // num_splits
    live = min(L, S)
    tiles = -(-live // TILE)
    want = -(-FILL_BLOCKS // (B * KV * num_splits))
    chunk = max(1, tiles // want) * TILE
    return -(-live // chunk), chunk


def chunk_ranges(split: int, S: int, Sp: int, num_splits: int, C: int,
                 chunk: int) -> List[Tuple[int, int]]:
    """Slot ranges ``[lo, hi)`` of split ``split``'s live chunks, as the
    kernel cuts them: the split's slots below ``S``, in order. Chunks
    ``len(...)``..``C - 1`` hold only padding."""
    L = Sp // num_splits
    lo0, end = split * L, min(split * L + L, S)
    return [(lo, min(lo + chunk, end))
            for lo in range(lo0, lo0 + C * chunk, chunk) if lo < end]


def _arrival_counters(device: torch.device, stream: int, n: int
                      ) -> torch.Tensor:
    key = (device.index, stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = cnt
    return cnt


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def decode_split(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, bias: torch.Tensor, *,
                 block_kv: int = 512, num_splits: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B,H,hd); caches (B,S,KV,hd), fp32 or bf16 like q; bias (B,Sp)
    fp32 (0 valid, -inf masked) with Sp >= S a multiple of num_splits x
    block_kv, slots past S masked. Returns o (B,KV,splits,G,hd), m and l
    (B,KV,splits,G), fp32."""
    global split_launches
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    Sp = bias.shape[1]
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd or bias.shape[0] != B):
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)}"
                         f"/{tuple(v_cache.shape)}, bias {tuple(bias.shape)}"
                         " do not fit one decode problem")
    if H % KV:
        raise ValueError(f"{KV} KV heads do not divide {H} heads")
    if Sp < S or Sp % (num_splits * block_kv):
        raise ValueError(f"bias length {Sp} must cover S={S} and be a "
                         f"multiple of num_splits x block_kv = "
                         f"{num_splits * block_kv}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _SPLIT:
        raise TypeError(f"decode_split takes fp32 or bf16 q and caches, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be fp32, got {bias.dtype}")
    if not (q.device == k_cache.device == v_cache.device == bias.device):
        raise ValueError("decode_split operands on different devices")
    if q.device.type == "cpu":
        return ref.decode_split(q, k_cache, v_cache, bias, num_splits)
    _check_cuda(q, "decode_split")
    G = H // KV
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per KV head, got hd={hd}, "
                         f"G={G}")
    q, k_cache, v_cache, bias = (t.contiguous()
                                 for t in (q, k_cache, v_cache, bias))
    o = torch.empty((B, KV, num_splits, G, hd), dtype=torch.float32,
                    device=q.device)
    m = torch.empty((B, KV, num_splits, G), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    C, chunk = decode_plan(B, KV, S, Sp, num_splits)
    scratch = (0, 0, 0, 0)
    stream = _build.stream_of(q)
    if C > 1:
        n = B * KV * num_splits
        o_scr = torch.empty(n * C * G * hd, dtype=torch.float32,
                            device=q.device)
        ml_scr = torch.empty(2 * n * C * G, dtype=torch.float32,
                             device=q.device)
        cnt = _arrival_counters(q.device, stream.value, n)
        scratch = (o_scr.data_ptr(), ml_scr.data_ptr(),
                   ml_scr.data_ptr() + 4 * n * C * G, cnt.data_ptr())
    lib = _build.lib()
    with torch.cuda.device(q.device):
        code = getattr(lib, _SPLIT[q.dtype])(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            bias.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            *scratch, B, S, Sp, KV, G, hd, block_kv, num_splits, C, chunk,
            stream)
    _build.check(code, f"decode_split B={B} S={S} Sp={Sp} KV={KV} G={G} "
                       f"hd={hd} block_kv={block_kv} splits={num_splits} "
                       f"chunks {C} x {chunk}")
    split_launches += 1
    return o, m, l


def decode_combine(o_part: torch.Tensor, m_part: torch.Tensor,
                   l_part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Fold the split partials: o (B,KV,splits,G,hd), m and l
    (B,KV,splits,G), fp32 -> (B, KV*G, hd) in ``dtype``."""
    global combine_launches
    B, KV, ns, G, hd = o_part.shape
    if m_part.shape != (B, KV, ns, G) or l_part.shape != m_part.shape:
        raise ValueError(f"partials {tuple(o_part.shape)}, "
                         f"{tuple(m_part.shape)}, {tuple(l_part.shape)} "
                         "do not fit")
    if any(t.dtype != torch.float32 for t in (o_part, m_part, l_part)):
        raise TypeError("decode_combine takes fp32 partials")
    if dtype not in _COMBINE:
        raise TypeError(f"decode_combine writes fp32 or bf16, not {dtype}")
    if not (o_part.device == m_part.device == l_part.device):
        raise ValueError("decode_combine operands on different devices")
    if o_part.device.type == "cpu":
        merged = ref.combine_partials(o_part, m_part, l_part)
        return merged.reshape(B, KV * G, hd).to(dtype)
    _check_cuda(o_part, "decode_combine")
    o_part, m_part, l_part = (t.contiguous() for t in (o_part, m_part, l_part))
    out = torch.empty((B, KV * G, hd), dtype=dtype, device=o_part.device)
    lib = _build.lib()
    with torch.cuda.device(o_part.device):
        code = getattr(lib, _COMBINE[dtype])(
            o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            out.data_ptr(), B, KV, ns, G, hd, _build.stream_of(o_part))
    _build.check(code, f"decode_combine B={B} KV={KV} splits={ns} G={G} "
                       f"hd={hd}")
    combine_launches += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, bias: torch.Tensor, *,
                 block_kv: int = 512, num_splits: int = 1,
                 combine: str = "kernel") -> torch.Tensor:
    """Single-token cache attention: q (B,H,hd), caches (B,S,KV,hd), bias
    (B,Sp) as :func:`decode_split` takes them. Returns (B,H,hd) in q's
    dtype."""
    if combine not in COMBINE_STRATEGIES:
        raise ValueError(f"combine must be one of {COMBINE_STRATEGIES}, got "
                         f"{combine!r}")
    o, m, l = decode_split(q, k_cache, v_cache, bias, block_kv=block_kv,
                           num_splits=num_splits)
    if combine == "kernel":
        return decode_combine(o, m, l, q.dtype)
    B, H, hd = q.shape
    return ref.combine_partials(o, m, l).reshape(B, H, hd).to(q.dtype)
