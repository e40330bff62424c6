"""Split-KV flash decode: one new token over the KV cache, as one
hand-written CUDA kernel.

Port of ``repro/kernels/flash_decode.py``. The kernel is in
``csrc/flash_decode.cu`` (its header gives the bound and the design). It
runs in two modes. :func:`decode_split` scans ``num_splits`` ranges of the
cache in ``block_kv`` tiles and returns unnormalized ``(o, m, l)``
partials. :func:`flash_decode` is the reference's entry point: with
``combine="kernel"`` one launch does the split pass and the cross-split
combine, folded into its last block (the reference's second kernel); with
``combine="torch"`` (the reference's ``"jax"`` strategy; on the card a
tuning choice whose tensor ops run there too) the partials are merged by
tensor ops.

The kernel's grid is planned here, in :func:`decode_plan`: each split is
cut into chunks, one block each, so that the grid fills the card; the
kernel folds the chunks back, per split into that split's partials (so
:func:`decode_split` returns what the plain version returns) or per head
group into the normalized output.

A CPU tensor takes the plain versions (``kernels.ref.decode_split`` and
``combine_partials``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, ref

COMBINE_STRATEGIES = ("torch", "kernel")

#: Launches of the kernel: every launch counts in ``split_launches``, and
#: those that carry the fused combine (``flash_decode(combine="kernel")``)
#: also in ``combine_launches``. The plain versions count nothing. A call
#: inside a CUDA graph capture counts here too; the capturer moves those
#: counts to the graph, which adds them at each replay
#: (``launch/serve.DecodeServer``).
split_launches = 0
combine_launches = 0

_SPLIT = {torch.float32: "decode_split_f32", torch.bfloat16: "decode_split_bf16"}

#: Head dims the split kernel is built for, query rows a block holds, its
#: threads per block, the slots it stages per tile, and the blocks its grid
#: aims for (one per SM of an H100).
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
THREADS = 256
TILE = 64
FILL_BLOCKS = 132

#: Arrival counters of the kernel, per (device, stream, fused): per split
#: in partials mode, per head group in fused mode, two buffers so that
#: launches of both modes on one stream never share a counter. Zeroed once,
#: and reset by the kernel after each use, so a graph replays them as it
#: captured them. They are made by a launch outside any capture: a graph
#: captures on a stream where the kernel has run once already.
_counters: Dict[Tuple[int, int, bool], torch.Tensor] = {}


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


def _arrival_counters(device: torch.device, stream: int, fused: bool,
                      n: int) -> torch.Tensor:
    key = (device.index, stream, fused)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash decode's arrival counters for this stream and mode do "
                "not exist yet: launch once on the capture stream before "
                "capturing (a graph must not create and zero them)")
        cnt = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = cnt
    return cnt


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def _check_operands(q, k_cache, v_cache, bias, block_kv, num_splits):
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
        raise TypeError(f"flash decode takes fp32 or bf16 q and caches, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be fp32, got {bias.dtype}")
    if not (q.device == k_cache.device == v_cache.device == bias.device):
        raise ValueError("flash decode operands on different devices")


def _launch(q, k_cache, v_cache, bias, block_kv, num_splits, fused):
    """One launch of the kernel on checked CUDA operands: the normalized
    output (B,H,hd) in q's dtype when ``fused``, else the partials."""
    global split_launches, combine_launches
    _check_cuda(q, "flash decode")
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    Sp = bias.shape[1]
    G = H // KV
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per KV head, got hd={hd}, "
                         f"G={G}")
    q, k_cache, v_cache, bias = (t.contiguous()
                                 for t in (q, k_cache, v_cache, bias))
    f32 = dict(dtype=torch.float32, device=q.device)
    if fused:
        out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
        ptrs = (0, 0, 0, out.data_ptr())
    else:
        out = (torch.empty((B, KV, num_splits, G, hd), **f32),
               torch.empty((B, KV, num_splits, G), **f32),
               torch.empty((B, KV, num_splits, G), **f32))
        ptrs = tuple(t.data_ptr() for t in out) + (0,)
    C, chunk = decode_plan(B, KV, S, Sp, num_splits)
    scratch = (0, 0, 0, 0)
    stream = _build.stream_of(q)
    n = B * KV * num_splits
    if (num_splits * C if fused else C) > 1:   # a fold of several blocks
        o_scr = torch.empty(n * C * G * hd, **f32)
        ml_scr = torch.empty(2 * n * C * G, **f32)
        cnt = _arrival_counters(q.device, stream.value, fused,
                                B * KV if fused else n)
        scratch = (o_scr.data_ptr(), ml_scr.data_ptr(),
                   ml_scr.data_ptr() + 4 * n * C * G, cnt.data_ptr())
    lib = _build.lib()
    with torch.cuda.device(q.device):
        code = getattr(lib, _SPLIT[q.dtype])(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            bias.data_ptr(), *ptrs, *scratch, B, S, Sp, KV, G, hd, block_kv,
            num_splits, C, chunk, stream)
    _build.check(code, f"flash decode{' (fused)' if fused else ''} B={B} "
                       f"S={S} Sp={Sp} KV={KV} G={G} hd={hd} "
                       f"block_kv={block_kv} splits={num_splits} "
                       f"chunks {C} x {chunk}")
    split_launches += 1
    combine_launches += fused
    return out


def decode_split(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, bias: torch.Tensor, *,
                 block_kv: int = 512, num_splits: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B,H,hd); caches (B,S,KV,hd), fp32 or bf16 like q; bias (B,Sp)
    fp32 (0 valid, -inf masked) with Sp >= S a multiple of num_splits x
    block_kv, slots past S masked. Returns o (B,KV,splits,G,hd), m and l
    (B,KV,splits,G), fp32."""
    _check_operands(q, k_cache, v_cache, bias, block_kv, num_splits)
    if q.device.type == "cpu":
        return ref.decode_split(q, k_cache, v_cache, bias, num_splits)
    return _launch(q, k_cache, v_cache, bias, block_kv, num_splits, False)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, bias: torch.Tensor, *,
                 block_kv: int = 512, num_splits: int = 1,
                 combine: str = "kernel") -> torch.Tensor:
    """Single-token cache attention: q (B,H,hd), caches (B,S,KV,hd), bias
    (B,Sp) as :func:`decode_split` takes them. Returns (B,H,hd) in q's
    dtype. On the card ``combine="kernel"`` is one launch, the combine
    fused into the split pass; ``"torch"`` merges the split partials with
    tensor ops."""
    if combine not in COMBINE_STRATEGIES:
        raise ValueError(f"combine must be one of {COMBINE_STRATEGIES}, got "
                         f"{combine!r}")
    if combine == "kernel" and q.device.type != "cpu":
        _check_operands(q, k_cache, v_cache, bias, block_kv, num_splits)
        return _launch(q, k_cache, v_cache, bias, block_kv, num_splits, True)
    o, m, l = decode_split(q, k_cache, v_cache, bias, block_kv=block_kv,
                           num_splits=num_splits)
    B, H, hd = q.shape
    return ref.combine_partials(o, m, l).reshape(B, H, hd).to(q.dtype)
