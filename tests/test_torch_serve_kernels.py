"""The serve path's kernel wrappers against the JAX package, on the CPU.

Port wrappers run their plain versions for CPU tensors; the JAX Pallas
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them. Both
get the same numpy inputs from a seed. fp32 at the reference's 2e-4.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.kernels import flash_decode as jax_fd
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.layers import _decode_attention as jax_decode_attention

from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import ops, ref, tuning
from repro_torch.launch.roofline import SMEM_PER_BLOCK
from repro_torch.parallel.sharding import KernelConfig

TOL = dict(rtol=2e-4, atol=2e-4)


# -- flash attention (prefill) -------------------------------------------------

@pytest.mark.parametrize("B,S,H,KV,hd,bq,bkv", [
    (1, 64, 2, 2, 16, 32, 16),        # block_q != block_kv, both ways
    (2, 64, 4, 4, 32, 16, 32),
    (1, 128, 4, 1, 16, 64, 64),       # MQA: K/V read unexpanded
    (2, 64, 4, 2, 16, 64, 32),        # GQA, G = 2
])
def test_flash_attention_matches_jax(B, S, H, KV, hd, bq, bkv):
    rng = np.random.default_rng(B * S + H + KV + hd)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    G = H // KV
    kx, vx = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    want = np.asarray(jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), block_q=bq,
        block_kv=bkv, causal=True, interpret=True))
    oracle = np.asarray(jax_ref.attention(jnp.asarray(q), jnp.asarray(kx),
                                          jnp.asarray(vx)))
    kfa.launches = 0
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), block_q=bq, block_kv=bkv)
    assert kfa.launches == 0                      # plain version on the CPU
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)


def test_flash_attention_rejects_what_the_kernel_cannot_tile():
    q = torch.zeros((1, 96, 2, 16))
    with pytest.raises(ValueError, match="not divisible"):
        ops.flash_attention(q, q, q, block_q=64, block_kv=32)
    with pytest.raises(ValueError, match="do not divide"):
        ops.flash_attention(torch.zeros((1, 64, 3, 16)), q[:, :64],
                            q[:, :64], block_q=32, block_kv=32)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), q.double(), q.double(), block_q=32,
                            block_kv=32)


def test_flash_resource_model_agrees_with_the_kernel_shared_memory():
    # bf16 at hd 256: the 128-row q sub-tile and a ring of block_kv / 64
    # stages of 64 keys (2 at least); fp32: the 64 x block_kv score tile
    bf16, f32 = torch.bfloat16, torch.float32
    assert ops.flash_valid({"block_q": 128, "block_kv": 128}, 256, bf16)
    assert not ops.flash_valid({"block_q": 1024, "block_kv": 256}, 256, bf16)
    assert ops.flash_valid({"block_q": 1024, "block_kv": 256}, 256, f32)
    assert not ops.flash_valid({"block_q": 128, "block_kv": 512}, 256, bf16)
    assert not ops.flash_valid({"block_q": 128, "block_kv": 512}, 256, f32)
    assert kfa.flash_smem_bytes(128, 512, 256, bf16) > SMEM_PER_BLOCK
    assert kfa.flash_smem_bytes(128, 128, 256, bf16) == (
        1024 + 128 * 256 * 2 + 2 * 2 * 64 * 256 * 2)
    assert kfa.flash_smem_bytes(128, 256, 256, f32) == 4 * (
        256 * 64 + 64 * 256 + 64 * 256 + 3 * 64)
    # one warpgroup (block_q not a multiple of 128) leaves room for a third
    # stage at hd 256
    assert ops.flash_valid({"block_q": 64, "block_kv": 192}, 256, bf16)
    assert not ops.flash_valid({"block_q": 128, "block_kv": 192}, 256, bf16)
    assert ops.flash_valid({"block_q": 128, "block_kv": 256}, 128, bf16)
    assert not ops.flash_valid({"block_q": 128, "block_kv": 512}, 128, bf16)
    assert ops.flash_valid({"block_q": 128, "block_kv": 512}, 128, f32)
    assert not ops.flash_valid({"block_q": 128, "block_kv": 1024}, 128, f32)
    assert ops.flash_valid({"block_q": 128, "block_kv": 1024}, 64,
                           bf16)                                # 8 stages
    assert not ops.flash_valid({"block_q": 128, "block_kv": 1024}, 64, f32)
    assert not ops.flash_valid({"block_q": 128, "block_kv": 128}, 16,
                               bf16)                            # hd
    assert not ops.flash_valid({"block_q": 96, "block_kv": 128}, 64,
                               bf16)                            # tile
    space = ops.flash_config_space(1024)
    n_valid = sum(ops.flash_valid(space.config(i), 256, bf16)
                  for i in range(space.size))
    n_valid32 = sum(ops.flash_valid(space.config(i), 256, f32)
                    for i in range(space.size))
    assert space.size == 16 and n_valid == 4      # block_kv 128
    assert n_valid32 == 8                         # block_kv in {128, 256}


# -- flash decode ----------------------------------------------------------------

def _decode_case(B, S, H, KV, hd, cur, *, window=None, rolling=False,
                 seed=0):
    """test_kernels.py's cache states: contiguous fill to ``cur`` or a
    rolling window's wrapped layout, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    if rolling:
        slots = np.arange(S)
        pos = cur - ((cur - slots) % S)
        pos = np.where(pos >= 0, pos, -1)
    else:
        pos = np.where(np.arange(S) <= cur, np.arange(S), -1)
    cache_pos = np.broadcast_to(pos, (B, S)).copy()
    cur_pos = np.full((B,), cur)
    return q, k, v, cache_pos, cur_pos


def _both(case, window, block_kv, num_splits, combine):
    """The port's decode against the reference's; the port's tensor-op
    combine "torch" is the reference's "jax"."""
    q, k, v, cp, cu = case
    want = np.asarray(jax_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(cp, jnp.int32), jnp.asarray(cu, jnp.int32),
        window=window, block_kv=block_kv, num_splits=num_splits,
        combine="jax" if combine == "torch" else combine, interpret=True))
    got = ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cp), torch.from_numpy(cu), window=window,
        block_kv=block_kv, num_splits=num_splits, combine=combine)
    return got.numpy(), want


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("num_splits,block_kv,combine",
                         [(1, 64, "torch"), (2, 32, "torch"),
                          (4, 16, "kernel")])
def test_decode_matches_jax_gqa_and_splits(H, KV, num_splits, block_kv,
                                           combine):
    case = _decode_case(2, 128, H, KV, 16, cur=97)
    got, want = _both(case, None, block_kv, num_splits, combine)
    np.testing.assert_allclose(got, want, **TOL)
    q, k, v, cp, cu = case
    plain = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        cache_pos=jnp.asarray(cp), cur_pos=jnp.asarray(cu), window=None,
        scale=1.0 / np.sqrt(16)))
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("case", [
    dict(B=2, S=128, H=4, KV=2, hd=16, cur=5),              # mostly empty
    dict(B=1, S=100, H=4, KV=2, hd=16, cur=99),             # S % block != 0
    dict(B=2, S=64, H=4, KV=2, hd=16, cur=150, window=24,
         rolling=True),                                     # rolling window
    dict(B=2, S=96, H=4, KV=1, hd=16, cur=40, window=16),   # window, no wrap
])
@pytest.mark.parametrize("num_splits,block_kv,combine",
                         [(1, 64, "torch"), (4, 16, "torch"), (2, 32, "kernel"),
                          (8, 32, "kernel")])
def test_decode_matches_jax_occupancy_window_capacity(case, num_splits,
                                                      block_kv, combine):
    case = dict(case)
    window = case.pop("window", None)
    rolling = case.pop("rolling", False)
    arrays = _decode_case(**case, window=window, rolling=rolling)
    got, want = _both(arrays, window, block_kv, num_splits, combine)
    np.testing.assert_allclose(got, want, **TOL)


def test_combine_matches_jax_including_empty_splits():
    rng = np.random.default_rng(3)
    B, KV, ns, G, hd = 2, 2, 4, 3, 8
    o = rng.normal(size=(B, KV, ns, G, hd)).astype(np.float32)
    m = rng.normal(size=(B, KV, ns, G)).astype(np.float32)
    l = rng.random((B, KV, ns, G)).astype(np.float32) + 0.5
    m[0, 0, 1] = -np.inf                  # one empty split
    m[1, 1, :] = -np.inf                  # a whole head group empty
    o[0, 0, 1] = 0.0
    o[1, 1] = 0.0
    l[0, 0, 1] = 0.0
    l[1, 1] = 0.0
    want = np.asarray(jax_fd._combine_partials_jnp(
        jnp.asarray(o), jnp.asarray(m), jnp.asarray(l)))
    args = [torch.from_numpy(x) for x in (o, m, l)]
    got = ref.combine_partials(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.all(got.numpy()[1, 1] == 0.0)
    # the port's combine="kernel" on CPU tensors (the plain split pass and
    # combine, no launch) against the reference's split and combine kernels
    # on a cache with an empty split (row 0) and empty head groups (row 1)
    S, block_kv = 64, 16
    q = rng.normal(size=(B, KV * G, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    valid = np.ones((B, S), bool)
    valid[0, 16:32] = False
    valid[1] = False
    bias = np.where(valid, 0.0, -np.inf).astype(np.float32)
    want = np.asarray(jax_fd.flash_decode(
        *(jnp.asarray(x) for x in (q, k, v, bias)), block_kv=block_kv,
        num_splits=ns, combine="kernel", interpret=True))
    kfd.split_launches = kfd.combine_launches = 0
    fused = kfd.flash_decode(*(torch.from_numpy(x) for x in (q, k, v, bias)),
                             block_kv=block_kv, num_splits=ns,
                             combine="kernel")
    assert kfd.split_launches == kfd.combine_launches == 0
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.all(fused.numpy()[1] == 0.0) and np.all(want[1] == 0.0)


def test_plain_split_partials_fold_to_the_decode_reference():
    """The plain split pass: an all-masked split gives m = -inf, l = 0,
    o = 0, and the folded partials equal the whole-cache softmax."""
    q, k, v, cp, cu = _decode_case(1, 64, 4, 2, 16, cur=20)
    valid = (cp >= 0) & (cp <= cu[:, None])
    bias = torch.from_numpy(np.where(valid, 0.0, -np.inf).astype(np.float32))
    o, m, l = kfd.decode_split(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                               torch.from_numpy(v), bias, block_kv=16,
                               num_splits=4)
    assert o.shape == (1, 2, 4, 2, 16) and m.shape == (1, 2, 4, 2)
    assert torch.all(torch.isinf(m[:, :, 2:])) and torch.all(l[:, :, 2:] == 0)
    assert torch.all(o[:, :, 2:] == 0)
    folded = ref.combine_partials(o, m, l).reshape(1, 1, 4, 16)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        cache_pos=jnp.asarray(cp), cur_pos=jnp.asarray(cu), window=None,
        scale=1.0 / np.sqrt(16)))
    np.testing.assert_allclose(folded.numpy(), want, **TOL)


def test_serving_config_checks_flash_blocks_in_the_model_dtype(monkeypatch):
    """A stored flash record of (128, 256) at gemma-2b's hd 256 runs on the
    fp32 CUDA-core kernel and not on the bf16 tensor-core kernel: the
    store resolver and the server hold it against the model's dtype."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    flash = {"block_q": 128, "block_kv": 256}
    monkeypatch.setattr(tuning, "best_kernel_config",
                        lambda store, kernel, *a: (
                            (flash, 1.0) if kernel == "flash" else None))
    monkeypatch.setattr(tuning, "device_kind", lambda device=None: "card")
    sig = tuning.flash_shape_sig(4, 1024, 8, 256, 1)
    assert tuning.kernel_config_from_store(
        "store", S=1024, hd=256, dtype=torch.bfloat16, shape_sig=sig) is None
    kc = tuning.kernel_config_from_store("store", S=1024, hd=256,
                                         dtype=torch.float32, shape_sig=sig)
    assert (kc.flash_block_q, kc.flash_block_kv) == (128, 256)
    cfg = get_arch("gemma-2b")
    quiet = dict(device=torch.device("cuda"), prompt_len=1024,
                 cache_cap=1088, batch=4, store="store", log=lambda *a: None)
    kc = serve.serving_kernel_config(cfg, **quiet)
    assert (kc.flash_block_q, kc.flash_block_kv) == (128, 128)   # default
    kc = serve.serving_kernel_config(
        dataclasses.replace(cfg, dtype="float32"), **quiet)
    assert (kc.flash_block_q, kc.flash_block_kv) == (128, 256)


def test_decode_resource_model():
    # the block's tile is 64 slots whatever block_kv is: every block_kv of
    # the grid fits at G <= 8, in both dtypes; the ring is as deep as the
    # shared memory left allows (fp32 at hd 256: one stage)
    for bkv in (128, 256, 512, 1024):
        assert ops.decode_valid({"block_kv": bkv}, 8, 256)
    assert kfd.decode_stages(8, 256, 2) == 2
    assert kfd.decode_stages(8, 256, 4) == 1
    assert kfd.decode_stages(8, 80, 2) == 2 and kfd.decode_stages(12, 128, 2) == 5
    assert kfd.decode_blocks_per_sm(1, 80, 2) == 3       # stablelm-3b
    assert kfd.decode_blocks_per_sm(12, 128, 2) == 1     # the 16-row instance
    assert kfd.decode_smem_bytes(8, 256, 2) <= SMEM_PER_BLOCK
    assert kfd.decode_smem_bytes(8, 256, 4) <= SMEM_PER_BLOCK
    assert kfd.decode_smem_bytes(8, 128, 4) > kfd.decode_smem_bytes(8, 128, 2)
    assert ops.decode_valid({"block_kv": 512}, 16, 256)       # G <= 16
    assert not ops.decode_valid({"block_kv": 512}, 17, 256)   # G > 16
    assert not ops.decode_valid({"block_kv": 512}, 8, 16)     # head dim
    # splits that overhang a 1,088-slot cache are constrained out:
    # (block_kv, splits) in 128 x {1,2,4,8}, 256 x {1,2,4}, 512 x {1,2},
    # 1024 x {1,2}, times two combines
    assert ops.decode_config_space(1088).size == 22


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("G", list(range(1, 17)))
def test_decode_ring_fits_every_instance(G, hd, dtype_bytes):
    """Every (G, hd, dtype) the card takes: the block's shared memory fits
    227 KB, and the blocks an SM holds fit its 228 KB; the ring keeps
    tiles requested ahead wherever two stages fit (all but fp32 at hd
    256); the tuner's resource model accepts the instance."""
    smem = kfd.decode_smem_bytes(G, hd, dtype_bytes)
    blocks = kfd.decode_blocks_per_sm(G, hd, dtype_bytes)
    stages = kfd.decode_stages(G, hd, dtype_bytes)
    assert smem <= SMEM_PER_BLOCK
    assert blocks * (smem + kfd.SMEM_RESERVED) <= kfd.SMEM_PER_SM
    assert 1 <= stages <= kfd.MAX_STAGES
    assert (stages >= 2) == (hd * dtype_bytes < 1024)
    assert ops.decode_valid({"block_kv": 512}, G, hd)


@pytest.mark.parametrize("valid", [2049, 2175])
def test_decode_ring_keeps_the_stated_bytes_ahead_at_long_ctx(valid):
    """stablelm-3b's decode at long_ctx's shape (B 24, capacity 2,176, KV
    32, hd 80, bf16, G 1): one chunk a (row, KV head), three blocks an SM
    of two stages each, and 60 KB of K and V requested ahead an SM, the
    figure the source's header states (at least the ~48 KB that cover the
    card's latency)."""
    B, KV, S, G, hd = 24, 32, 2176, 1, 80
    Sp = -(-S // 512) * 512
    C, chunk = kfd.decode_plan(B, KV, S, Sp, 1)
    assert C == 1 and chunk >= valid
    ahead = kfd.decode_bytes_ahead(B, KV, S, Sp, 1, G, hd, 2)
    assert ahead == 3 * 1 * 20 * 1024 >= 48 * 1024


@pytest.mark.parametrize("B,KV,S,block_kv,num_splits", [
    (4, 1, 1088, 128, 8),     # gemma-2b decode: splits 5..7 padding only
    (1, 1, 1088, 128, 1),     # B 1: one split, the most chunks
    (4, 1, 1088, 256, 2),
    (2, 2, 200, 64, 4),       # capacity does not tile
    (1, 4, 1000, 16, 8),
    (64, 8, 4096, 512, 8),    # a grid already over 132 blocks: one chunk
])
def test_decode_plan_tiles_each_split(B, KV, S, block_kv, num_splits):
    Sp = -(-S // (num_splits * block_kv)) * num_splits * block_kv
    C, chunk = kfd.decode_plan(B, KV, S, Sp, num_splits)
    assert C >= 1 and chunk % kfd.TILE == 0
    L = Sp // num_splits
    for s in range(num_splits):
        ranges = kfd.chunk_ranges(s, S, Sp, num_splits, C, chunk)
        assert len(ranges) <= C
        want = list(range(s * L, min(s * L + L, S)))
        assert [j for lo, hi in ranges for j in range(lo, hi)] == want
        assert all(s * L <= lo < hi <= s * L + L and hi - lo <= chunk
                   for lo, hi in ranges)
    tiles = -(-min(L, S) // kfd.TILE)
    if tiles >= -(-kfd.FILL_BLOCKS // (B * KV * num_splits)):
        assert B * KV * num_splits * C >= kfd.FILL_BLOCKS
    else:
        assert C == tiles                          # capped by the tiles


def _fold_chunks(o, m, l):
    """The split kernel's fold of one split's chunk partials (o (C,G,hd),
    m and l (C,G)), copied from csrc/flash_decode.cu: the combine's weights
    exp(m_i - max m), 0 where m_i = -inf, without the normalisation."""
    mt = m.amax(dim=0)
    ms = torch.where(torch.isfinite(mt), mt, torch.zeros_like(mt))
    w = torch.where(torch.isfinite(m), torch.exp(m - ms),
                    torch.zeros_like(m))
    return (w[..., None] * o).sum(0), mt, (w * l).sum(0)


@pytest.mark.parametrize("S,cur,block_kv,num_splits", [
    (1088, 1054, 128, 8),      # the serving cache: 5 live splits of 4 chunks
    (1088, 1054, 1024, 1),     # one split of 17 chunks
    (1024, 5, 128, 2),         # mostly empty: all-masked chunks
    (200, 97, 64, 4),          # capacity does not tile
])
def test_split_partials_fold_from_chunks(S, cur, block_kv, num_splits):
    B, H, KV, hd = 2, 4, 2, 16
    q, k, v, cp, cu = _decode_case(B, S, H, KV, hd, cur)
    Sp = -(-S // (num_splits * block_kv)) * num_splits * block_kv
    bias = ops.decode_bias(torch.from_numpy(cp), torch.from_numpy(cu), None,
                           num_splits * block_kv)
    assert bias.shape == (B, Sp)
    args = (torch.from_numpy(q[:, 0]), torch.from_numpy(k),
            torch.from_numpy(v))
    o_r, m_r, l_r = ref.decode_split(*args, bias, num_splits)
    C, chunk = kfd.decode_plan(B, KV, S, Sp, num_splits)
    L = Sp // num_splits
    n_empty = 0
    for s in range(num_splits):
        ranges = kfd.chunk_ranges(s, S, Sp, num_splits, C, chunk)
        if not ranges:                   # padding only: the empty result
            assert torch.all(torch.isinf(m_r[:, :, s]))
            assert torch.all(l_r[:, :, s] == 0) and torch.all(o_r[:, :, s] == 0)
            continue
        parts = []
        for lo, hi in ranges:            # the chunk alone: the rest masked
            cb = torch.full_like(bias, -math.inf)
            cb[:, lo:hi] = bias[:, lo:hi]
            parts.append([t[:, :, s] for t in
                          ref.decode_split(*args, cb, num_splits)])
            n_empty += int(torch.isinf(parts[-1][1]).all())
        o_c, m_c, l_c = (torch.stack(x, 0) for x in zip(*parts))
        for b in range(B):
            for kv in range(KV):
                o_f, m_f, l_f = _fold_chunks(o_c[:, b, kv], m_c[:, b, kv],
                                             l_c[:, b, kv])
                torch.testing.assert_close(m_f, m_r[b, kv, s], rtol=0, atol=0)
                torch.testing.assert_close(l_f, l_r[b, kv, s], **TOL)
                torch.testing.assert_close(o_f, o_r[b, kv, s], **TOL)
    if cur < 10:
        assert n_empty > 0               # all-masked chunks were folded
    assert L > 0


@pytest.mark.parametrize("B,S,H,KV,hd,cur,block_kv,num_splits,empty_row", [
    (2, 128, 4, 2, 16, 97, 128, 1, False),     # one split of 2 chunks
    (2, 200, 4, 2, 16, 150, 64, 2, False),     # capacity does not tile
    (2, 256, 4, 1, 16, 240, 32, 4, False),
    (2, 1088, 4, 1, 16, 1054, 128, 8, False),  # splits 5..7 padding only
    (2, 256, 4, 2, 16, 97, 64, 2, True),       # row 1: no valid slot
    (2, 256, 8, 1, 256, 200, 64, 2, False),    # gemma-2b's G 8 and hd 256
])
def test_fused_fold_of_every_chunk_matches_the_jax_combine_kernel(
        B, S, H, KV, hd, cur, block_kv, num_splits, empty_row):
    """The kernel's fused mode: every live chunk of every split of a head
    group counted once and folded in one level (``_fold_chunks``, the
    kernel's fold), then normalized by max(l, 1e-30); splits of padding
    only add no chunk. Against the reference's split kernel + combine
    kernel in interpret mode, fp32, at the file's 2e-4 (rtol and atol: the
    sums run in another order). A head group with no valid slot gives
    exact zeros in both."""
    q, k, v, cp, cu = _decode_case(B, S, H, KV, hd, cur)
    if empty_row:
        cp[1] = -1
    bias = ops.decode_bias(torch.from_numpy(cp), torch.from_numpy(cu), None,
                           num_splits * block_kv)
    Sp = bias.shape[1]
    args = (torch.from_numpy(q[:, 0]), torch.from_numpy(k),
            torch.from_numpy(v))
    C, chunk = kfd.decode_plan(B, KV, S, Sp, num_splits)
    parts = []
    for s in range(num_splits):
        for lo, hi in kfd.chunk_ranges(s, S, Sp, num_splits, C, chunk):
            cb = torch.full_like(bias, -math.inf)   # the chunk alone
            cb[:, lo:hi] = bias[:, lo:hi]
            parts.append([t[:, :, s] for t in
                          ref.decode_split(*args, cb, num_splits)])
    if S < Sp - Sp // num_splits:
        assert len(parts) < num_splits * C         # padding adds no chunk
    o_c, m_c, l_c = (torch.stack(x, 0) for x in zip(*parts))
    o_f, _, l_f = _fold_chunks(o_c, m_c, l_c)
    got = (o_f / torch.clamp(l_f, min=1e-30)[..., None]).reshape(B, H, hd)
    pad = ((0, 0), (0, Sp - S), (0, 0), (0, 0))
    want = np.asarray(jax_fd.flash_decode(
        jnp.asarray(q[:, 0]), jnp.asarray(np.pad(k, pad)),
        jnp.asarray(np.pad(v, pad)), jnp.asarray(bias.numpy()),
        block_kv=block_kv, num_splits=num_splits, combine="kernel",
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if empty_row:
        assert torch.all(got[1] == 0) and np.all(want[1] == 0)
        assert torch.all(got[0] != 0)


# -- tuning cells and the serve-side resolvers -----------------------------------

def test_flash_and_decode_cells_tune_and_resolve_on_cpu(tmp_path):
    store = str(tmp_path / "store")
    fcell = tuning.flash_cell(1, 256, 2, 64, device="cpu")
    assert fcell.objective_id() == "kernel[flash×B1_S256_H2_hd64×cpu]"
    fres = tuning.run_kernel_tuning(fcell, store, budget=3, init=2, reps=1,
                                    device="cpu")
    assert fres.unique_evals == 3 and math.isfinite(fres.best_value)
    dcell = tuning.decode_cell(2, 160, 4, 1, 64, device="cpu")
    assert dcell.objective_id() == "kernel[decode×B2_S160_H4_KV1_hd64×cpu]"
    dres = tuning.run_kernel_tuning(dcell, store, budget=4, init=2, reps=1,
                                    device="cpu")
    assert dres.unique_evals == 4 and math.isfinite(dres.best_value)

    fbest = fcell.space.config(fres.best_idx)
    kc = tuning.kernel_config_from_store(store, S=256, hd=64,
                                         dtype=torch.float32,
                                         shape_sig=fcell.shape_sig,
                                         device="cpu")
    assert kc == KernelConfig(use_flash=True,
                              flash_block_q=fbest["block_q"],
                              flash_block_kv=fbest["block_kv"])
    dbest = dcell.space.config(dres.best_idx)
    both = tuning.decode_kernel_config_from_store(
        store, cache_cap=160, H=4, KV=1, hd=64, shape_sig=dcell.shape_sig,
        device="cpu", base=kc)
    assert both.use_flash and both.flash_block_q == kc.flash_block_q
    assert (both.use_decode, both.decode_block_kv, both.decode_num_splits,
            both.decode_combine) == (True, dbest["block_kv"],
                                     dbest["num_splits"], dbest["combine"])
    # a prompt the tuned blocks cannot tile, or a card, resolves nothing
    assert tuning.kernel_config_from_store(store, S=100, hd=64,
                                           dtype=torch.float32,
                                           shape_sig=fcell.shape_sig,
                                           device="cpu") is None
    assert tuning.decode_kernel_config_from_store(
        store, cache_cap=160, H=4, KV=1, hd=64, shape_sig=dcell.shape_sig,
        device="cuda-NVIDIA_H100_80GB_HBM3") is None
    # the cell's kernel output is the plain reference's
    q, k, v, cp, cu = dcell.meta["inputs"]
    out = dcell.run(dbest)
    want = ops.decode_attention(q, k, v, cp, cu, block_kv=1024,
                                num_splits=1)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)


def test_flash_cell_statically_invalid_configs_are_nan():
    cell = tuning.flash_cell(1, 1024, 2, 256, device="cpu")
    obj = tuning.KernelObjective(cell, reps=1, device="cpu")
    bad = cell.space.index_of({"block_q": 128, "block_kv": 512})
    assert math.isnan(obj(bad))
    assert cell.valid(cell.default)
    # bf16 runs the tensor-core kernel: its ring of 4 stages at block_kv
    # 256 does not fit beside a 128-row q sub-tile at hd 256
    cell = tuning.flash_cell(1, 1024, 2, 256, dtype=torch.bfloat16,
                             device="cpu")
    obj = tuning.KernelObjective(cell, reps=1, device="cpu")
    assert math.isnan(obj(cell.space.index_of({"block_q": 128,
                                               "block_kv": 256})))
    assert cell.valid(cell.default)
