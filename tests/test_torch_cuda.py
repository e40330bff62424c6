"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and skip elsewhere; they import nothing of
JAX, so they run on a card's host that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

import torch

from repro_torch.core.gp_fast import IncrementalGP
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import gemm as kgemm
from repro_torch.kernels import matern_gp as kgp

# a sibling module: on the card's host `tests` may name another package
from test_torch_gp64 import posterior64


@pytest.fixture
def card():
    """cuda:0, or a skip where there is none (decided per test, never at
    import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gp_inputs(t, N, d, nu, device, seed=5, distinct=False):
    """Padded GP inputs after t observations of an N-candidate panel:
    distinct candidates, as a BO run observes them, when ``distinct``;
    drawn with repeats otherwise."""
    rng = np.random.default_rng(seed)
    Xc = rng.random((N, d)).astype(np.float32)
    g = IncrementalGP(Xc, max_obs=max(64, t), kernel=nu, ell=2.0)
    pick = rng.permutation(N)[:t] if distinct else None
    for s in range(t):
        i = pick[s] if distinct else rng.integers(N)
        g.add(Xc[i], float(rng.normal(10, 3)))
    return [torch.from_numpy(x).to(device) for x in
            (Xc,) + ops.gp_inputs_from_incremental(g)[:4]]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-3)),
                                       (torch.bfloat16, (3e-2, 3e-2))])
@pytest.mark.parametrize("blocks", [(64, 64, 64), (128, 128, 64),
                                    (128, 64, 256), (64, 128, 128),
                                    (128, 128, 128), (256, 128, 64)])
def test_gemm_kernel_matches_plain(card, dtype, tol, blocks):
    """Every block shape the resource model passes agrees with the plain
    version (fp32 on the tensor cores as 3xTF32, bf16 on them directly).
    A shape it refuses, a ring with room for fewer than 2 stages (fp32
    128x64x256 and 128x128x128) or more threads than the launch bound
    (fp32 256x128x64: 512 of 224 registers), is refused at launch too."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(256, 512))).to(card, dtype)
    b = torch.from_numpy(rng.normal(size=(512, 384))).to(card, dtype)
    bm, bn, bk = blocks
    cfg = {"block_m": bm, "block_n": bn, "block_k": bk}
    kgemm.launches = 0
    if not ops.gemm_valid(cfg, a.element_size()):
        with pytest.raises(_build.LaunchRefused):
            kgemm.gemm(a, b, block_m=bm, block_n=bn, block_k=bk)
        assert kgemm.launches == 0
        return
    got = kgemm.gemm(a, b, block_m=bm, block_n=bn, block_k=bk)
    want = ref.gemm(a, b)
    torch.cuda.synchronize()
    assert kgemm.launches == 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


def test_gemm_fp32_keeps_fp32_accuracy_against_fp64(card):
    """3xTF32 at 1024³: the kernel's max|err| against an fp64 product is at
    most 4x the plain fp32 product's (plain TF32 would be about 100x)."""
    rng = np.random.default_rng(3)
    a64 = torch.from_numpy(rng.normal(size=(1024, 1024))).to(card)
    b64 = torch.from_numpy(rng.normal(size=(1024, 1024))).to(card)
    a, b = a64.float(), b64.float()
    exact = torch.matmul(a.double(), b.double())
    got = kgemm.gemm(a, b, block_m=128, block_n=128, block_k=64)
    plain = ref.gemm(a, b)
    k_err = float((got.double() - exact).abs().max())
    p_err = float((plain.double() - exact).abs().max())
    assert k_err <= 4 * p_err, (k_err, p_err)


def test_gemm_refused_launch_raises_launch_refused(card):
    """256x256x64 bf16: its 3-stage ring (207 KB) fits, but it needs 32
    warps (1024 threads) and the bf16 kernel is built for at most 512,
    which keeps a thread within 128 registers: the launcher refuses it with
    cudaErrorInvalidConfiguration, which the objective journals as
    invalid."""
    a = torch.zeros((1024, 1024), device=card, dtype=torch.bfloat16)
    assert kgemm.gemm_stages(256, 256, 64, 2) == 3
    assert kgemm.gemm_threads(256, 256) > kgemm.MAX_THREADS[2]
    kgemm.launches = 0
    with pytest.raises(_build.LaunchRefused):
        kgemm.gemm(a, a, block_m=256, block_n=256, block_k=64)
    assert kgemm.launches == 0
    torch.cuda.synchronize()                  # the context is intact


@pytest.mark.parametrize("nu", ["matern12", "matern32", "matern52", "rbf"])
@pytest.mark.parametrize("t,N,d", [(13, 512, 6), (37, 1024, 15)])
def test_gp_kernel_matches_plain(card, nu, t, N, d):
    args = _gp_inputs(t, N, d, nu, card)
    kgp.launches = 0
    mean_k, var_k = kgp.gp_posterior(*args, ell=2.0, nu=nu, block_n=256)
    mean_r, var_r = ref.gp_posterior(*args[:4], 2.0, nu, mask=args[4])
    torch.cuda.synchronize()
    assert kgp.launches == 1
    torch.testing.assert_close(var_k, var_r, rtol=3e-3, atol=1e-4)
    rng_m = float(mean_r.max() - mean_r.min())
    assert float((mean_k - mean_r).abs().max()) < 0.03 * rng_m


def _padded(args, T):
    """The GP inputs of ``_gp_inputs`` padded with zeros to ``T`` rows."""
    xc, xo, vinv, w, mask = args
    t = xo.shape[0]
    x_obs = torch.zeros((T, xo.shape[1]), device=xo.device)
    x_obs[:t] = xo
    vi = torch.zeros((T, T), device=xo.device)
    vi[:t, :t] = vinv
    out = [xc, x_obs, vi]
    for v in (w, mask):
        p = torch.zeros(T, device=xo.device)
        p[:t] = v
        out.append(p)
    return out


def _gp_agrees(args, block_n=128):
    mean_k, var_k = kgp.gp_posterior(*args, block_n=block_n)
    mean_r, var_r = ref.gp_posterior(*args[:4], 2.0, mask=args[4])
    torch.cuda.synchronize()
    torch.testing.assert_close(var_k, var_r, rtol=3e-3, atol=1e-4)
    rng_m = float(mean_r.max() - mean_r.min())
    assert float((mean_k - mean_r).abs().max()) < 0.03 * rng_m


def test_gp_kernel_takes_t_512(card):
    """A warm-started run pads T to 512: the kernel runs it (about 123 KB
    of shared memory, eight 64-row panels of L^-1) and agrees with its
    plain version."""
    _gp_agrees(_padded(_gp_inputs(37, 1024, 15, "matern32", card), 512))


def test_gp_kernel_counts_launches_by_covariance_and_t(card):
    """``launches_by`` counts each launch under (covariance, T), as
    ``launches`` counts it; the plain version counts nothing."""
    n0, by0 = kgp.launches, dict(kgp.launches_by)
    args = _padded(_gp_inputs(37, 1024, 15, "rbf", card), 512)
    kgp.gp_posterior(*args, nu="rbf", block_n=128)
    kgp.gp_posterior(*_gp_inputs(37, 1024, 15, "matern52", card),
                     nu="matern52", block_n=128)
    ref.gp_posterior(*args[:4], 2.0, "rbf", mask=args[4])
    torch.cuda.synchronize()
    assert kgp.launches == n0 + 2
    assert kgp.launches_by["rbf", 512] == by0.get(("rbf", 512), 0) + 1
    assert kgp.launches_by["matern52", 128] == \
        by0.get(("matern52", 128), 0) + 1


def test_gp_kernel_takes_t_1024(card):
    """600 observations (a budget over 512, or warm-start priors) pad T to
    1024: the kernel runs it (about 209 KB of shared memory, sixteen
    64-row panels of L^-1) and agrees with its plain version. The
    observations are distinct candidates, as a BO run makes them; the test
    below takes them with repeats."""
    args = _gp_inputs(600, 2048, 15, "matern32", card, distinct=True)
    assert args[1].shape[0] == 1024
    _gp_agrees(args)


def test_gp_kernel_nearer_fp64_than_plain_with_repeated_observations(card):
    """600 draws with repeats from 2,048 candidates observe some candidates
    twice, with different values: the covariance is then singular but for
    the 1e-6 noise, L^-1 and w = L^-1 y grow to thousands, and V = L^-1 K
    and mean = V^T w sum large terms that cancel. Both versions lose digits;
    the kernel's mean stays nearer the plain version run in float64 on the
    same inputs than the plain fp32 version does (3xTF32 products, each k8
    step summed apart, against one fp32 product over T)."""
    args = _gp_inputs(600, 2048, 15, "matern32", card)
    assert args[1].shape[0] == 1024
    mean_k, _ = kgp.gp_posterior(*args, block_n=128)
    mean_r, _ = ref.gp_posterior(*args[:4], 2.0, mask=args[4])
    mean_x, _ = ref.gp_posterior(*(a.double() for a in args[:4]), 2.0,
                                 mask=args[4].double())
    torch.cuda.synchronize()
    k_err = float((mean_k.double() - mean_x).abs().max())
    p_err = float((mean_r.double() - mean_x).abs().max())
    assert k_err <= p_err, (k_err, p_err)


def test_gp_kernel_t_not_a_multiple_of_16(card):
    """t = 21 real observations cut the diagonal L^-1 tile inside a 16-row
    fragment; T = 192 is three 64-row panels (six tiles of the lower
    triangle). The kernel agrees with its plain version."""
    _gp_agrees(_padded(_gp_inputs(21, 1024, 15, "matern32", card), 192))


# -- the serve path's kernels -----------------------------------------------------

def _bf16_close(got, want):
    """bf16: within 2^-7 x max|ref|, which holds one bf16 ulp of every
    output. Each version rounds its output to bf16 once from fp32 sums
    taken in another order, so an output next to a rounding boundary lands
    one ulp apart; that ulp can exceed the reference's 5e-3 x max|ref|
    (test_kernels.py:386)."""
    lim = 2.0 ** -7 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= lim


def _check(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bkv", [
    (1, 256, 4, 2, 64, 128, 64),          # small, block_q != block_kv
    (4, 1024, 8, 1, 256, 128, 256),       # fp32 only: bf16 is refused
    (4, 1024, 8, 1, 256, 128, 128),       # gemma-2b prefill: MQA, hd 256
    (4, 1024, 8, 1, 256, 256, 128),       # two sub-tiles a block, 2 updates
    (2, 192, 4, 2, 128, 64, 64),          # one warpgroup, S 192
    (1, 512, 4, 1, 64, 128, 512),         # 8 updates of 64 keys, 8 stages
])
def test_flash_kernel_matches_plain(card, dtype, B, S, H, KV, hd, bq, bkv):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd))).to(card, dtype)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(card, dtype)
            for _ in range(2))
    if not ops.flash_valid({"block_q": bq, "block_kv": bkv}, hd, dtype):
        # the bf16 ring of 4 stages at hd 256; fp32 runs it on the CUDA cores
        assert dtype == torch.bfloat16 and (hd, bkv) == (256, 256)
        with pytest.raises(_build.LaunchRefused):
            kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
        return
    kfa.launches = 0
    got = kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    want = ref.attention(q, k, v)
    torch.cuda.synchronize()
    assert kfa.launches == 1 and got.dtype == dtype
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bkv", [
    (1, 256, 4, 2, 64, 128, 64),          # small, block_q != block_kv
    (4, 1024, 8, 1, 256, 128, 128),       # gemma-2b prefill shape
    (4, 1024, 8, 1, 256, 256, 128),       # two sub-tiles a block
    (2, 192, 4, 2, 128, 64, 64),          # one warpgroup, S 192
])
def test_flash_kernel_full_attention_matches_plain(card, dtype, B, S, H, KV,
                                                   hd, bq, bkv):
    """causal=False (the reference's full mode): every key for every row."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd))).to(card, dtype)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(card, dtype)
            for _ in range(2))
    kfa.launches = 0
    got = kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv,
                              causal=False)
    want = ref.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kfa.launches == 1 and got.dtype == dtype
    if dtype == torch.float32:
        _check(got, want, dtype)
    else:
        # the plain version rounds the scores to bf16 (the reference's
        # ref.attention does); the kernel keeps them in fp32: held to it at
        # the reference's bf16 tolerance (tests/test_kernels.py:55), and to
        # the plain version in fp32 on the same inputs at one output ulp
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)
        _bf16_close(got, ref.attention(q.float(), k.float(), v.float(),
                                       causal=False).to(dtype))
    # the first row sees the whole sequence: not the causal answer
    causal = ref.attention(q, k, v)
    assert float((want[:, 0] - causal[:, 0]).float().abs().max()) > 1e-2


def test_flash_refused_config_raises_launch_refused(card):
    """bf16 block_kv 256 at hd 256 is a ring of 4 stages of 64 keys, 321
    KB of shared memory with the 128-row q sub-tile: the resource model
    marks it invalid and the card refuses it."""
    assert not ops.flash_valid({"block_q": 128, "block_kv": 256}, 256,
                               torch.bfloat16)
    q = torch.zeros((1, 512, 1, 256), device=card, dtype=torch.bfloat16)
    kfa.launches = 0
    with pytest.raises(_build.LaunchRefused):
        kfa.flash_attention(q, q, q, block_q=128, block_kv=256)
    assert kfa.launches == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,cur,bkv,ns", [
    (2, 200, 4, 2, 64, 97, 64, 4),        # small, capacity does not tile
    (4, 1088, 8, 1, 256, 1054, 256, 4),   # gemma-2b decode at 64 steps
    (4, 1088, 8, 1, 256, 1054, 128, 8),   # splits 5..7 hold only padding
    (1, 1088, 8, 1, 256, 1054, 1024, 1),  # B 1: one split of 17 chunks
    (2, 1024, 8, 1, 128, 5, 128, 2),      # mostly empty: masked chunks
    (66, 64, 8, 4, 64, 60, 64, 1),        # one block a group: no fold
])
def test_decode_kernels_match_plain(card, dtype, B, S, H, KV, hd, cur, bkv,
                                    ns):
    """combine="kernel" is one launch, the combine fused into the split
    kernel; its partials mode (decode_split) against the plain split."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, hd))).to(card, dtype)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(card, dtype)
            for _ in range(2))
    pos = np.where(np.arange(S) <= cur, np.arange(S), -1)
    cp = torch.from_numpy(np.broadcast_to(pos, (B, S)).copy()).to(card)
    cu = torch.full((B,), cur, device=card)
    kfd.split_launches = kfd.combine_launches = 0
    got = ops.decode_attention(q, k, v, cp, cu, block_kv=bkv, num_splits=ns,
                               combine="kernel")
    torch.cuda.synchronize()
    assert kfd.split_launches == 1 and kfd.combine_launches == 1
    bias = ops.decode_bias(cp, cu, None, ns * bkv)
    o, m, l = ref.decode_split(q[:, 0], k, v, bias, ns)
    want = ref.combine_partials(o, m, l).reshape(B, 1, H, hd).to(dtype)
    _check(got, want, dtype)
    ko, km, kl = kfd.decode_split(q[:, 0], k, v, bias, block_kv=bkv,
                                  num_splits=ns)
    torch.testing.assert_close(km, m, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kl, l, rtol=1e-3, atol=1e-4)
    empty = torch.isinf(m)                 # no valid slot, padding included
    assert torch.all(km[empty] == -float("inf"))
    assert torch.all(kl[empty] == 0) and torch.all(ko[empty] == 0)
    Sp = bias.shape[1]
    C, chunk = kfd.decode_plan(B, KV, S, Sp, ns)
    n = B * KV * ns
    if -(-min(Sp // ns, S) // kfd.TILE) * n >= kfd.FILL_BLOCKS:
        assert n * C >= kfd.FILL_BLOCKS
    # the arrival counters are reset: a second launch gives the same
    ko2, km2, kl2 = kfd.decode_split(q[:, 0], k, v, bias, block_kv=bkv,
                                     num_splits=ns)
    assert torch.equal(km2, km) and torch.equal(kl2, kl)
    assert kfd.split_launches == 3 and kfd.combine_launches == 1


def _decode_problem(card, dtype, B, S, H, KV, hd, curs, bkv, ns):
    """q, caches and bias of a cache filled to ``curs[b]`` in row b (-1:
    no valid slot)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(B, H, hd))).to(card, dtype)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(card, dtype)
            for _ in range(2))
    pos = np.stack([np.where(np.arange(S) <= c, np.arange(S), -1)
                    for c in curs])
    cp = torch.from_numpy(pos).to(card)
    cu = torch.tensor(curs, device=card)
    return q, k, v, ops.decode_bias(cp, cu, None, ns * bkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,bkv,ns", [
    (4, 1088, 8, 1, 256, 128, 8),         # folds 17 chunks of 5 splits
    (4, 1088, 8, 1, 256, 1024, 1),        # folds the chunks of one split
    (132, 64, 8, 1, 64, 64, 1),           # one block a group: no fold
])
def test_decode_group_with_no_valid_slot_gives_exact_zeros(
        card, dtype, B, S, H, KV, hd, bkv, ns):
    """A head group whose every slot is masked gives exact zeros (the
    reference's 0 / 1e-30), not NaN; the other groups agree with the plain
    version."""
    curs = [-1 if b % 2 else S - 30 for b in range(B)]
    q, k, v, bias = _decode_problem(card, dtype, B, S, H, KV, hd, curs, bkv,
                                    ns)
    got = kfd.flash_decode(q, k, v, bias, block_kv=bkv, num_splits=ns,
                           combine="kernel")
    want = ref.combine_partials(*ref.decode_split(q, k, v, bias, ns)
                                ).reshape(B, H, hd).to(dtype)
    torch.cuda.synchronize()
    assert torch.all(got[1::2] == 0) and torch.all(want[1::2] == 0)
    _check(got[0::2], want[0::2], dtype)


def test_fused_and_partials_launches_on_one_stream_repeat_bitwise(card):
    """fused -> partials -> fused on one stream: the second fused output
    equals the first bit for bit, so each mode's arrival counters are
    reset by the kernel and never shared between the modes."""
    q, k, v, bias = _decode_problem(card, torch.bfloat16, 4, 1088, 8, 1,
                                    256, [1054] * 4, 128, 8)
    kw = dict(block_kv=128, num_splits=8)
    kfd.split_launches = kfd.combine_launches = 0
    first = kfd.flash_decode(q, k, v, bias, combine="kernel", **kw)
    parts = kfd.decode_split(q, k, v, bias, **kw)
    second = kfd.flash_decode(q, k, v, bias, combine="kernel", **kw)
    again = kfd.decode_split(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert kfd.split_launches == 4 and kfd.combine_launches == 2
    assert torch.equal(first, second)
    assert all(torch.equal(a, b) for a, b in zip(parts, again))
    want = ref.combine_partials(*parts).reshape(4, 8, 256).to(torch.bfloat16)
    _check(first, want, torch.bfloat16)


def test_kernel_objective_times_back_to_back_fused_decode_launches(card):
    """The tuning objective times n back-to-back launches per rep (n from
    one timed launch: a 0.02 ms kernel gets more than one), queued behind a
    spin, so it reads the card's time (0.0165 ms for this call) and not the
    host's pace (0.11-0.19 ms a call). The fused decode kernel resets its
    own arrival counters, so the last of n launches on one stream still
    agrees with the plain version."""
    from repro_torch.kernels import tuning
    cell = tuning.decode_cell(4, 1088, 8, 1, 256, fill=0.97,
                              dtype=torch.bfloat16, device=card)
    cfg = {"block_kv": 256, "num_splits": 4, "combine": "kernel"}
    obj = tuning.KernelObjective(cell, reps=2, device=card)
    kfd.split_launches = 0
    t = obj(cell.space.index_of(cfg))
    n, lead = obj._rep_plan(cfg)
    assert 1 < n <= obj.MAX_LAUNCHES and lead > obj.LEAD_MIN_S
    assert 0 < t < 5e-5
    first = cell.run(cfg)
    for _ in range(n - 1):
        last = cell.run(cfg)
    torch.cuda.synchronize()
    assert torch.equal(first, last)
    q, k, v, cp, cu = cell.meta["inputs"]
    bias = ops.decode_bias(cp, cu, None, 4 * 256)
    want = ref.combine_partials(*ref.decode_split(q[:, 0], k, v, bias, 4)
                                ).reshape(last.shape).to(torch.bfloat16)
    _check(last, want, torch.bfloat16)
    # a 2.4 ms GEMM keeps one launch a rep
    gcell = tuning.gemm_cell(4096, 4096, 4096, device=card)
    gcfg = {"block_m": 128, "block_n": 128, "block_k": 64}
    gobj = tuning.KernelObjective(gcell, device=card)
    assert gobj(gcell.space.index_of(gcfg)) > 1e-3
    assert gobj._rep_plan(gcfg)[0] == 1


def test_padded_gp_on_the_card_matches_the_cpu(card):
    """The frameworks' padded GP (Matérn-5/2, ℓ=1, noise 1e-4) with
    duplicate snapped rows and an imputed penalty, on the card and on the
    CPU: the card's posterior is within 8x the CPU's fp32 error against
    the float64 yardstick ``posterior64`` (plus 1e-5 of the scale)."""
    from repro_torch.core import gp as G
    rng = np.random.default_rng(11)
    d, t = 15, 220
    pool = rng.random((160, d)).astype(np.float32)
    gps = {dev: G.GP(d, max_obs=t + 8, kernel="matern52", ell=1.0,
                     noise=1e-4, device=dev) for dev in (str(card), "cpu")}
    for i in range(t):
        x = pool[rng.integers(len(pool))]
        y = 5e3 if i % 17 == 0 else float(rng.normal(10, 2))
        for g in gps.values():
            g.add(x, y)
    cand = rng.random((2048, d)).astype(np.float32)
    got = [t_.cpu().double().numpy() for t_ in gps[str(card)].predict(cand)]
    cpu = [t_.double().numpy() for t_ in gps["cpu"].predict(cand)]
    g = gps["cpu"]
    exact = posterior64(g.X, g.y, g.mask, cand, kernel="matern52", ell=1.0,
                        noise=1e-4)[:2]
    for a, b, e in zip(got, cpu, exact):
        assert np.isfinite(a).all()
        bound = 8 * np.abs(b - e).max() + 1e-5 * np.abs(e).max()
        assert np.abs(a - e).max() <= bound


def test_decode_server_on_the_card_launches_the_kernels(card):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
    cfg = smoke_config("gemma-2b").replace(head_dim=64, dtype="float32")
    kc = KernelConfig(use_flash=True, flash_block_q=128, flash_block_kv=64,
                      use_decode=True, decode_block_kv=128,
                      decode_num_splits=2, decode_combine="kernel")
    runs = {}
    for name, k in (("kernels", kc), ("plain", None)):
        srv = serve.DecodeServer(cfg, ParallelConfig(kernel=k), batch=2,
                                 prompt_len=128, decode_steps=4, device=card,
                                 keep_logits=4)
        serve.reset_kernel_launches()
        srv.prefill_batch(srv.input_batch())
        for _ in range(4):
            srv.decode_step()
        runs[name] = (srv, serve.kernel_launches())
    launches = runs["kernels"][1]
    # 2 layers x (4 steps replayed + the capture's warm-up step)
    assert launches == {"flash_attention": 2, "flash_decode_split": 10,
                        "flash_decode_combine": 10}
    assert runs["plain"][1] == {"flash_attention": 0,
                                "flash_decode_split": 0,
                                "flash_decode_combine": 0}
    for a, b in zip(runs["kernels"][0].kept, runs["plain"][0].kept):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


def test_decode_server_on_the_card_refuses_what_the_kernels_do_not_take(card):
    """On the card an opted-in server runs the kernels or raises: a prompt
    the flash blocks do not tile launches nothing and serves nothing."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
    cfg = smoke_config("gemma-2b").replace(head_dim=64, dtype="float32")
    srv = serve.DecodeServer(
        cfg, ParallelConfig(kernel=KernelConfig(use_flash=True,
                                                use_decode=True)),
        batch=1, prompt_len=96, decode_steps=2, device=card)
    serve.reset_kernel_launches()
    with pytest.raises(ValueError, match="do not tile a prefill of 96"):
        srv.prefill_batch(srv.input_batch())
    assert serve.kernel_launches()["flash_attention"] == 0
    with pytest.raises(ValueError, match="not a multiple of 64"):
        serve.serving_kernel_config(cfg, device=card, prompt_len=32,
                                    cache_cap=40, batch=1)
    kc = serve.serving_kernel_config(cfg, device=card, prompt_len=192,
                                     cache_cap=194, batch=1)
    assert (kc.flash_block_q, kc.flash_block_kv) == (64, 64)


# -- the decode step as a captured CUDA graph ---------------------------------

_KC_A = dict(use_flash=True, flash_block_q=128, flash_block_kv=64,
             use_decode=True, decode_block_kv=128, decode_num_splits=2,
             decode_combine="kernel")
_KC_B = {"block_kv": 256, "num_splits": 1, "combine": "kernel"}


def _graph_server(card, prompt_len=128, steps=8, keep=8, arch="gemma-2b",
                  **kw):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
    cfg = smoke_config(arch).replace(head_dim=64, **kw)
    return serve.DecodeServer(cfg, ParallelConfig(kernel=KernelConfig(
        **_KC_A)), batch=2, prompt_len=prompt_len, decode_steps=steps,
        device=card, keep_logits=keep)


def _eager_logits(srv):
    """The eager step function on the server's state, for the token the
    next step decodes (it writes the cache slot that step rewrites)."""
    logits, _ = srv.decode(srv.params, srv.cache,
                           {"tokens": srv.toks[:, None]}, srv.pos)
    return logits.float().cpu()


def test_graph_replay_equals_eager_step(card):
    srv = _graph_server(card)
    srv.prefill_batch(srv.input_batch())
    eager = []
    for _ in range(8):
        eager.append(_eager_logits(srv))
        srv.decode_step()
    assert srv.captures == 1 and "CUDA graph" in srv.decode_dispatch
    for e, g in zip(eager, srv.kept[1:]):
        torch.testing.assert_close(g, e, rtol=0, atol=2.0 ** -7 * float(
            e.abs().max()))


def test_graph_swap_back_is_a_cache_hit(card):
    """A -> B -> A: two captures, the return replays A's graph."""
    from repro_torch.kernels.cache import config_key
    srv = _graph_server(card)
    srv.prefill_batch(srv.input_batch())
    srv.decode_step()
    first = config_key(_KC_A)
    srv.apply_kernel_config(_KC_B)
    srv.decode_step()
    srv.apply_kernel_config({"block_kv": 128, "num_splits": 2,
                             "combine": "kernel"})
    srv.decode_step()
    assert config_key(_KC_A) == first and srv.captures == 2
    assert srv.kernel_cache.stats() == {"hits": 1, "misses": 2,
                                        "evictions": 0, "entries": 2}
    assert srv.kernel_swaps == 2


def test_graph_launch_counts_include_replays(card):
    from repro_torch.launch import serve
    srv = _graph_server(card)
    srv.prefill_batch(srv.input_batch())
    serve.reset_kernel_launches()
    for _ in range(5):
        srv.decode_step()
    n_layers = srv.cfg.num_layers
    # 5 replays and the capture's one warm-up step, each a launch a layer
    assert serve.kernel_launches() == {
        "flash_attention": 0, "flash_decode_split": 6 * n_layers,
        "flash_decode_combine": 6 * n_layers}


def test_graph_survives_a_second_prefill(card):
    """prefill -> decode -> prefill (another prompt) -> decode through the
    graph captured in the first sequence, against the eager step functions
    on a cache of their own: a graph that read the first prefill's cache
    buffers would disagree."""
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    srv = _graph_server(card, steps=4, keep=4, dtype="float32")
    srv.prefill_batch(srv.input_batch())
    for _ in range(4):
        srv.decode_step()
    gen = torch.Generator().manual_seed(7)
    other = {"tokens": torch.randint(0, srv.cfg.vocab_size, (2, 128),
                                     generator=gen).to(card)}
    srv.prefill_batch(other)
    for _ in range(4):
        srv.decode_step()
    assert srv.captures == 1
    prefill = make_prefill_step(srv.cfg, srv.pcfg, cache_cap=srv.cache_cap)
    decode = make_decode_step(srv.cfg, srv.pcfg)
    logits, cache = prefill(srv.params, other)
    want = [logits.float().cpu()]
    for i in range(4):
        logits, cache = decode(srv.params, cache,
                               {"tokens": srv.out[i][:, None]}, 128 + i)
        want.append(logits.float().cpu())
    for g, w in zip(srv.kept, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# -- the shapes of the dense and MoE families: hd 80, G up to 16 ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bkv", [
    (4, 1024, 32, 32, 80, 128, 128),      # stablelm-3b prefill: hd 80, MHA
    (2, 192, 4, 2, 80, 64, 64),           # one warpgroup, S 192
    (1, 256, 12, 1, 80, 256, 128),        # two sub-tiles a block, G 12
    (4, 1024, 32, 4, 128, 128, 128),      # qwen3-moe prefill: G 8
])
def test_flash_kernel_at_the_new_shapes_matches_plain(card, dtype, B, S, H,
                                                      KV, hd, bq, bkv):
    """Causal against the plain version; full attention in fp32 too (bf16
    full is held in chip_smoke.py, against the plain version in fp32). At
    hd 80 the bf16 kernel stages two 64-column panels: the padded columns
    must never reach the output."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd))).to(card, dtype)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(card, dtype)
            for _ in range(2))
    assert ops.flash_valid({"block_q": bq, "block_kv": bkv}, hd, dtype)
    kfa.launches = 0
    got = kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
    torch.cuda.synchronize()
    assert kfa.launches == 1 and got.shape == q.shape
    _check(got, ref.attention(q, k, v), dtype)
    if dtype == torch.float32:
        full = kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv,
                                   causal=False)
        _check(full, ref.attention(q, k, v, causal=False), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,curs,bkv,ns", [
    (4, 1088, 96, 8, 128, (1054,) * 4, 256, 4),   # mistral-large: G 12
    (4, 1088, 32, 4, 128, (1054,) * 4, 512, 2),   # qwen3-moe: G 8
    (4, 1088, 32, 32, 80, (1054,) * 4, 128, 8),   # stablelm-3b: hd 80
    (2, 1088, 16, 1, 128, (1054, -1), 1024, 1),   # G 16, a row with no slot
    (2, 512, 32, 2, 80, (300, 300), 128, 4),      # G 16 at hd 80
    (2, 1024, 24, 2, 80, (5, -1), 128, 2),        # G 12, hd 80, mostly empty
    (33, 64, 12, 1, 80, (60,) * 33, 64, 1),       # one block a group
])
def test_decode_kernels_at_the_new_shapes_match_plain(card, dtype, B, S, H,
                                                      KV, hd, curs, bkv, ns):
    """The 16-row instance (G 9..16) and hd 80, fused (one launch) and in
    partials mode, against the plain split + combine; a head group with no
    valid slot gives exact zeros."""
    q, k, v, bias = _decode_problem(card, dtype, B, S, H, KV, hd, list(curs),
                                    bkv, ns)
    kfd.split_launches = kfd.combine_launches = 0
    got = kfd.flash_decode(q, k, v, bias, block_kv=bkv, num_splits=ns,
                           combine="kernel")
    o, m, l = ref.decode_split(q, k, v, bias, ns)
    want = ref.combine_partials(o, m, l).reshape(B, H, hd).to(dtype)
    torch.cuda.synchronize()
    assert kfd.split_launches == 1 and kfd.combine_launches == 1
    _check(got, want, dtype)
    empty = [b for b, c in enumerate(curs) if c < 0]
    assert torch.all(got[empty] == 0)
    ko, km, kl = kfd.decode_split(q, k, v, bias, block_kv=bkv, num_splits=ns)
    torch.testing.assert_close(km, m, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kl, l, rtol=1e-3, atol=1e-4)
    dead = torch.isinf(m)
    assert torch.all(kl[dead] == 0) and torch.all(ko[dead] == 0)
    two = kfd.flash_decode(q, k, v, bias, block_kv=bkv, num_splits=ns,
                           combine="torch")
    _check(two, want, dtype)


def test_moe_graph_replay_equals_eager_step(card):
    """qwen3-moe's smoke model (head dim 64, which the kernels take): the
    decode step, the MoE block's routing and dispatch in it, is captured as
    a CUDA graph; each replay equals the eager step function on the same
    state, and every attention launch is a kernel's."""
    from repro_torch.launch import serve
    srv = _graph_server(card, arch="qwen3-moe-30b-a3b")
    serve.reset_kernel_launches()
    srv.prefill_batch(srv.input_batch())
    eager = []
    for _ in range(8):
        eager.append(_eager_logits(srv))
        srv.decode_step()
    assert srv.captures == 1 and "CUDA graph" in srv.decode_dispatch
    n = srv.cfg.num_layers
    # prefill, 8 eager steps, the capture's warm-up step and 8 replays
    assert serve.kernel_launches() == {
        "flash_attention": n, "flash_decode_split": 17 * n,
        "flash_decode_combine": 17 * n}
    for e, g in zip(eager, srv.kept[1:]):
        torch.testing.assert_close(g, e, rtol=0, atol=2.0 ** -7 * float(
            e.abs().max()))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_recurrent_graph_replay_equals_eager_step(card, arch):
    """RG-LRU (with a rolling window of 16 under a prompt of 128) and
    xLSTM smoke models: a replay writes the recurrent state into the
    server's own buffers, so each replay equals the eager step function
    on the same state. The eager step advances that state in place too, so
    it runs on a copy of the cache that is put back before the replay."""
    from repro_torch.launch import serve
    srv = _graph_server(card, arch=arch)
    serve.reset_kernel_launches()
    srv.prefill_batch(srv.input_batch())
    eager = []
    for _ in range(8):
        with torch.inference_mode():
            saved = [{k: t.clone() for k, t in layer.items()}
                     for layer in srv.cache]
            eager.append(_eager_logits(srv))
            for layer, old in zip(srv.cache, saved):
                for k, t in layer.items():
                    t.copy_(old[k])
        srv.decode_step()
    assert srv.captures == 1 and "CUDA graph" in srv.decode_dispatch
    n_attn = sum(k == "attn" for k in serve.layer_kinds(srv.cfg))
    # the windowed layers' prefill is plain; decode: 8 eager steps, the
    # capture's warm-up step and 8 replays
    assert serve.kernel_launches() == {
        "flash_attention": 0, "flash_decode_split": 17 * n_attn,
        "flash_decode_combine": 17 * n_attn}
    for e, g in zip(eager, srv.kept[1:]):
        torch.testing.assert_close(g, e, rtol=0, atol=2.0 ** -7 * float(
            e.abs().max()))


def _grad_operands(card):
    """One small call of each kernel's wrapper, its first operand made to
    require grad: (name, call)."""
    g = torch.Generator(device=card).manual_seed(0)

    def rand(*shape, dtype=torch.float32, grad=False):
        return torch.randn(*shape, generator=g, device=card, dtype=dtype,
                           requires_grad=grad)

    def flash(grad):
        return kfa.flash_attention(rand(1, 128, 2, 64, grad=grad),
                                   rand(1, 128, 2, 64), rand(1, 128, 2, 64),
                                   block_q=64, block_kv=64)

    def decode(grad):
        bias = torch.zeros(1, 128, device=card)
        return kfd.flash_decode(rand(1, 2, 64, grad=grad),
                                rand(1, 128, 1, 64), rand(1, 128, 1, 64),
                                bias, block_kv=128, num_splits=1)

    def gemm(grad):
        return kgemm.gemm(rand(128, 128, grad=grad), rand(128, 128),
                          block_m=64, block_n=64, block_k=64)

    def gp(grad):
        xc, xo, vinv, w, mask = _gp_inputs(13, 512, 6, "matern32", card)
        return kgp.gp_posterior(xc.requires_grad_(grad), xo, vinv, w, mask,
                                block_n=512)

    return [("flash_attention", flash), ("flash_decode", decode),
            ("gemm", gemm), ("gp_posterior", gp)]


def test_kernels_refuse_an_operand_that_requires_grad(card):
    """No kernel has a backward: in grad mode a CUDA operand that requires
    grad raises instead of returning an output with no gradient; under
    no_grad (or with no operand requiring grad) the same call launches."""
    for name, call in _grad_operands(card):
        with pytest.raises(ValueError, match="no backward"):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)
    torch.cuda.synchronize()


def test_a_train_step_on_the_card_matches_the_cpu(card):
    """One AdamW train step of the gemma-2b smoke model at head dim 64, in
    fp32 (TF32 off), the same weights and batch on the card and on the CPU:
    the loss and global norm within 1e-5 relative, the new weights within
    1e-3 of each leaf's update norm; the flash kernel opted in is refused
    before any step."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import make_train_step
    from repro_torch.optim.optimizers import AdamW, warmup_cosine
    from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
    cfg = smoke_config("gemma-2b").replace(head_dim=64, dtype="float32")
    pcfg = ParallelConfig(flash_threshold=1 << 30, logits_chunk=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", card):
        params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        before = {p: t.clone() for p, t in P.leaves(params)}
        params = P.map_tree(lambda t: t.to(dev), params)
        opt = AdamW(schedule=warmup_cosine(3e-3, 1, 3), weight_decay=0.01)
        params, _, met = make_train_step(cfg, pcfg, opt)(
            params, opt.init(params), {"tokens": tokens.to(dev)}, 0)
        out[str(dev)] = (met, {p: t.cpu() for p, t in P.leaves(params)})
    (cm, cp), (gm, gp) = out["cpu"], out[str(card)]
    for k in ("loss", "grad_norm"):
        assert float(gm[k]) == pytest.approx(float(cm[k]), rel=1e-5)
    for path, b in before.items():
        d_cpu, d_card = cp[path] - b, gp[path] - b
        assert float((d_card - d_cpu).norm()) <= 1e-3 * float(d_cpu.norm())
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, pcfg.replace(kernel=KernelConfig(
            use_flash=True)), AdamW(schedule=warmup_cosine(3e-3, 1, 3)))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_the_dry_run_matches_a_step_on_the_card(card, kind):
    """gemma-2b's smoke layers widened (5 layers, d_model 512, hd 128, a
    vocab of 8,192) traced on meta tensors (depth cut: traced at 1 and 2
    layers) against the same step on the card: the arguments' bytes
    equal, the FLOPs equal to FlopCounterMode over the card's step, the
    dry peak within 10% of the arguments plus max_memory_allocated above
    them (at these widths the allocator's 512-byte rounding of small
    tensors is far below 10% of the peak; at the smoke widths it is
    not)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.arch import ShapeConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.stepfn import (make_decode_step,
                                           make_prefill_step, make_train_step)
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.optim.optimizers import AdamW, constant_lr
    from repro_torch.parallel.sharding import ParallelConfig
    cfg = smoke_config("gemma-2b").replace(
        num_layers=5, d_model=512, d_ff=2048, head_dim=128, vocab_size=8192)
    shape = ShapeConfig("s", 256, 4, kind)
    pcfg = ParallelConfig(logits_chunk=0)
    dry = dryrun.measure(cfg, shape, pcfg)
    gen = torch.Generator(device=card).manual_seed(0)
    params = P.init_params(cfg, gen, card)
    toks = torch.randint(0, cfg.vocab_size, (4, 1 if kind == "decode"
                                             else 256), device=card,
                         generator=gen)
    if kind == "train":
        opt = AdamW(schedule=constant_lr(1e-4))
        args = (params, opt.init(params), {"tokens": toks}, 0)
        step = make_train_step(cfg, pcfg, opt)
    elif kind == "prefill":
        args = (params, {"tokens": toks})
        step = make_prefill_step(cfg, pcfg, 256)
    else:
        args = (params, M.init_cache(cfg, 4, 256, device=card),
                {"tokens": toks}, torch.tensor(10, device=card))
        step = make_decode_step(cfg, pcfg)
    assert dryrun.storage_bytes(args) == dry["args"] == dryrun.storage_bytes(
        input_specs(cfg, shape, None, pcfg, optimizer=AdamW(
            schedule=constant_lr(1e-4)) if kind == "train" else None))
    torch.cuda.synchronize(card)
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    step(*args)
    torch.cuda.synchronize(card)
    real = dry["args"] + torch.cuda.max_memory_allocated(card) - base
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert fc.get_total_flops() == dry["flops"]
    dry_peak = dry["args"] + dry["temp"]
    assert abs(dry_peak - real) <= 0.1 * real, (dry_peak, real)


def test_compression_on_the_card_matches_the_cpu(card):
    """At world size 1: the plain mean and top-k (values and residuals)
    equal to the CPU's; int8 within 0.02 of the largest entry (the card's
    generator draws another dither)."""
    from repro_torch.parallel import compression as C
    g = torch.randn(128, 32, generator=torch.Generator().manual_seed(0))
    r = torch.randn(128, 32, generator=torch.Generator().manual_seed(1))
    out = {}
    for where in ("cpu", card):
        out[str(where)] = {m: C.compress_tree_psum(
            {"w": g.to(where)}, {"w": r.to(where)}, C.Reduction.local(), m,
            seed=0, k_frac=0.25) for m in ("none", "topk", "int8")}
    cpu, gpu = out["cpu"], out[str(card)]
    for m in ("none", "topk"):
        for i in (0, 1):
            assert torch.equal(gpu[m][i]["w"].cpu(), cpu[m][i]["w"])
    d = (gpu["int8"][0]["w"].cpu() - cpu["int8"][0]["w"]).abs().max()
    assert float(d) <= 0.02 * float(g.abs().max())
