#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, and check it.

    python3 chip_smoke.py            # every phase, on cuda:0
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, in order; any failure exits non-zero and prints no result:
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel under src/repro_torch/kernels/csrc, registers per thread
     and spills of every instance;
  2. each CUDA kernel against its plain PyTorch version on the card: GEMM in
     fp32 and bf16 at 128³, 256x384x512 and 4096³ under the block configs
     the resource model passes, and at 4096³ fp32 against an fp64 product
     on the card (the kernel's error at most 4x the plain version's); the
     Matérn-GP posterior for all four ν at (t,N,d) = (13,512,6),
     (37,1024,15) and the paper's panel (220,18432,15) padded to T = 256;
     flash attention in fp32 (CUDA cores) and bf16 (tensor cores), causal
     and full (causal=False), at small shapes, S 192, and gemma-2b's
     prefill (B 4, S 1,024, H 8, KV 1, hd 256) under several blocks:
     block_q != block_kv, one and two warpgroups, block_kv > 64 (successive
     64-key updates); flash decode,
     every config both ways (one launch with the combine fused in, and the
     partials mode + the tensor-op combine), in fp32 and bf16 at gemma-2b's
     decode (B 4, capacity 1,088, H 8, KV 1, hd 256) and at its widths with
     B 1, at G = 1 and 2, with one block a head group, and on a mostly
     empty cache, a capacity that does not tile, windows with and without
     wrap-around, and a row with no valid slot (exact zeros), the
     partials held against the plain version's too (splits of padding only
     exactly m = -inf, l = 0, o = 0);
  3. the self-hosting cell: BO tunes the GP kernel's block_n at the paper's
     panel, journaled into a temporary store, and tuned_gp_block_n reads
     the stored best back;
  4. slice 1's main path: BO, its surrogate on the GP kernel with that
     block_n, tunes the 4096³ fp32 GEMM kernel, journaled into the store;
  5. the paper-scale surrogate: advanced_multi BO over the paper's CLBlast
     GEMM space (17,956 configs) for 220 evaluations with gp_backend="cuda",
     beside a gp_backend="numpy" run of the same seed;
  7. BO, its surrogate on the GP kernel, tunes the serve kernels at
     gemma-2b's shapes in bf16: the decode cell, then the flash cell,
     journaled into the same store;
  8. slice 2's main path: launch/serve.py's DecodeServer serves gemma-2b
     at full width and depth (random bf16 weights from a seed): prefill of
     4 x 1,024 tokens, 64 greedy decode steps, each a replay of the decode
     step's captured CUDA graph, blocks resolved from the store; its logits
     are held against the plain attention path, teacher-forced on the same
     tokens; one decode launch a layer, the combine fused in, on the path
     or in an extra decode run of 8 steps (replays count the launches they
     hold, and a capture's warm-up step its own); the graph's logits
     against the eager step function's on the same state (bit for bit or
     not, within the serve limit); ms/step eager against graph in turns;
 10. the online loop on a copy of the phase-7 store, as serve --online
     --kernels wires it: gemma-2b at prompt 1,024 and 128 steps (a cache
     of 1,152, a decode cell never tuned: stale), one durable job, the
     retune daemon's BO on the card (the GP kernel its surrogate) journaled
     under its fence token, the hot-swap at the next poll (or the source's
     reason to keep its config), a forced swap back that must be a graph-
     cache hit, prod records, every decode launch fused, and the last steps
     against the plain attention path;
 11. slice 7's main path, the paper's comparison set: (a) Fig. 1's seven
     strategies, Fig. 5's two framework analogues and BO on the padded GP
     (engine="jax") over the GTX Titan X GEMM space (17,956 configs) at
     the paper's budget of 220, BO's surrogate on the GP kernel and the
     padded GPs on the card: MAE, best, evaluations, wall and tuner time,
     GP launches; each baseline against its run on the CPU, each padded
     GP's last state against the CPU and float64, its fit + predict ms;
     (b) pool BO, its surrogate on the GP kernel, over a 1.07e9-config
     generative space beside the numpy surrogate's run (feasible, no
     revisit, the same initial sample, the posterior at pool sizes that do
     not tile the kernel's block), and the wide qwen3-moe sharding space
     (size, feasible-fraction estimate, first sample); (c) the four
     baselines and the two frameworks tune phase 4's GEMM cell with its
     budget, journaled into the store (best, evaluations to it, static and
     runtime invalids);
  6. yardsticks at the blocks phases 4 and 8 ran: kernel, plain-version
     and library times (CUDA events around one call) beside each kernel's
     bound (GEMM and GP: on the path the kernel takes, the tensor cores,
     and on the CUDA cores), and the bf16 GEMM beside torch.matmul;
  9. torch.profiler, last (a profiler session leaves host overhead behind
     it): the device's busy share over a prefill and over 4 decode steps of
     the phase-8 server (graph replays, no logits kept), the kernels that
     took its time (one decode kernel a layer and step), and each phase-6
     call's device time (kernels only, no host launch time), the flash
     kernel's full-attention instance beside SDPA(is_causal=False) among
     them; the fused decode call launches one kernel. The
     combine's time is the fused launch's less the partials-mode launch's,
     on the same inputs, timed in turns.
The line before the last holds the kernels' JSON summary (times are the
phase-9 device times, the phase-6 event times where the profiler saw none;
the GEMM's and the GP kernel's launches are phases 4 and 11 together),
the one before it the card's name and power limit; the last line is the
device JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

GEMM_SHAPES = ((128, 128, 128), (256, 384, 512), (4096, 4096, 4096))
GEMM_BLOCKS = ((64, 64, 64), (128, 128, 64), (64, 128, 128), (128, 64, 256),
               (128, 128, 128),
               # next to the reference's 256³ default, where the resource
               # model passes them (1 to 4 ring stages)
               (256, 128, 64), (128, 256, 64), (256, 128, 128),
               (128, 256, 128), (256, 64, 64), (64, 256, 64))
# the last pads T to 1024: 513 to 1024 observations, from a budget over
# 512 or warm-start priors. Its observations are distinct candidates, as a
# BO run makes them; the others are drawn with repeats
GP_T1024 = (600, 2048, 15)
GP_SHAPES = ((13, 512, 6), (37, 1024, 15), (220, 18432, 15), GP_T1024)
MAIN_GEMM = (4096, 4096, 4096)
MAIN_GP = (220, 18432, 15)          # 17,956 candidates padded to a tile multiple
MAIN_T = 256
# flash attention: (B, S, H, KV, hd) and (block_q, block_kv)
FLASH_SHAPES = ((1, 256, 4, 4, 64), (2, 512, 4, 2, 128), (4, 1024, 8, 1, 256),
                (2, 192, 4, 2, 128))
# bf16: block_kv > 64 is successive 64-key updates, block_q a multiple of
# 128 puts two warpgroups in a block, block_q 64 one
FLASH_BLOCKS = ((128, 128), (128, 64), (64, 128), (256, 128), (128, 256),
                (512, 256), (64, 64), (128, 512))
GEMMA_FLASH = (4, 1024, 8, 1, 256)
# flash decode: (name, B, S, H, KV, hd, cur, window, rolling); cur per row
# where it is a tuple (-1: a row with no valid slot)
DECODE_CASES = (
    ("gemma-2b decode", 4, 1088, 8, 1, 256, 1054, None, False),
    ("gemma-2b widths, B 1", 1, 1088, 8, 1, 256, 1054, None, False),
    ("G=1", 2, 512, 4, 4, 128, 400, None, False),
    ("G=2", 2, 512, 4, 2, 64, 300, None, False),
    ("mostly empty", 2, 1024, 8, 1, 256, 5, None, False),
    ("capacity 1000 does not tile", 1, 1000, 4, 2, 64, 999, None, False),
    ("rolling window", 2, 512, 4, 2, 64, 1500, 200, True),
    ("window, no wrap", 2, 768, 4, 1, 128, 400, 128, False),
    ("one block a group", 33, 256, 8, 4, 64, 200, None, False),
    ("no valid slot in row 0", 2, 1088, 8, 1, 256, (-1, 1054), None, False),
)
# (block_kv, splits), each run with both combines
DECODE_CONFIGS = ((128, 8), (256, 4), (512, 2), (1024, 1), (512, 1), (128, 1))
GEMMA_DECODE = (4, 1088, 8, 1, 256)
# the serving run: batch, prompt, decode steps; logits held for PARITY_STEPS
SERVE_B, SERVE_PROMPT, SERVE_STEPS, PARITY_STEPS = 4, 1024, 64, 8
# eager against graph decode, in turns: this many pairs of SERVE_STEPS steps
TIMING_PAIRS = 4
# phase 10, the online loop: decode steps (a cache of 1,152, a decode cell
# phase 7 never tuned), steps before the daemon runs, steps after the swap
# back (held against the plain path), the daemon's budget and init
ONLINE_STEPS, ONLINE_FIRST, ONLINE_LAST = 128, 8, 8
DAEMON_BUDGET, DAEMON_INIT = 12, 4
ONLINE_SHAPE = "decode_32k"          # the sharding cell (the reference's)
# decode steps the profile window covers (phase 9)
PROFILE_STEPS = 4
# the phase-6/9 row of decode attention as one fused launch, and of the
# flash kernel's full-attention (causal=False) instance
FUSED_DECODE = "decode (one fused launch)"
FLASH_FULL = "flash_attention full (causal=False)"
# a cache 97% full: the middle of the 64 decode steps (1,024..1,087 of 1,088)
DECODE_FILL = 0.97
# about 1 config in 6 of the 4096³ space passes the resource model, and the
# paper's init repairs invalid draws until ``init`` are valid, so the budget
# leaves room for both the repairs and the BO iterations
GEMM_BUDGET = 40
# phase 11: the paper's comparison (Fig. 1's seven strategies, Fig. 5's two
# framework analogues, and BO on the padded GP) on the GTX Titan X GEMM
# space at the paper's budget; pool BO over a 1e9 generative space; the
# wide MoE sharding space
PAPER_GPU, PAPER_BUDGET = "gtx_titan_x", 220
PAPER_RUNS = ("advanced_multi", "multi", "ei", "genetic_algorithm", "mls",
              "simulated_annealing", "random", "bayesopt_ucb",
              "skopt_gphedge", "ei engine=jax")
GEN_BUDGET = 60
WIDE_ARCH = "qwen3-moe-30b-a3b"


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` single-launch CUDA-event timings of ``fn``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def gp_state(t: int, N: int, d: int, nu: str, seed: int = 5,
             distinct: bool = False):
    """A real IncrementalGP state: t observations drawn from an N-candidate
    panel of dimension d (distinct candidates when ``distinct``, with
    repeats otherwise), and the panel (fp32)."""
    import numpy as np
    from repro_torch.core.gp_fast import IncrementalGP
    rng = np.random.default_rng(seed)
    Xc = rng.random((N, d)).astype(np.float32)
    g = IncrementalGP(Xc, max_obs=t, kernel=nu, ell=2.0)
    pick = rng.permutation(N)[:t] if distinct else None
    for s in range(t):
        i = pick[s] if distinct else rng.integers(N)
        g.add(Xc[i], float(rng.normal(10, 3)))
    return g, Xc


def gp_problem(t: int, N: int, d: int, nu: str, T=None,
               distinct: bool = False):
    """Padded kernel inputs (numpy) of ``gp_state``'s GP."""
    from repro_torch.kernels import ops
    g, Xc = gp_state(t, N, d, nu, distinct=distinct)
    return (Xc,) + ops.gp_inputs_from_incremental(g, pad_T=T)[:4]


# -- phase 2 -------------------------------------------------------------------


def check_gemm(dev) -> dict:
    """Every GEMM block the resource model passes against the plain
    version, in fp32 (rtol 1e-4, atol 1e-3) and bf16 (3e-2); at 4096³ fp32
    both against an fp64 product on the card too: the kernel's max|err|
    may be at most 4x the plain version's (3xTF32 keeps fp32 accuracy)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build, gemm as kg, ops, ref
    worst = {}
    for (M, N, K) in GEMM_SHAPES:
        rng = np.random.default_rng(0)
        a64 = torch.from_numpy(rng.normal(size=(M, K)))
        b64 = torch.from_numpy(rng.normal(size=(K, N)))
        for dtype, tol in ((torch.float32, (1e-4, 1e-3)),
                           (torch.bfloat16, (3e-2, 3e-2))):
            a, b = a64.to(dev, dtype), b64.to(dev, dtype)
            want = ref.gemm(a, b).float()
            exact = plain_err = None
            if (M, N, K) == MAIN_GEMM and dtype == torch.float32:
                # fp64 product of the fp32 inputs, used only to check
                exact = torch.matmul(a.double(), b.double())
                plain_err = float((want.double() - exact).abs().max())
            dtype_bytes = a.element_size()
            for bm, bn, bk in GEMM_BLOCKS:
                cfg = {"block_m": bm, "block_n": bn, "block_k": bk}
                if M % bm or N % bn or K % bk:
                    continue
                if not ops.gemm_valid(cfg, dtype_bytes):
                    # the model's static invalid: the card refuses it too
                    try:
                        kg.gemm(a, b, block_m=bm, block_n=bn, block_k=bk)
                    except _build.LaunchRefused as e:
                        log(f"  gemm {M}x{N}x{K} {str(dtype)[6:]:8s} blocks "
                            f"({bm},{bn},{bk}): refused as the model says "
                            f"({_build.error_string(e.code)})")
                        continue
                    fail(f"gemm {M}x{N}x{K} {dtype} ({bm},{bn},{bk}) ran, "
                         "but the resource model calls it invalid")
                got = kg.gemm(a, b, block_m=bm, block_n=bn,
                              block_k=bk).float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                rtol, atol = tol
                bad = int((err > atol + rtol * want.abs()).sum())
                mx = float(err.max())
                stages = kg.gemm_stages(bm, bn, bk, dtype_bytes)
                log(f"  gemm {M}x{N}x{K} {str(dtype)[6:]:8s} blocks "
                    f"({bm},{bn},{bk}), {stages} stages: max|err| {mx:.3e} "
                    f"(rtol {rtol}, atol {atol}) -> "
                    f"{'ok' if bad == 0 else f'{bad} BAD'}")
                if bad:
                    fail(f"gemm {M}x{N}x{K} {dtype} ({bm},{bn},{bk}) "
                         f"disagrees with its plain version in {bad} entries")
                if exact is not None:
                    k_err = float((got.double() - exact).abs().max())
                    log(f"    against fp64: kernel max|err| {k_err:.3e}, "
                        f"plain {plain_err:.3e} ({k_err / plain_err:.2f}x; "
                        "limit 4x)")
                    if k_err > 4 * plain_err:
                        fail(f"gemm {M}x{N}x{K} fp32 ({bm},{bn},{bk}) is "
                             f"{k_err / plain_err:.2f}x the plain version's "
                             "error against fp64, over 4x")
                    worst["gemm"] = max(worst.get("gemm", 0.0), mx)
            del exact
    return worst


def check_gp(dev) -> dict:
    """Every GP shape against its plain version: var within 1e-4 +
    3e-3|var|, mean within 3% of its range. Both means against the plain
    version run in float64 on the same inputs too (printed; the kernel's
    must be within 3% of the range there as well): where observations
    repeat, L^-1 grows large and the fp32 versions lose digits, and this
    shows which lost more."""
    import torch
    from repro_torch.kernels import matern_gp as kgp, ref
    worst = {}
    for (t, N, d) in GP_SHAPES:
        T = MAIN_T if (t, N, d) == MAIN_GP else None
        for nu in ("matern12", "matern32", "matern52", "rbf"):
            Xc, x_obs, vinv, w, mask = gp_problem(
                t, N, d, nu, T, distinct=(t, N, d) == GP_T1024)
            args = [torch.from_numpy(x).to(dev)
                    for x in (Xc, x_obs, vinv, w, mask)]
            mean_k, var_k = kgp.gp_posterior(*args, ell=2.0, nu=nu,
                                              block_n=256)
            mean_r, var_r = ref.gp_posterior(*args[:4], 2.0, nu,
                                             mask=args[4])
            # used only to check
            mean_x, _ = ref.gp_posterior(*(a.double() for a in args[:4]),
                                         2.0, nu, mask=args[4].double())
            torch.cuda.synchronize()
            # variance is well conditioned: tight; the mean is amplified by
            # ||L^-1||*||w||, so it is bounded by a share of its range
            var_bad = int(((var_k - var_r).abs()
                           > 1e-4 + 3e-3 * var_r.abs()).sum())
            m_err = float((mean_k - mean_r).abs().max())
            m_rng = float(mean_r.max() - mean_r.min()) + 1e-9
            v_err = float((var_k - var_r).abs().max())
            ok = var_bad == 0 and m_err < 0.03 * m_rng
            log(f"  gp t={t} N={N} d={d} T={x_obs.shape[0]} {nu}: "
                f"max|dvar| {v_err:.3e}, max|dmean| {m_err:.3e} "
                f"({m_err / m_rng:.2e} of range) -> {'ok' if ok else 'BAD'}")
            x_rng = float(mean_x.max() - mean_x.min()) + 1e-9
            k_x = float((mean_k.double() - mean_x).abs().max()) / x_rng
            p_x = float((mean_r.double() - mean_x).abs().max()) / x_rng
            log(f"    mean against float64: kernel {k_x:.2e}, plain "
                f"{p_x:.2e} of range")
            if not ok:
                i = int(torch.argmax((var_k - var_r).abs()))
                log(f"    worst var at {i}: kernel {float(var_k[i]):.6e}, "
                    f"plain {float(var_r[i]):.6e}")
                fail(f"gp_posterior t={t} N={N} d={d} {nu} disagrees with "
                     "its plain version")
            if k_x >= 0.03:
                fail(f"gp_posterior t={t} N={N} d={d} {nu}: mean "
                     f"{k_x:.2e} of its range from the float64 answer")
            if (t, N, d) == MAIN_GP:
                worst["matern_gp"] = max(worst.get("matern_gp", 0.0), m_err,
                                         v_err)
    return worst


def _agree(got, want, dtype, what: str) -> float:
    """Max |err| of ``got`` against the plain ``want`` (both fp32 views),
    failing past the stated tolerance: fp32 at the reference's 2e-4 (rtol
    and atol; the kernels sum in another order than the plain versions).
    bf16 at 2^-7 x max|ref|, the least bound that holds one bf16 ulp of
    every output (an output x has an ulp of at most 2^-7 |x|): each version
    rounds its output to bf16 once, from fp32 sums taken in another order,
    so an output next to a rounding boundary lands one ulp apart. The
    reference's 5e-3 x max|ref| (test_kernels.py:386-387) is below one ulp
    of max|ref| when max|ref| lies in [2^e, 1.5625 x 2^e); a kernel off by
    more than one ulp of the largest output fails."""
    import torch
    err = (got - want).abs()
    mx = float(err.max())
    if dtype == torch.float32:
        bad = int((err > 2e-4 + 2e-4 * want.abs()).sum())
        tol = "2e-4 + 2e-4|ref|"
    else:
        lim = 2.0 ** -7 * float(want.abs().max())
        bad = int((err > lim).sum())
        tol = f"2^-7 max|ref| = {lim:.2e}"
    log(f"  {what}: max|err| {mx:.3e} ({tol}) -> "
        f"{'ok' if bad == 0 else f'{bad} BAD'}")
    if bad:
        fail(f"{what} disagrees with its plain version in {bad} entries")
    return mx


def _agree_full_bf16(got, want, q, k, v, what: str) -> float:
    """Full attention in bf16. The plain version rounds the scores q.k to
    bf16 before the softmax, as the reference's ``ref.attention`` does; the
    kernel keeps them in fp32, as the Pallas kernel does. Every row of a
    full attention averages all S keys, so max|ref| is small and that
    rounding (a score of |q.k| ~ 45 is off by up to 1/8 before the 1/16
    scale) exceeds one output ulp. So the kernel is held to the plain
    version at the reference's bf16 tolerance (3e-2 + 3e-2|ref|,
    tests/test_kernels.py:55), and to the plain version computed in fp32 on
    the same bf16 inputs, rounded to bf16, at 2^-7 x max|ref|, as causal
    bf16 is held."""
    import torch
    from repro_torch.kernels import ref
    bad = int(((got - want).abs() > 3e-2 + 3e-2 * want.abs()).sum())
    log(f"  {what}: against the bf16 plain version max|err| "
        f"{float((got - want).abs().max()):.3e} (3e-2 + 3e-2|ref|) -> "
        f"{'ok' if bad == 0 else f'{bad} BAD'}")
    if bad:
        fail(f"{what} disagrees with its plain version in {bad} entries")
    want32 = ref.attention(q.float(), k.float(), v.float(), causal=False)
    return _agree(got, want32.to(torch.bfloat16).float(), torch.bfloat16,
                  f"{what}, against the plain version in fp32")


def check_flash(dev) -> dict:
    """Every shape and block the resource model passes, causal and full
    (``causal=False``), fp32 and bf16, against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as kfa, ops, ref
    worst = {}
    for (B, S, H, KV, hd) in FLASH_SHAPES:
        rng = np.random.default_rng(0)
        q64 = torch.from_numpy(rng.normal(size=(B, S, H, hd)))
        k64, v64 = (torch.from_numpy(rng.normal(size=(B, S, KV, hd)))
                    for _ in range(2))
        for dtype, causal in ((torch.float32, True), (torch.bfloat16, True),
                              (torch.float32, False),
                              (torch.bfloat16, False)):
            q, k, v = (t.to(dev, dtype) for t in (q64, k64, v64))
            want = ref.attention(q, k, v, causal=causal).float()
            for bq, bkv in FLASH_BLOCKS:
                cfg = {"block_q": bq, "block_kv": bkv}
                if S % bq or S % bkv or not ops.flash_valid(cfg, hd, dtype):
                    continue
                got = kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv,
                                          causal=causal).float()
                torch.cuda.synchronize()
                label = (f"flash B{B} S{S} H{H} KV{KV} hd{hd} "
                         f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
                         f" blocks ({bq},{bkv})")
                if causal or dtype == torch.float32:
                    err = _agree(got, want, dtype, label)
                else:
                    err = _agree_full_bf16(got, want, q, k, v, label)
                if (B, S, H, KV, hd) == GEMMA_FLASH and dtype == torch.bfloat16:
                    key = "flash_attention" if causal else "flash_full"
                    worst[key] = max(worst.get(key, 0.0), err)
    return worst


def _cache_positions(S: int, cur: int, rolling: bool):
    """Slot positions of a live cache: contiguous fill to ``cur``, or a
    rolling window's wrapped layout (tests/test_kernels.py's cases)."""
    import numpy as np
    if rolling:
        pos = cur - ((cur - np.arange(S)) % S)
        return np.where(pos >= 0, pos, -1)
    return np.where(np.arange(S) <= cur, np.arange(S), -1)


def _agree_partials(got, want, what: str) -> None:
    """The split kernel's per-split partials against the plain version's:
    the same splits with no valid slot (m = -inf) and, there, exactly
    l = 0 and o = 0 (splits of padding only among them); m within 1e-4
    and l within 1e-3 relative elsewhere (fp32 sums in another order; the
    kernel folds its chunks with the combine's weights)."""
    import torch
    (ko, km, kl), (o_r, m_r, l_r) = got, want
    empty = torch.isinf(m_r)
    n_empty = int(empty.sum())
    ok = (torch.equal(torch.isinf(km), empty)
          and bool((km[empty] == -math.inf).all())
          and bool((kl[empty] == 0).all()) and bool((ko[empty] == 0).all()))
    full = ~empty
    m_err = l_rel = top = 0.0
    if n_empty < m_r.numel():
        m_err = float((km[full] - m_r[full]).abs().max())
        l_rel = float(((kl[full] - l_r[full]).abs() / l_r[full]).max())
        top = float(m_r[full].abs().max())
    ok = ok and m_err <= 1e-4 * (1 + top) and l_rel <= 1e-3
    splits_empty = int(empty.all(dim=-1).sum())
    log(f"    partials: {splits_empty} empty (split, head) of "
        f"{m_r.shape[0] * m_r.shape[1] * m_r.shape[2]} exactly -inf/0/0; "
        f"max|dm| {m_err:.2e}, max rel dl {l_rel:.2e} -> "
        f"{'ok' if ok else 'BAD'}")
    if not ok:
        fail(f"{what}: split partials disagree with the plain version's")


def check_decode(dev) -> dict:
    """Every case and config with the combine fused in (one launch) and
    with the partials mode + the tensor-op combine, against the plain
    split + combine; rows with no valid slot exactly 0. max_abs_err at the
    serving shape in bf16: the split's from the partials path, the
    combine's from the fused launch."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_decode as kfd, ops, ref
    worst = {"flash_decode_split": 0.0, "flash_decode_combine": 0.0}
    for name, B, S, H, KV, hd, cur, window, rolling in DECODE_CASES:
        curs = cur if isinstance(cur, tuple) else (cur,) * B
        empty = [b for b, c in enumerate(curs) if c < 0]
        rng = np.random.default_rng(1)
        q64 = torch.from_numpy(rng.normal(size=(B, 1, H, hd)))
        k64, v64 = (torch.from_numpy(rng.normal(size=(B, S, KV, hd)))
                    for _ in range(2))
        pos = np.stack([_cache_positions(S, c, rolling) for c in curs])
        cp = torch.from_numpy(pos).to(dev)
        cu = torch.tensor(curs, dtype=torch.long, device=dev)
        serving = (B, S, H, KV, hd) == GEMMA_DECODE and curs == (1054,) * B
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dev, dtype) for t in (q64, k64, v64))
            for bkv, ns in DECODE_CONFIGS:
                if (bkv * (ns - 1) >= S
                        or not ops.decode_valid({"block_kv": bkv}, H // KV,
                                                hd)):
                    continue
                bias = ops.decode_bias(cp, cu, window, ns * bkv)
                o_r, m_r, l_r = ref.decode_split(q[:, 0], k, v, bias, ns)
                want = ref.combine_partials(o_r, m_r, l_r).reshape(
                    B, 1, H, hd).to(dtype).float()
                label = (f"decode {name} B{B} S{S} H{H} KV{KV} hd{hd} "
                         f"{str(dtype)[6:]} ({bkv},{ns})")
                err = {}
                for comb in ("kernel", "torch"):
                    kfd.split_launches = kfd.combine_launches = 0
                    got = ops.decode_attention(q, k, v, cp, cu, window=window,
                                               block_kv=bkv, num_splits=ns,
                                               combine=comb).float()
                    torch.cuda.synchronize()
                    n = (kfd.split_launches, kfd.combine_launches)
                    if n != (1, int(comb == "kernel")):
                        fail(f"{label} combine={comb}: launches (split, "
                             f"fused combine) {n}")
                    err[comb] = _agree(got, want, dtype, f"{label} {comb}")
                    if empty and not bool((got[empty] == 0).all()):
                        fail(f"{label} combine={comb}: rows {empty} have no "
                             "valid slot and are not exactly 0")
                _agree_partials(kfd.decode_split(q[:, 0], k, v, bias,
                                                 block_kv=bkv, num_splits=ns),
                                (o_r, m_r, l_r), label)
                if serving and dtype == torch.bfloat16:
                    worst["flash_decode_split"] = max(
                        worst["flash_decode_split"], err["torch"])
                    worst["flash_decode_combine"] = max(
                        worst["flash_decode_combine"], err["kernel"])
    return worst


# -- phases 3-6 ------------------------------------------------------------------


def gp_bounds(N: int, T: int, d: int, card: str):
    """Bounds of the GP kernel's work, N*(3*T*d + T^2) flop over the bytes
    read and written once: all on the CUDA cores, and on the path the
    kernel takes (the triangular product as 3xTF32 on the tensor cores,
    plus the distances on the CUDA cores). Each (ms, bound_by)."""
    from repro_torch.launch.roofline import bound_ms
    nbytes = 4.0 * (N * d + T * d + T * T + 2 * T + 2 * N)
    cores = bound_ms(N * (3.0 * T * d + T * T), nbytes, card)
    ops_ms = (bound_ms(float(N) * T * T, 0, card, "tf32x3")[0]
              + bound_ms(3.0 * N * T * d, 0, card)[0])
    bytes_ms = bound_ms(0, nbytes, card)[0]
    return cores, (max(ops_ms, bytes_ms),
                   "operations" if ops_ms >= bytes_ms else "bytes")


def evals_to_best(result) -> int:
    """Unique evaluations until the run's best value was first reached."""
    return int(next(i for i, v in enumerate(result.trace)
                    if v == result.best_value)) + 1


def invalid_split(result, cell):
    """(static, runtime) invalid counts of a kernel-tuning run's journal; a
    config outside the space counts as static."""
    static = runtime = 0
    for o in result.journal:
        if not math.isfinite(o.value):
            if o.idx is not None and cell.valid(cell.space.config(o.idx)):
                runtime += 1
            else:
                static += 1
    return static, runtime


def tune_serve_kernels(sdir: str, gp_block_n: int) -> None:
    """Phase 7: BO tunes the decode cell, then the flash cell, at gemma-2b's
    serving shapes in bf16, the surrogate on the GP kernel."""
    import torch
    from repro_torch.kernels import tuning
    B, S, H, KV, hd = GEMMA_DECODE
    fB, fS, fH, fKV, fhd = GEMMA_FLASH
    cells = (
        (tuning.decode_cell(B, S, H, KV, hd, fill=DECODE_FILL,
                            dtype=torch.bfloat16), 12, 4, 5),
        (tuning.flash_cell(fB, fS, fH, fhd, KV=fKV, dtype=torch.bfloat16),
         8, 3, 3))
    for cell, budget, init, reps in cells:
        t0 = time.perf_counter()
        res = tuning.run_kernel_tuning(cell, sdir, budget=budget, init=init,
                                       reps=reps, gp_backend="cuda",
                                       gp_block_n=gp_block_n)
        n_static, n_runtime = invalid_split(res, cell)
        if not math.isfinite(res.best_value):
            fail(f"{cell.objective_id()}: no valid config in {budget}")
        log(f"[7] {cell.objective_id()}: best "
            f"{cell.space.config(res.best_idx)} {res.best_value * 1e3:.4f} "
            f"ms after {evals_to_best(res)} of {res.unique_evals} evals; "
            f"invalid {n_static} static, {n_runtime} runtime "
            f"({time.perf_counter() - t0:.1f} s)")


def profile_window(fn, what: str, top: int = 8):
    """Run ``fn`` under torch.profiler and print the device's busy share of
    the window (kernel time over wall time) and the kernels that took the
    most device time. Prints "not measured" when the profiler sees no
    device time. Returns the (ms, count, name) rows, or None without
    them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except RuntimeError as e:             # no CUPTI on this host
        log(f"[9] profile of {what}: profiler unavailable ({e}); device "
            "busy share not measured")
        fn()
        return None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        prof.__exit__(None, None, None)
    rows = [(a.self_device_time_total / 1e3, a.count, a.key)
            for a in prof.key_averages()
            if a.device_type != DeviceType.CPU and a.self_device_time_total > 0]
    graphs = sum(a.count for a in prof.key_averages()
                 if a.device_type == DeviceType.CPU
                 and "GraphLaunch" in a.key)
    if graphs:
        log(f"[9] profile of {what}: {graphs} CUDA graph launches on the "
            "host; the device events below include the graphs' kernels")
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log(f"[9] profile of {what}: wall {wall_ms:.3f} ms; the profiler saw "
            "no device time (device busy share not measured)")
        return None
    rows.sort(reverse=True)
    log(f"[9] profile of {what} (torch.profiler on): wall {wall_ms:.3f} ms, "
        f"device kernel time {busy:.3f} ms, busy {100 * busy / wall_ms:.1f}%"
        f", idle {100 * (1 - busy / wall_ms):.1f}%; "
        f"{sum(r[1] for r in rows)} device events")
    for ms, n, name in rows[:top]:
        log(f"[9]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<5d} {name[:90]}")
    return rows


def serve_gemma(sdir: str, dev) -> dict:
    """Phase 8: DecodeServer serves gemma-2b at full width with blocks from
    the store; parity against the plain attention path on the card."""
    import statistics as st
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.params import leaves
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import ParallelConfig
    cfg = get_arch("gemma-2b")
    cap = SERVE_PROMPT + SERVE_STEPS
    kc = serve.serving_kernel_config(cfg, device=dev, prompt_len=SERVE_PROMPT,
                                     cache_cap=cap, store=sdir, log=log)
    if not (kc.use_flash and kc.use_decode):
        fail(f"serving config {kc} leaves a kernel off")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    server = serve.DecodeServer(
        cfg, ParallelConfig(kernel=kc),
        batch=SERVE_B, prompt_len=SERVE_PROMPT, decode_steps=SERVE_STEPS,
        seed=0, device=dev, keep_logits=PARITY_STEPS)
    torch.cuda.synchronize(dev)
    n_params = sum(t.numel() for _, t in leaves(server.params))
    init_s = time.perf_counter() - t0
    batch = server.input_batch()
    serve.reset_kernel_launches()
    # the first prefill also pays one-time costs (cuBLAS workspaces and
    # heuristics for new shapes); the second, on a fresh cache, is the
    # steady one and leaves the cache the decode steps run on
    cold_s = server.prefill_batch(batch)
    prefill_s = server.prefill_batch(batch)
    steps = [server.decode_step() for _ in range(SERVE_STEPS)]
    launches = serve.kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    med = st.median(steps)
    log(f"[8] {cfg.name}: {n_params:,} parameters (bf16) initialised in "
        f"{init_s:.3f} s; blocks {kc}")
    log(f"[8] prefill {SERVE_B} x {SERVE_PROMPT}: {prefill_s * 1e3:.3f} ms "
        f"(first call {cold_s * 1e3:.3f} ms; {server.prefill_dispatch}); "
        f"decode {SERVE_STEPS} steps: median "
        f"{med * 1e3:.4f} ms/step (min {min(steps) * 1e3:.4f}, max "
        f"{max(steps) * 1e3:.4f}), {SERVE_B / med:.1f} tokens/s "
        f"({server.decode_dispatch}); peak memory "
        f"{peak / 2 ** 30:.3f} GiB; launches {launches}")
    # one decode launch a layer and step, carrying the combine where the
    # config says "kernel"; none else (phase 9 reads the device trace). The
    # steps replay the captured graph, which counts the launches it holds;
    # each capture ran one warm-up step first
    fused = kc.decode_combine == "kernel"
    n_dec = cfg.num_layers * (SERVE_STEPS + server.captures)
    want = {"flash_attention": 2 * cfg.num_layers,
            "flash_decode_split": n_dec,
            "flash_decode_combine": n_dec * fused}
    log(f"[8] decode graphs: {server.captures} captured in "
        f"{[round(t, 4) for t in server.capture_s]} s (warm-up step "
        f"included); cache {server.kernel_cache.stats()}; {SERVE_STEPS} "
        f"steps replayed, {cfg.num_layers} decode launches each")
    if server.captures != 1:
        fail(f"{server.captures} decode graphs captured for one config")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times in two prefills "
                 f"and {SERVE_STEPS} decode steps, want {n}")
    toks = torch.stack(server.out, 1)
    if toks.shape != (SERVE_B, SERVE_STEPS + 1) or not all(
            bool(torch.isfinite(x).all()) for x in server.kept):
        fail("served tokens or logits malformed")

    # the plain attention path on the same weights and tokens
    plain_pcfg = ParallelConfig(kernel=None)
    prefill = make_prefill_step(cfg, plain_pcfg, cache_cap=cap)
    decode = make_decode_step(cfg, plain_pcfg)
    logits, cache = prefill(server.params, batch)
    plain = [logits.float().cpu()]
    for i in range(PARITY_STEPS):
        logits, cache = decode(server.params, cache,
                               {"tokens": server.out[i][:, None]},
                               SERVE_PROMPT + i)
        plain.append(logits.float().cpu())
    del cache

    def parity(kept, what):
        worst = 0.0
        for i, (a, b) in enumerate(zip(kept, plain)):
            err, top = float((a - b).abs().max()), float(b.abs().max())
            worst = max(worst, err / top)
            if err > 2e-2 * top:
                fail(f"{what} logits step {i}: max|err| {err:.4e} over "
                     f"2e-2 x max|logits| = {2e-2 * top:.4e}")
        log(f"[8] {what} vs plain attention path, prefill + {PARITY_STEPS} "
            f"teacher-forced decode steps: max|err| / max|logits| = "
            f"{worst:.3e} (limit 2e-2); greedy tokens equal at "
            f"{sum(int(torch.equal(a.argmax(-1), b.argmax(-1))) for a, b in zip(kept, plain))}"
            f" of {len(plain)} steps")
        return worst

    rel = parity(server.kept, "served")
    graph_vs_eager(server, batch, dev)
    timing = eager_vs_graph_ms(server, batch, dev)
    combine = launches["flash_decode_combine"]
    if not fused:
        # the fused combine on the same path: an extra decode run at the
        # serving shape, teacher-forced on the served tokens
        extra = serve.DecodeServer(
            cfg, ParallelConfig(kernel=kc.replace(decode_combine="kernel")),
            batch=SERVE_B, prompt_len=SERVE_PROMPT, decode_steps=SERVE_STEPS,
            device=dev, params=server.params, keep_logits=PARITY_STEPS)
        serve.reset_kernel_launches()
        extra.prefill_batch(batch)
        for i in range(PARITY_STEPS):
            extra.toks = server.out[i]
            extra.decode_step()
        n = serve.kernel_launches()
        combine = n["flash_decode_combine"]
        log(f"[8] extra run with decode_combine='kernel': {combine} fused "
            f"launches of {n['flash_decode_split']} decode launches")
        if n["flash_decode_split"] != combine:
            fail(f"extra run: decode launches {n}, want each fused")
        rel = max(rel, parity(extra.kept, "fused-combine run"))
    if combine < cfg.num_layers:
        fail(f"fused combine launched {combine} times")
    launches["flash_decode_combine"] = combine
    return {"kc": kc, "launches": launches, "prefill_ms": prefill_s * 1e3,
            "prefill_cold_ms": cold_s * 1e3,
            "step_ms": med * 1e3, "tokens_s": SERVE_B / med, "peak": peak,
            "parity": rel, "server": server, "batch": batch,
            "timing": timing}


def eager_step(server, pos, dev) -> float:
    """One decode step of ``server`` through its eager step function (no
    graph), as ``DecodeServer.decode_step`` does on the CPU; seconds."""
    import torch
    t0 = time.perf_counter()
    with torch.inference_mode():
        pos.fill_(server.pos)
        logits, _ = server.decode(server.params, server.cache,
                                  {"tokens": server.toks[:, None]}, pos)
        server.toks = torch.argmax(logits, -1)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    server.out.append(server.toks)
    server.pos += 1
    return dt


def graph_vs_eager(server, batch, dev) -> None:
    """The graph step's logits against the eager step function's on the
    same state, over PARITY_STEPS steps of a new sequence: before each
    replay the eager step runs on the held state (it writes the cache slot
    the replay then rewrites with the same values). Prints whether they are
    equal bit for bit; fails past the serve limit, 2e-2 x max|logits|."""
    import torch
    server.prefill_batch(batch)
    saved = server.keep_logits
    server.keep_logits = PARITY_STEPS
    same, worst = 0, 0.0
    for _ in range(PARITY_STEPS):
        with torch.inference_mode():
            eager, _ = server.decode(server.params, server.cache,
                                     {"tokens": server.toks[:, None]},
                                     server.pos)
            eager = eager.float().cpu()
        server.decode_step()
        got = server.kept[-1]
        same += int(torch.equal(got, eager))
        top = float(eager.abs().max())
        worst = max(worst, float((got - eager).abs().max()) / top)
    server.keep_logits = saved
    log(f"[8] graph replay vs eager step on the same state, {PARITY_STEPS} "
        f"steps: bit for bit equal at {same} of {PARITY_STEPS}; max|err| / "
        f"max|logits| = {worst:.3e} (limit 2e-2)")
    if worst > 2e-2:
        fail(f"graph step logits {worst:.3e} x max|logits| from the eager "
             "step's")


def eager_vs_graph_ms(server, batch, dev) -> dict:
    """Median ms/step of SERVE_STEPS decode steps, eager step function
    against graph replay, in TIMING_PAIRS pairs in turns (E G, G E, ...),
    each run on a fresh prefill of the same prompt, no logits kept."""
    import torch
    pos = torch.zeros((), dtype=torch.long, device=dev)
    saved = server.keep_logits
    server.keep_logits = 0
    runs = {"eager": [], "graph": []}
    for i in range(TIMING_PAIRS):
        for mode in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            server.prefill_batch(batch)
            step = ((lambda: eager_step(server, pos, dev)) if mode == "eager"
                    else server.decode_step)
            runs[mode].append(1e3 * statistics.median(
                [step() for _ in range(SERVE_STEPS)]))
    server.keep_logits = saved
    log(f"[8] decode ms/step (median of {SERVE_STEPS}), eager step against "
        f"graph replay in turns (E G G E ...), {smi_line()}: eager "
        f"{[round(x, 4) for x in runs['eager']]}, graph "
        f"{[round(x, 4) for x in runs['graph']]}")
    return runs


def online_gemma(sdir: str, dev, params, gp_block_n: int) -> dict:
    """Phase 10: the online loop on a copy of the phase-7 store, wired as
    ``serve.main --online --kernels`` wires it: a stale decode cell, one
    durable job, the retune daemon's BO on the card, the hot-swap (or the
    source's reason to keep its config), a forced swap back that must be a
    graph-cache hit, prod records, and parity against the plain path."""
    import shutil
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import matern_gp as kgp
    from repro_torch.launch import serve
    from repro_torch.launch.retune import RetuneDaemon
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.store import HotConfigSource, TuningRecordStore
    cfg = get_arch("gemma-2b")
    cap = SERVE_PROMPT + ONLINE_STEPS
    odir = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_online_"), "st")
    shutil.copytree(sdir, odir)
    source = HotConfigSource(odir, cfg.name, ONLINE_SHAPE)
    if source.refresh() is not None:
        fail("the sharding cell has a record in a store of kernel cells")
    kc = serve.serving_kernel_config(cfg, device=dev, prompt_len=SERVE_PROMPT,
                                     cache_cap=cap, store=odir, log=log)
    ksrc = serve.kernel_sources(odir, cfg, batch=SERVE_B,
                                prompt_len=SERVE_PROMPT, cache_cap=cap,
                                device=dev, log=log)
    fsrc, dsrc = ksrc
    log(f"[10] sources: {fsrc.objective_id} stale={fsrc.stale}; "
        f"{dsrc.objective_id} stale={dsrc.stale}")
    if fsrc.stale or not dsrc.stale:
        fail("want the flash cell tuned (phase 7) and the decode cell at "
             f"capacity {cap} stale")
    first = {"block_kv": kc.decode_block_kv,
             "num_splits": kc.decode_num_splits,
             "combine": kc.decode_combine}
    server = serve.DecodeServer(
        cfg, ParallelConfig(kernel=kc), batch=SERVE_B,
        prompt_len=SERVE_PROMPT, decode_steps=ONLINE_STEPS, device=dev,
        params=params)
    batch = server.input_batch()
    prefill_s = server.prefill_batch(batch)
    loop, recorder, queue = serve.make_online_loop(
        server, odir, arch=cfg.name, tuned_shape=ONLINE_SHAPE, source=source,
        kernel_sources=ksrc, prefill_s=prefill_s)
    serve.reset_kernel_launches()
    t0 = time.perf_counter()
    stats = [loop.run(ONLINE_FIRST)]
    tickets = queue.open_tickets()
    log(f"[10] {ONLINE_FIRST} steps served on blocks {first} (resolved "
        f"from the capacity-1,088 record); open jobs: "
        f"{[(tk.key, tk.reason) for tk in tickets]}")
    if [(tk.key, tk.reason) for tk in tickets] != [(dsrc.objective_id,
                                                     "stale")]:
        fail("want exactly one open stale job, for the decode cell")

    # the daemon, in process, on the card: claims the job, BO retunes the
    # cell (its surrogate on the GP kernel), journals under its fence token
    daemon = RetuneDaemon(
        odir, budget=DAEMON_BUDGET, worker="chip-smoke-daemon", device=dev,
        verbose=True, strategy_factory=lambda: make_strategy(
            "ei", initial_samples=DAEMON_INIT, gp_backend="cuda",
            gp_device=str(dev), gp_block_n=gp_block_n))
    before, gp0, d0 = serve.kernel_launches(), kgp.launches, time.perf_counter()
    res = daemon.step()
    daemon_s = time.perf_counter() - d0
    mid = serve.kernel_launches()
    daemon_launches = {k: mid[k] - before[k] for k in mid}
    if res is None or daemon.serviced != 1:
        fail("the daemon serviced no job")
    view = TuningRecordStore(odir)
    fp = next(d for d, desc in view.fingerprints().items()
              if desc.objective == dsrc.objective_id)
    recs = view.records(fp=fp)
    tokens = {int((r.meta or {}).get("fence", {}).get("token", -1))
              for r in recs}
    jobs = [d for seg in sorted(os.listdir(odir)) if seg.endswith(".jsonl")
            for d in (json.loads(x) for x in open(os.path.join(odir, seg))
                      if x.strip()) if d.get("kind") == "job"]
    states = [d["state"] for d in jobs if d["key"] == dsrc.objective_id]
    log(f"[10] daemon: {res.unique_evals} evaluations in {daemon_s:.1f} s, "
        f"best {res.best_value * 1e3:.4f} ms; "
        f"{len(recs)} records journaled under fence tokens {tokens}; job "
        f"records {states}; launches in its BO run: GP kernel "
        f"{kgp.launches - gp0}, {daemon_launches}")
    # the loop re-submits at each poll while the cell is stale: duplicate
    # submits coalesce into the one job, and its done closes each of them
    if (states.count("claim") != 1 or states.count("done")
            != states.count("submit") or len(tokens) != 1 or -1 in tokens
            or queue.open_tickets() or {d["key"] for d in jobs}
            != {dsrc.objective_id}):
        fail("want one job, claimed once and done, its records under the "
             "claim's token")
    if kgp.launches == gp0:
        fail("the daemon's BO never ran the GP kernel")

    stats.append(loop.run(ONLINE_STEPS - ONLINE_FIRST - ONLINE_LAST))
    swaps = stats[-1].kernel_swaps
    log(f"[10] after the retune: kernel hot-swaps {swaps}; decode source "
        f"current {dsrc.current}, stale={dsrc.stale}")
    if dsrc.stale:
        fail("the decode cell is still stale after the daemon's run")
    if not swaps:
        log(f"[10] no hot-swap: the source kept {dsrc.current} by its tier "
            "and margin rules")
    captured = server.captures
    server.apply_kernel_config(first)           # the forced swap back
    server.kept, server.keep_logits = [], ONLINE_LAST - 1
    stats.append(loop.run(ONLINE_LAST))
    wall = time.perf_counter() - t0
    cache = server.kernel_cache.stats()
    log(f"[10] swap back to {first}: captures {captured} -> "
        f"{server.captures}; cache {cache}; capture times "
        f"{[round(x, 4) for x in server.capture_s]} s")
    if server.captures != captured or cache["hits"] < 1:
        fail("the swap back captured a new graph instead of a cache hit")
    if server.captures != cache["entries"]:
        fail(f"{server.captures} graphs captured for {cache['entries']} "
             "kernel configs served")

    total = serve.kernel_launches()
    served = {k: total[k] - daemon_launches[k] for k in total}
    n_steps = sum(st.steps for st in stats)
    n_kernel = sum(st.decode_steps_kernel for st in stats)
    warm = {0} | {step for st in stats for step, *_ in
                  st.swaps + st.kernel_swaps}
    lat = [x for st in stats for x in st.latencies]
    log(f"[10] {n_steps} steps in {wall:.1f} s (daemon included), median "
        f"{1e3 * statistics.median(lat):.4f} ms/step; {n_kernel} on the "
        f"decode kernel; prod records {recorder.count} (the prefill's and "
        f"{n_steps - len(warm)} steps, {len(warm)} warm-up); serve launches "
        f"{served}")
    if recorder.count != 1 + n_steps - len(warm):
        fail(f"{recorder.count} prod records, want 1 + {n_steps} - "
             f"{len(warm)}")
    n_dec = cfg.num_layers * ONLINE_STEPS
    fused = all(c.get("combine", "kernel") == "kernel" for c in
                [first] + [c for st in stats for _, c, _ in st.kernel_swaps])
    if not fused:
        log("[10] the tuned decode blocks merge the splits with tensor ops: "
            "steps on them launch the decode kernel in partials mode")
    if (n_kernel != n_steps or served["flash_decode_split"] < n_dec
            or (fused and served["flash_decode_split"]
                != served["flash_decode_combine"])):
        fail(f"decode launches {served}: want {n_dec} or more, each fused "
             "where the served blocks say so")

    # the last steps, after both swaps, against the plain attention path,
    # teacher-forced on the served tokens
    plain_pcfg = ParallelConfig(kernel=None)
    logits, pcache = make_prefill_step(cfg, plain_pcfg, cache_cap=cap)(
        server.params, batch)
    decode = make_decode_step(cfg, plain_pcfg)
    plain = []
    for i in range(ONLINE_STEPS):
        logits, pcache = decode(server.params, pcache,
                                {"tokens": server.out[i][:, None]},
                                SERVE_PROMPT + i)
        if i >= ONLINE_STEPS - ONLINE_LAST:
            plain.append(logits.float().cpu())
    del pcache
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(server.kept, plain))
    log(f"[10] last {ONLINE_LAST} steps vs plain attention path: max|err| / "
        f"max|logits| = {worst:.3e} (limit 2e-2)")
    if len(server.kept) != ONLINE_LAST or worst > 2e-2:
        fail(f"online logits {worst:.3e} x max|logits| from the plain path")
    shutil.rmtree(os.path.dirname(odir))
    return {"parity": worst, "launches": served, "steps": n_steps}


# -- phase 11 ------------------------------------------------------------------


def paper_comparison(dev) -> int:
    """Phase 11(a): the paper's comparison on the GTX Titan X GEMM space at
    its budget, each strategy once at seed 0, BO's surrogate on the GP
    kernel and the padded GPs on the card. Returns the GP-kernel launches."""
    import numpy as np
    import torch
    from repro_torch.core import gp as G
    from repro_torch.core.metrics import mae
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.spaces import make_objective
    from repro_torch.core.strategies import (ALL_BASELINES, ALL_FRAMEWORKS,
                                             BO_NAMES, make_strategy)
    from repro_torch.kernels import matern_gp as kgp
    from repro_torch.launch import compare
    obj = make_objective("gemm", PAPER_GPU)
    cap = PAPER_BUDGET * 50                    # the engine's total-call cap
    gp_launches = 0
    framework_gps = {}
    for label in PAPER_RUNS:
        name = label.split()[0]
        kw = ({"engine": "jax", "gp_device": str(dev)} if "jax" in label
              else compare.strategy_kwargs(name, dev))
        strat = compare.TimedStrategy(make_strategy(name, **kw))
        kgp.launches = 0
        t0 = time.perf_counter()
        res = run_strategy(strat, obj, budget=PAPER_BUDGET, seed=0)
        wall = time.perf_counter() - t0
        gp_launches += kgp.launches
        keys = [o.key for o in res.journal]
        n_inv = sum(not math.isfinite(o.value) for o in res.journal)
        log(f"[11a] {label}: MAE {mae(res.trace, obj.optimum):.4f}, best "
            f"{res.best_value:.4f} (optimum {obj.optimum:.4f}), "
            f"{res.unique_evals} unique evals of {strat.proposals} "
            f"proposals, {n_inv} invalid, {wall:.2f} s, tuner "
            f"{1e3 * strat.seconds / max(strat.proposals, 1):.3f} ms a "
            f"proposal, {kgp.launches} GP-kernel launches")
        if res.unique_evals != PAPER_BUDGET and strat.proposals < cap:
            fail(f"{label}: {res.unique_evals} of {PAPER_BUDGET} evals "
                 "before the total-call cap")
        if len(set(keys)) != len(keys):
            fail(f"{label}: a config was evaluated twice")
        bo = name in BO_NAMES
        if bo and strat.proposals > res.unique_evals + 1:
            fail(f"{label}: BO proposed an evaluated config "
                 f"({strat.proposals} proposals, {res.unique_evals} evals)")
        if bo and "jax" not in label and kgp.launches < PAPER_BUDGET - 20:
            fail(f"{label}: {kgp.launches} GP-kernel launches, want one a "
                 "BO iteration")
        if name in ALL_BASELINES:
            cpu = run_strategy(make_strategy(
                name, **compare.strategy_kwargs(name, "cpu")), obj,
                budget=PAPER_BUDGET, seed=0)
            if [o.key for o in cpu.journal] != keys:
                fail(f"{label}: trace differs from the same run on the CPU")
        if name in ALL_FRAMEWORKS:
            framework_gps[name] = strat.inner.gp
        if "jax" in label:
            framework_gps[label] = strat.inner.gp.gp

    # the padded GPs at their last state: card against CPU against float64
    # (the CPU tests' rule: the card within 8x the CPU's fp32 error plus
    # 1e-5 of the scale), and fit + predict ms on the card
    rng = np.random.default_rng(0)
    for label, g in framework_gps.items():
        cand = (obj.space.X_norm if "jax" in label else
                rng.random((2048, g.dim)).astype(np.float32))
        cpu = G.GP(g.dim, g.max_obs, g.kernel, g.ell, g.noise, device="cpu")
        cpu.X[:], cpu.y[:], cpu.mask[:], cpu.n = g.X, g.y, g.mask, g.n
        got = [t.double().cpu().numpy() for t in g.predict(cand)]
        want = [t.double().numpy() for t in cpu.predict(cand)]
        st = G.gp_fit(torch.from_numpy(g.X).double(),
                      torch.from_numpy(g.y).double(),
                      torch.from_numpy(g.mask), kernel=g.kernel, ell=g.ell,
                      noise=g.noise)
        exact = [t.numpy() for t in G.gp_predict(
            st, torch.from_numpy(cand).double(), kernel=g.kernel, ell=g.ell)]
        cand_dev = g.upload(cand)
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            g.fit()
            mu, _ = g.predict(cand_dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
        for what, a, b, e in zip(("mean", "std"), got, want, exact):
            err_c, err_p = np.abs(a - e).max(), np.abs(b - e).max()
            bound = 8 * err_p + 1e-5 * np.abs(e).max()
            log(f"[11a] {label} padded GP at {g.n} observations, {what} "
                f"over {len(cand)} candidates: card {err_c:.3e}, CPU "
                f"{err_p:.3e} from float64 (bound {bound:.3e})")
            if not (np.isfinite(a).all() and err_c <= bound):
                fail(f"{label}: the padded GP on the card disagrees with "
                     "the CPU")
        log(f"[11a] {label} padded GP fit + predict on the card: "
            f"{1e3 * statistics.median(times):.3f} ms (median of 20, "
            f"{g.max_obs} padded rows)")
    return gp_launches


def _bowl(cfg) -> float:
    import numpy as np
    vals = np.array([cfg[f"p{j}"] for j in range(6)], np.float64)
    return float(0.01 + np.sum((vals / 31.0 - 0.4) ** 2))


def generative_on_card(dev) -> int:
    """Phase 11(b): pool-mode BO, its surrogate on the GP kernel, over a
    constrained space of 1.07e9 cartesian configs, beside the numpy
    surrogate's run of the same seed; and the wide MoE sharding space.
    Returns the GP-kernel launches of the kernel-backed run."""
    import numpy as np
    from repro_torch.core.gp_fast import IncrementalGP
    from repro_torch.core.objectives import CallableObjective
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.searchspace import (GenerativeSpace, Param,
                                              SearchSpace, VectorConstraint)
    from repro_torch.core.strategies import make_strategy
    from repro_torch.core.tuning_targets import sharding_space
    from repro_torch.kernels import matern_gp as kgp
    space = SearchSpace([Param(f"p{j}", tuple(range(32))) for j in range(6)],
                        [VectorConstraint(
                            lambda c: (c["p0"] + c["p1"]) % 2 == 0)],
                        name="gen1e9")
    if not isinstance(space, GenerativeSpace):
        fail("a 1e9 cartesian space did not build as a GenerativeSpace")
    obj = CallableObjective(space, _bowl, name="gen1e9_bowl")
    runs = {}
    for backend in ("cuda", "numpy"):
        kw = ({"gp_backend": "cuda", "gp_device": str(dev)}
              if backend == "cuda" else {})
        strat = make_strategy("ei", **kw)
        kgp.launches = 0
        t0 = time.perf_counter()
        res = run_strategy(strat, obj, budget=GEN_BUDGET, seed=0)
        runs[backend] = (res, strat, kgp.launches,
                         time.perf_counter() - t0)
    res, strat, n_gp, wall = runs["cuda"]
    ref = runs["numpy"][0]
    codes = np.array([o.idx for o in res.journal], np.int64)
    keys = [o.key for o in res.journal]
    agree = next((i for i, (a, b) in enumerate(zip(keys, [
        o.key for o in ref.journal])) if a != b), len(keys))
    log(f"[11b] {space.name} (cartesian {space.cartesian_size:,}): ei, "
        f"gp_backend cuda, {res.unique_evals} evals in {wall:.2f} s, "
        f"{n_gp} GP-kernel launches, best {res.best_value:.5f}; numpy "
        f"surrogate best {ref.best_value:.5f} in {runs['numpy'][3]:.2f} s; "
        f"the first {agree} suggestions agree")
    if res.unique_evals != GEN_BUDGET or len(set(keys)) != len(keys):
        fail("generative BO did not spend its budget without revisits")
    if not space._feasible_mask(codes).all():
        fail("generative BO suggested an infeasible config")
    if agree < strat.cfg.initial_samples:
        fail(f"the initial sample differs from the numpy run at {agree}")
    if n_gp < GEN_BUDGET - strat.cfg.initial_samples:
        fail(f"{n_gp} GP-kernel launches for "
             f"{GEN_BUDGET - strat.cfg.initial_samples} BO iterations: a "
             "pool fell back to numpy")
    # the kernel-backed posterior at the final state, at pool sizes that do
    # not tile block_n, against the numpy surrogate on the same state
    # (phase 2's rule for the GP kernel: the mean within 3% of its range
    # over the largest pool, here the std too)
    gp = strat.gp.gp
    plain = IncrementalGP.from_state(gp.state())
    rng = np.random.default_rng(3)
    pools = [space.X_norm[space.sample_feasible(rng, m)]
             for m in (2049, 777, 1)]
    mu_n, sd_n = plain.predict_at(pools[0])
    scale_mu = float(mu_n.max() - mu_n.min())
    scale_sd = float(sd_n.max() - sd_n.min())
    for X in pools:
        before = kgp.launches
        mu, sd = gp.predict_at(X)
        mu_n, sd_n = plain.predict_at(X)
        e_mu = float(np.abs(mu - mu_n).max())
        e_sd = float(np.abs(sd - sd_n).max())
        log(f"[11b] pool of {len(X)}: kernel against numpy, mean "
            f"{e_mu:.3e} ({e_mu / scale_mu:.2e} of its range), std "
            f"{e_sd:.3e} ({e_sd / scale_sd:.2e}); "
            f"{kgp.launches - before} launch")
        if (kgp.launches != before + 1 or e_mu > 0.03 * scale_mu
                or e_sd > 0.03 * scale_sd):
            fail(f"pool of {len(X)}: the kernel-backed posterior disagrees "
                 "with numpy or did not launch")
    # the wide MoE sharding space the port could not build before
    t0 = time.perf_counter()
    wide = sharding_space(WIDE_ARCH, "train_4k", wide=True)
    built = time.perf_counter() - t0
    est = wide.feasible_fraction_interval()
    t0 = time.perf_counter()
    first = wide.sample_feasible(np.random.default_rng(0), 1)
    drawn = time.perf_counter() - t0
    log(f"[11b] {wide.name}: {type(wide).__name__}, cartesian "
        f"{wide.cartesian_size:,}, built in {1e3 * built:.2f} ms; feasible "
        f"fraction estimate {est['point']:.3g} ({est['method']} "
        f"[{est['lo']:.2g}, {est['hi']:.2g}]); first feasible sample in "
        f"{1e3 * drawn:.2f} ms")
    if not (isinstance(wide, GenerativeSpace)
            and wide._feasible_mask(first).all()):
        fail(f"{wide.name}: not generative or its first sample infeasible")
    return n_gp


def live_comparison(cell, sdir: str, phase4: str) -> int:
    """Phase 11(c): the baselines and the frameworks tune phase 4's cell
    with phase 4's budget, journaled into the same store. Returns the GEMM
    launches."""
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.strategies import (ALL_BASELINES, ALL_FRAMEWORKS,
                                             make_strategy)
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import tuning
    from repro_torch.launch import compare
    log(f"[11c] beside phase 4's BO: {phase4}")
    n_gemm = 0
    for name in ALL_BASELINES + ALL_FRAMEWORKS:
        obj = tuning.KernelObjective(cell, reps=3, device=cell.device)
        strat = compare.TimedStrategy(make_strategy(
            name, **compare.strategy_kwargs(name, obj.device)))
        kg.launches = 0
        t0 = time.perf_counter()
        res = run_strategy(strat, obj, budget=GEMM_BUDGET, seed=0,
                           store=sdir, warm_start=False,
                           run_id=f"{name}_{cell.kernel}_{cell.shape_sig}-s0")
        n_gemm += kg.launches
        n_static, n_runtime = invalid_split(res, cell)
        best = (f"{cell.space.config(res.best_idx)} "
                f"{res.best_value * 1e3:.4f} ms after {evals_to_best(res)} "
                "evals" if math.isfinite(res.best_value) else "none valid")
        log(f"[11c] {name}: best {best}; {res.unique_evals} evals of "
            f"{strat.proposals} proposals, invalid {n_static} static, "
            f"{n_runtime} runtime; {kg.launches} gemm launches; "
            f"{time.perf_counter() - t0:.1f} s")
        # the budget, or the engine's total-call cap (a walk that keeps
        # proposing evaluated configs, as simulated annealing does)
        if (res.unique_evals != GEMM_BUDGET
                and strat.proposals < 50 * GEMM_BUDGET):
            fail(f"{name}: {res.unique_evals} of {GEMM_BUDGET} evals")
    return n_gemm


def serve_cases(kc, dev, card: str) -> dict:
    """The serve kernels at gemma-2b's shapes with the blocks phase 8 ran:
    name -> (label, kernel fn, plain fn, library fn or None, bound ms,
    bound_by); a kernel fn that is a pair is timed as the difference of
    the two. The decode library call (SDPA with the additive bias mask and
    enable_gqa) computes split + combine together: it is timed beside the
    one fused launch as ``FUSED_DECODE`` and given to neither kernel. Both
    sides take the validity bias built beforehand, as SDPA takes its mask.
    The row ``decode as served`` times it as the serve path runs it, the
    bias built from the cache positions on every side."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.roofline import bound_ms
    bf16 = torch.bfloat16
    rng = np.random.default_rng(2)
    B, S, H, KV, hd = GEMMA_FLASH
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd))).to(dev, bf16)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(dev, bf16)
            for _ in range(2))
    bq, bkv = kc.flash_block_q, kc.flash_block_kv
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    cases = {"flash_attention": (
        f"flash B{B} S{S} H{H} KV{KV} hd{hd} bf16 ({bq},{bkv}); library "
        "SDPA(is_causal, enable_gqa)",
        lambda: kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv),
        lambda: ref.attention(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        *bound_ms(4.0 * B * H * hd * S * (S + 1) / 2,
                  2.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd), card,
                  "bfloat16"))}
    # the reference's causal=False branch at the same shape and blocks (no
    # model path runs it: it is timed here, not on the JSON line)
    cases[FLASH_FULL] = (
        f"flash full (causal=False) B{B} S{S} H{H} KV{KV} hd{hd} bf16 "
        f"({bq},{bkv}); library SDPA(is_causal=False, enable_gqa)",
        lambda: kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv,
                                    causal=False),
        lambda: ref.attention(q, k, v, causal=False),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=False,
                                               enable_gqa=True),
        *bound_ms(4.0 * B * H * hd * S * S,
                  2.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd), card,
                  "bfloat16"))

    B, S, H, KV, hd = GEMMA_DECODE
    G = H // KV
    ns, dbkv = kc.decode_num_splits, kc.decode_block_kv
    cur = int(S * DECODE_FILL) - 1
    qd = torch.from_numpy(rng.normal(size=(B, H, hd))).to(dev, bf16)
    kd, vd = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(dev, bf16)
              for _ in range(2))
    cp = torch.from_numpy(np.broadcast_to(_cache_positions(S, cur, False),
                                          (B, S)).copy()).to(dev)
    cu = torch.full((B,), cur, dtype=torch.long, device=dev)
    bias = ops.decode_bias(cp, cu, None, ns * dbkv)
    n_valid = int((bias == 0).sum())            # slots the data needs read
    part_bytes = 4.0 * B * KV * ns * G * (hd + 2)
    out_bytes = 2.0 * B * H * hd
    parts = kfd.decode_split(qd, kd, vd, bias, block_kv=dbkv, num_splits=ns)
    mask = bias[:, :S].to(bf16)[:, None, None, :]
    kv_bytes = 2.0 * 2 * n_valid * KV * hd + 2.0 * B * H * hd \
        + 4.0 * B * bias.shape[1]
    split_b = bound_ms(4.0 * hd * G * KV * n_valid, kv_bytes + part_bytes,
                       card, "bfloat16")
    fused_b = bound_ms(4.0 * hd * G * KV * n_valid, kv_bytes + out_bytes,
                       card, "bfloat16")

    def split():
        return kfd.decode_split(qd, kd, vd, bias, block_kv=dbkv,
                                num_splits=ns)

    def fused():
        return kfd.flash_decode(qd, kd, vd, bias, block_kv=dbkv,
                                num_splits=ns, combine="kernel")

    cases["flash_decode_split"] = (
        f"decode split B{B} S{S} ({n_valid} valid slots) H{H} KV{KV} hd{hd} "
        f"bf16 ({dbkv},{ns}), partials mode; library none",
        split, lambda: ref.decode_split(qd, kd, vd, bias, ns), None,
        *split_b)
    # the combine has no launch of its own: its time is the fused launch's
    # less the partials-mode launch's (a pair of functions: their difference)
    cases["flash_decode_combine"] = (
        f"decode combine, fused into the split kernel ({ns} splits) bf16: "
        "fused launch less partials-mode launch; plain: the tensor-op "
        "combine of the partials; library none",
        (fused, split),
        lambda: ref.combine_partials(*parts).reshape(B, H, hd).to(bf16),
        None, *bound_ms(2.0 * ns * B * H * hd, part_bytes + out_bytes, card))
    cases[FUSED_DECODE] = (
        "decode as a whole, one launch (split with the combine fused in, on "
        "the bias); library SDPA(the bias as its additive mask, enable_gqa)",
        fused,
        lambda: ref.combine_partials(*ref.decode_split(
            qd, kd, vd, bias, ns)).reshape(B, H, hd).to(bf16),
        lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True),
        *fused_b)
    # as a layer of the serve path runs it: the bias built from the cache
    # positions, then the fused launch; the plain and library sides build
    # their bias too
    cases["decode as served (bias + fused launch)"] = (
        "decode as served (the bias built, then the fused launch); library "
        "SDPA(the bias built as its additive mask, enable_gqa)",
        lambda: ops.decode_attention(qd[:, None], kd, vd, cp, cu,
                                     block_kv=dbkv, num_splits=ns,
                                     combine="kernel"),
        lambda: ref.combine_partials(*ref.decode_split(
            qd, kd, vd, ops.decode_bias(cp, cu, None, ns * dbkv), ns)
        ).reshape(B, H, hd).to(bf16),
        lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=ops.decode_bias(cp, cu, None, 1).to(bf16)[:, None,
                                                                 None],
            enable_gqa=True),
        *bound_ms(4.0 * hd * G * KV * n_valid,
                  2.0 * 2 * n_valid * KV * hd + 2.0 * 2 * B * H * hd
                  + 8.0 * B * S, card, "bfloat16"))
    return cases


def device_ms(fn, reps: int = 20, warmup: int = 3, kernels=None):
    """Device time of one call of ``fn``: the kernels (and copies) the
    profiler saw over ``reps`` calls, divided by ``reps``. Host launch time
    is not in it, where CUDA events around one call include it whenever
    the kernel is shorter than its launch. None where the profiler sees no
    device time. A list given as ``kernels`` receives (name, device events
    per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [a for a in prof.key_averages()
            if a.device_type != DeviceType.CPU and a.self_device_time_total > 0]
    if kernels is not None:
        kernels.extend((a.key, a.count / reps) for a in rows)
    us = sum(a.self_device_time_total for a in rows)
    return us / 1e3 / reps if us > 0 else None


def timed(timer, fn, what: str):
    """``timer(fn)``; for a pair (a, b), a's time less b's, the two timed
    in turns (a b b a, twice), each the median of its four, printed beside
    the difference. None where the timer gives none."""
    if not isinstance(fn, tuple):
        return timer(fn)
    a, b = fn
    ta, tb = [], []
    for i in range(4):
        for f in ((a, b) if i % 2 == 0 else (b, a)):
            (ta if f is a else tb).append(timer(f))
    if None in ta + tb:
        return None
    ma, mb = statistics.median(ta), statistics.median(tb)
    log(f"    {what}: {ma:.4f} ms less {mb:.4f} ms = {ma - mb:.4f} ms")
    return ma - mb


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel-vs-plain checks only")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.spaces import make_objective
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import _build, ops, ref, tuning
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import matern_gp as kgp
    from repro_torch.launch.roofline import bound_ms
    from repro_torch.store.records import TuningRecordStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device and build
    smi = smi_line()
    card = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; device_kind {tuning.device_kind(dev)}")
    lib = _build.lib()
    log(f"[1] build: {_build.build_seconds:.1f} s")
    regs, local = ctypes.c_int(), ctypes.c_int()
    attrs = [("gemm fp32 (3xTF32 mma.sync, cp.async ring)",
              lambda: lib.gemm_attrs(0, regs, local)),
             ("gemm bf16 (mma.sync, cp.async ring)",
              lambda: lib.gemm_attrs(1, regs, local)),
             ("gp (3xTF32 mma.sync, L^-1 ring)",
              lambda: lib.gp_attrs(regs, local))]
    for hd in (64, 128, 256):
        for causal, mask in ((1, "causal"), (0, "full")):
            attrs.append((f"flash hd{hd} fp32 {mask} (CUDA cores)",
                          lambda hd=hd, c=causal: lib.flash_attention_attrs(
                              0, hd, 1, c, regs, local)))
            for nwg in (1, 2):
                attrs.append((f"flash hd{hd} bf16 {mask} (wgmma, {nwg} "
                              f"warpgroup{'s' if nwg > 1 else ''})",
                              lambda hd=hd, nwg=nwg, c=causal:
                              lib.flash_attention_attrs(1, hd, nwg, c, regs,
                                                        local)))
        for dt, dname in ((0, "fp32"), (1, "bf16")):
            for mode, mname in ((0, "partials"), (1, "combine fused in")):
                attrs.append((f"decode split hd{hd} {dname}, {mname}",
                              lambda hd=hd, dt=dt, mode=mode: lib.decode_attrs(
                                  mode, dt, hd, regs, local)))
    for name, get in attrs:
        _build.check(get(), f"{name} attributes")
        log(f"[1] {name}: {regs.value} registers/thread, "
            f"{local.value} B local memory"
            + ("" if local.value == 0 else
               " (spills or a stack frame: an array indexed at run time or "
               "a register ceiling; nvcc -Xptxas -v names which)"))
        if name.startswith("gemm"):
            db = 4 if "fp32" in name else 2
            model = ops.GEMM_REGS_PER_THREAD[db]
            log(f"[1]   resource model: {model} registers/thread")
            if regs.value != model:
                fail(f"{name}: the build uses {regs.value} registers a "
                     f"thread, the resource model {model} "
                     "(kernels/ops.py GEMM_REGS_PER_THREAD): the tuner's "
                     "static invalid configs would not be the card's")

    # 2. kernel vs plain, on the card
    t0 = time.perf_counter()
    errs = check_gemm(dev)
    errs.update(check_gp(dev))
    errs.update(check_flash(dev))
    errs.update(check_decode(dev))
    log(f"[2] kernel-vs-plain checks passed in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.quick:
        log(f"[quick] done in {time.perf_counter() - t_start:.1f} s")
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": card,
            "count": torch.cuda.device_count()}}))
        return 0

    # the store phases 3, 4 and 7 journal into and phase 8 resolves from;
    # removed at exit whatever happens
    store_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    sdir = store_tmp.name
    # 3. the self-hosting cell
    t0 = time.perf_counter()
    t_obs, N_gp, d_gp = MAIN_GP
    gcell = tuning.gp_cell(N=N_gp, T=MAIN_T, d=d_gp, t_obs=t_obs)
    kg.launches = kgp.launches = 0
    gres = tuning.run_kernel_tuning(gcell, sdir, budget=5, init=3,
                                    reps=5)
    gp_tune_launches = kgp.launches
    store = TuningRecordStore(sdir)
    best_bn = tuning.tuned_gp_block_n(store, N=N_gp, T=MAIN_T, d=d_gp)
    want_bn = gcell.space.config(gres.best_idx)["block_n"]
    log(f"[3] gp cell {gcell.objective_id()}: best block_n {want_bn} at "
        f"{gres.best_value * 1e3:.4f} ms over {gres.unique_evals} "
        f"evals ({gp_tune_launches} gp launches); tuned_gp_block_n -> "
        f"{best_bn} ({time.perf_counter() - t0:.1f} s)")
    if best_bn != want_bn:
        fail(f"tuned_gp_block_n returned {best_bn}, store best {want_bn}")

    # 4. the main path
    t0 = time.perf_counter()
    cell = tuning.gemm_cell(*MAIN_GEMM, dtype=torch.float32)
    kg.launches = kgp.launches = 0
    res = tuning.run_kernel_tuning(
        cell, sdir, budget=GEMM_BUDGET, init=3, reps=3,
        gp_backend="cuda", gp_block_n=best_bn)
    launches = {"gemm": kg.launches, "matern_gp": kgp.launches}
    main_s = time.perf_counter() - t0
    best_cfg = cell.space.config(res.best_idx)
    n_static, n_runtime = invalid_split(res, cell)
    default_idx = cell.space.index_of(cell.default)
    default_s = tuning.KernelObjective(cell, reps=5)(default_idx)
    log(f"[4] gemm cell {cell.objective_id()}: {res.unique_evals} evals "
        f"in {main_s:.1f} s; best {best_cfg} "
        f"{res.best_value * 1e3:.4f} ms after {evals_to_best(res)} "
        f"evals; default {cell.default} "
        f"{default_s * 1e3:.4f} ms; invalid {n_static} static, "
        f"{n_runtime} runtime; launches gemm {launches['gemm']}, "
        f"gp {launches['matern_gp']}")
    if launches["gemm"] <= 0 or launches["matern_gp"] <= 0:
        fail(f"main path launch counts {launches}: a kernel of the path "
             "never ran")
    if not math.isfinite(res.best_value) or res.best_value <= 0:
        fail(f"main path best value {res.best_value}")
    got = kg.gemm(*cell.meta["inputs"], **best_cfg)
    want = ref.gemm(*cell.meta["inputs"])
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()) or bool(
            ((got - want).abs() > 1e-3 + 1e-4 * want.abs()).any()):
        fail("tuned gemm output is not finite or disagrees with its "
             "plain version (rtol 1e-4, atol 1e-3)")

    # 5. paper-scale surrogate
    obj = make_objective("gemm", "a100")
    strat = make_strategy("advanced_multi", gp_backend="cuda",
                          gp_block_n=best_bn)
    suggest_s = []
    inner = strat.suggest

    def timed_suggest(n):
        s0 = time.perf_counter()
        out = inner(n)
        if out and out[0].af != "init":        # a BO iteration
            suggest_s.append(time.perf_counter() - s0)
        return out

    strat.suggest = timed_suggest
    kgp.launches, kgp.launch_ms, kgp.time_launches = 0, 0.0, True
    t0 = time.perf_counter()
    cres = run_strategy(strat, obj, budget=220, seed=0)
    wall = time.perf_counter() - t0
    kgp.time_launches = False
    n_gp5, ms_gp5 = kgp.launches, kgp.launch_ms
    t0 = time.perf_counter()
    nres = run_strategy(make_strategy("advanced_multi"), obj, budget=220,
                        seed=0)
    wall_np = time.perf_counter() - t0
    n_it = len(suggest_s)
    sug_ms = 1e3 * sum(suggest_s) / max(n_it, 1)
    ker_ms = ms_gp5 / max(n_it, 1)
    # the host's share that the kernel path adds: packaging the GP state
    # (L^-1 by triangular solve, w, padding) at the run's final t
    g220, _ = gp_state(220, obj.space.size, obj.space.dim, "matern32")
    pack = []
    for _ in range(10):
        s0 = time.perf_counter()
        ops.gp_inputs_from_incremental(g220)
        pack.append(time.perf_counter() - s0)
    log(f"[5] {obj.name} ({obj.space.size} configs), advanced_multi, 220 "
        f"evals: cuda best {cres.best_value:.4f} ms after "
        f"{evals_to_best(cres)} evals in {wall:.1f} s ({n_gp5} gp launches, "
        f"{ms_gp5:.2f} ms in the kernel); numpy best {nres.best_value:.4f} "
        f"ms after {evals_to_best(nres)} evals in {wall_np:.1f} s")
    log(f"[5] per BO iteration ({n_it}): suggest {sug_ms:.3f} ms = kernel "
        f"{ker_ms:.4f} ms + host {sug_ms - ker_ms:.3f} ms; packaging the "
        f"GP state at t=220 takes {1e3 * statistics.median(pack):.3f} ms "
        "(host, median of 10)")
    if n_gp5 < 200:
        fail(f"paper-scale run made {n_gp5} GP-kernel launches, want >= 200")
    if not (math.isfinite(cres.best_value) and cres.unique_evals == 220):
        fail("paper-scale cuda run did not finish its budget with a valid best")

    # 7. BO tunes the serve kernels into the store
    t0 = time.perf_counter()
    tune_serve_kernels(sdir, best_bn)
    log(f"[7] done in {time.perf_counter() - t0:.1f} s")

    # 8. slice 2's main path: serve gemma-2b at full width
    t0 = time.perf_counter()
    served = serve_gemma(sdir, dev)
    log(f"[8] done in {time.perf_counter() - t0:.1f} s")

    # 10. the online loop on a copy of the phase-7 store
    t0 = time.perf_counter()
    online = online_gemma(sdir, dev, served["server"].params, best_bn)
    log(f"[10] done in {time.perf_counter() - t0:.1f} s")

    # 11. this slice's main path: the paper's comparison on the card, the
    # generative backend, and the live comparison on phase 4's cell
    t0 = time.perf_counter()
    n_gp11 = paper_comparison(dev) + generative_on_card(dev)
    n_gemm11 = live_comparison(
        cell, sdir, f"best {best_cfg} {res.best_value * 1e3:.4f} ms after "
        f"{evals_to_best(res)} evals; invalid {n_static} static, "
        f"{n_runtime} runtime")
    log(f"[11] launches: gp {n_gp11}, gemm {n_gemm11}; done in "
        f"{time.perf_counter() - t0:.1f} s")
    if n_gp11 <= 0 or n_gemm11 <= 0:
        fail("phase 11 launched a kernel of its path no time")
    launches["gemm"] += n_gemm11
    launches["matern_gp"] += n_gp11
    store_tmp.cleanup()

    # 6. yardsticks at the main-path shapes: CUDA events around one call
    a, b = cell.meta["inputs"]
    M, N, K = MAIN_GEMM
    Xc, x_obs, vinv, w, mask = gp_problem(*MAIN_GP, "matern32", MAIN_T)
    gargs = [torch.from_numpy(x).to(dev) for x in (Xc, x_obs, vinv, w, mask)]
    N_, T_, d_ = Xc.shape[0], MAIN_T, Xc.shape[1]
    gemm_bytes = 4.0 * (M * K + K * N + M * N)
    cores_ms = bound_ms(2.0 * M * N * K, gemm_bytes, card)[0]
    gp_cores, gp_path = gp_bounds(N_, T_, d_, card)
    a16, b16 = a.bfloat16(), b.bfloat16()
    cases = {
        "gemm": (f"gemm {M}x{N}x{K} fp32 {best_cfg} (3xTF32 on the tensor "
                 f"cores; bound on the CUDA cores {cores_ms:.6f} ms); "
                 "library torch.matmul",
                 lambda: kg.gemm(a, b, **best_cfg), lambda: ref.gemm(a, b),
                 lambda: torch.matmul(a, b),
                 *bound_ms(2.0 * M * N * K, gemm_bytes, card, "tf32x3")),
        "gemm bf16": (f"gemm {M}x{N}x{K} bf16 {cell.default} (tensor cores)"
                      "; library torch.matmul",
                      lambda: kg.gemm(a16, b16, **cell.default),
                      lambda: ref.gemm(a16, b16),
                      lambda: torch.matmul(a16, b16),
                      *bound_ms(2.0 * M * N * K, gemm_bytes / 2, card,
                                "bfloat16")),
        "matern_gp": (
            f"gp N={N_} T={T_} d={d_} block_n={best_bn} (the product as "
            f"3xTF32 on the tensor cores; bound on the CUDA cores "
            f"{gp_cores[0]:.6f} ms); library none",
            lambda: kgp.gp_posterior(*gargs, ell=2.0, nu="matern32",
                                     block_n=best_bn),
            lambda: ref.gp_posterior(*gargs[:4], 2.0, "matern32",
                                     mask=gargs[4]), None, *gp_path)}
    cases.update(serve_cases(served["kc"], dev, card))
    event = {}
    for name, (label, *fns, bound, by) in cases.items():
        event[name] = [None if f is None else timed(event_ms, f,
                                                    f"[6] {name} events")
                       for f in fns]
        k_ms, p_ms, l_ms = event[name]
        log(f"[6] {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"library {'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
            f"{bound:.6f} ms ({by})")

    # 9. device time and the device's busy share, from torch.profiler; run
    # last, since a profiler session leaves host overhead behind it. The
    # phase-8 server keeps no logits here: its decode steps replay the
    # graph and copy nothing to the host
    server, batch = served["server"], served["batch"]
    server.keep_logits = 0
    profile_window(lambda: server.prefill_batch(batch), "a prefill")
    rows = profile_window(lambda: [server.decode_step()
                                   for _ in range(PROFILE_STEPS)],
                          f"{PROFILE_STEPS} decode steps after it")
    n_layers = served["server"].cfg.num_layers
    if rows:
        # the decode attention on the trace: one kernel a layer and step
        dec = {name: n for _, n, name in rows if "decode" in name}
        log(f"[9] decode kernels in the window: {dec}")
        if (len(dec) != 1 or "decode_split_kernel" not in next(iter(dec))
                or sum(dec.values()) != n_layers * PROFILE_STEPS):
            fail(f"decode window: want {n_layers * PROFILE_STEPS} launches "
                 f"of decode_split_kernel and no other decode kernel, got "
                 f"{dec}")
    seen = []
    device_ms(cases[FUSED_DECODE][1], kernels=seen)
    log(f"[9] device kernels per fused decode call: {seen}")
    if seen and (len(seen) != 1 or seen[0][1] != 1):
        fail(f"the fused decode call launched {seen}, want one kernel")
    device = {}
    for name, (label, *fns, bound, by) in cases.items():
        device[name] = [None if f is None else timed(device_ms, f,
                                                     f"[9] {name} device")
                        for f in fns]
        k_ms, p_ms, l_ms = (("not measured" if x is None else f"{x:.4f} ms")
                            if f is not None else "none"
                            for x, f in zip(device[name], fns))
        k_d, p_d, l_d = device[name]
        ratio = "".join(f"; kernel / {what} {k_d / x:.3f}"
                        for what, x in (("plain", p_d), ("library", l_d))
                        if k_d is not None and x is not None)
        log(f"[9] {label}: device time kernel {k_ms}, plain {p_ms}, library "
            f"{l_ms}, bound {bound:.6f} ms ({by}){ratio}")

    summary = {"kernels": []}
    for name, src, line in (
            ("gemm", "gemm.cu", "gemm.py:21"),
            ("matern_gp", "matern_gp.cu", "matern_gp.py:44"),
            ("flash_attention", "flash_attention.cu", "flash_attention.py:22"),
            ("flash_decode_split", "flash_decode.cu", "flash_decode.py:37"),
            # the combine: the tail fused into the split kernel's launch
            ("flash_decode_combine", "flash_decode.cu", "flash_decode.py:94")):
        n = launches[name] if name in launches else served["launches"][name]
        # device time where the profiler gave one, else the event time
        k_ms, p_ms, l_ms = (e if d is None else d
                            for d, e in zip(device[name], event[name]))
        summary["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{line}", "launches": n,
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": cases[name][-2], "bound_by": cases[name][-1],
            "library_ms": l_ms})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(summary))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
