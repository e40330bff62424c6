#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's tuning loop on one NVIDIA card, and check it.

    python3 chip_smoke.py            # every phase, on cuda:0
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, in order; any failure exits non-zero and prints no result:
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel under src/repro_torch/kernels/csrc, registers per thread;
  2. each CUDA kernel against its plain PyTorch version on the card: GEMM in
     fp32 and bf16 at 128³, 256x384x512 and 4096³ under several block
     configs; the Matérn-GP posterior for all four ν at (t,N,d) = (13,512,6),
     (37,1024,15) and the paper's panel (220,18432,15) padded to T = 256;
  3. the self-hosting cell: BO tunes the GP kernel's block_n at the paper's
     panel, journaled into a temporary store, and tuned_gp_block_n reads
     the stored best back;
  4. the main path: BO, its surrogate on the GP kernel with that block_n,
     tunes the 4096³ fp32 GEMM kernel, journaled into the same store;
  5. the paper-scale surrogate: advanced_multi BO over the paper's CLBlast
     GEMM space (17,956 configs) for 220 evaluations with gp_backend="cuda",
     beside a gp_backend="numpy" run of the same seed;
  6. yardsticks at the main-path shapes: kernel, plain-version and library
     times beside each kernel's bound.
The line before the last holds the kernels' JSON summary, the one before it
the card's name and power limit; the last line is the device JSON.
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
               (128, 128, 128))
GP_SHAPES = ((13, 512, 6), (37, 1024, 15), (220, 18432, 15))
MAIN_GEMM = (4096, 4096, 4096)
MAIN_GP = (220, 18432, 15)          # 17,956 candidates padded to a tile multiple
MAIN_T = 256
# about 1 config in 6 of the 4096³ space passes the resource model, and the
# paper's init repairs invalid draws until ``init`` are valid, so the budget
# leaves room for both the repairs and the BO iterations
GEMM_BUDGET = 40


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


def gp_state(t: int, N: int, d: int, nu: str, seed: int = 5):
    """A real IncrementalGP state: t observations drawn from an N-candidate
    panel of dimension d, and the panel (fp32)."""
    import numpy as np
    from repro_torch.core.gp_fast import IncrementalGP
    rng = np.random.default_rng(seed)
    Xc = rng.random((N, d)).astype(np.float32)
    g = IncrementalGP(Xc, max_obs=t, kernel=nu, ell=2.0)
    for _ in range(t):
        g.add(Xc[rng.integers(N)], float(rng.normal(10, 3)))
    return g, Xc


def gp_problem(t: int, N: int, d: int, nu: str, T=None):
    """Padded kernel inputs (numpy) of ``gp_state``'s GP."""
    from repro_torch.kernels import ops
    g, Xc = gp_state(t, N, d, nu)
    return (Xc,) + ops.gp_inputs_from_incremental(g, pad_T=T)[:4]


# -- phase 2 -------------------------------------------------------------------


def check_gemm(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import gemm as kg, ops, ref
    worst = {}
    for (M, N, K) in GEMM_SHAPES:
        rng = np.random.default_rng(0)
        a64 = torch.from_numpy(rng.normal(size=(M, K)))
        b64 = torch.from_numpy(rng.normal(size=(K, N)))
        for dtype, tol in ((torch.float32, (1e-4, 1e-3)),
                           (torch.bfloat16, (3e-2, 3e-2))):
            a, b = a64.to(dev, dtype), b64.to(dev, dtype)
            want = ref.gemm(a, b).float()
            dtype_bytes = a.element_size()
            for bm, bn, bk in GEMM_BLOCKS:
                cfg = {"block_m": bm, "block_n": bn, "block_k": bk}
                if M % bm or N % bn or K % bk or not ops.gemm_valid(
                        cfg, dtype_bytes):
                    continue
                got = kg.gemm(a, b, block_m=bm, block_n=bn,
                              block_k=bk).float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                rtol, atol = tol
                bad = int((err > atol + rtol * want.abs()).sum())
                mx = float(err.max())
                log(f"  gemm {M}x{N}x{K} {str(dtype)[6:]:8s} blocks "
                    f"({bm},{bn},{bk}): max|err| {mx:.3e} (rtol {rtol}, "
                    f"atol {atol}) -> {'ok' if bad == 0 else f'{bad} BAD'}")
                if bad:
                    fail(f"gemm {M}x{N}x{K} {dtype} ({bm},{bn},{bk}) "
                         f"disagrees with its plain version in {bad} entries")
                if (M, N, K) == MAIN_GEMM and dtype == torch.float32:
                    worst["gemm"] = max(worst.get("gemm", 0.0), mx)
    return worst


def check_gp(dev) -> dict:
    import torch
    from repro_torch.kernels import matern_gp as kgp, ref
    worst = {}
    for (t, N, d) in GP_SHAPES:
        T = MAIN_T if (t, N, d) == MAIN_GP else None
        for nu in ("matern12", "matern32", "matern52", "rbf"):
            Xc, x_obs, vinv, w, mask = gp_problem(t, N, d, nu, T)
            args = [torch.from_numpy(x).to(dev)
                    for x in (Xc, x_obs, vinv, w, mask)]
            mean_k, var_k = kgp.gp_posterior(*args, ell=2.0, nu=nu,
                                              block_n=256)
            mean_r, var_r = ref.gp_posterior(*args[:4], 2.0, nu,
                                             mask=args[4])
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
            if not ok:
                i = int(torch.argmax((var_k - var_r).abs()))
                log(f"    worst var at {i}: kernel {float(var_k[i]):.6e}, "
                    f"plain {float(var_r[i]):.6e}")
                fail(f"gp_posterior t={t} N={N} d={d} {nu} disagrees with "
                     "its plain version")
            if (t, N, d) == MAIN_GP:
                worst["gp"] = max(worst.get("gp", 0.0), m_err, v_err)
    return worst


# -- phases 3-6 ------------------------------------------------------------------


def evals_to_best(result) -> int:
    """Unique evaluations until the run's best value was first reached."""
    return int(next(i for i, v in enumerate(result.trace)
                    if v == result.best_value)) + 1


def invalid_split(result, cell):
    """(static, runtime) invalid counts of a kernel-tuning run's journal."""
    static = runtime = 0
    for o in result.journal:
        if not math.isfinite(o.value):
            if cell.valid(cell.space.config(o.idx)):
                runtime += 1
            else:
                static += 1
    return static, runtime


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
    for name, attrs in (("gemm fp32", lambda: lib.gemm_attrs(0, regs, local)),
                        ("gemm bf16", lambda: lib.gemm_attrs(1, regs, local)),
                        ("gp", lambda: lib.gp_attrs(regs, local))):
        _build.check(attrs(), f"{name} attributes")
        log(f"[1] {name}: {regs.value} registers/thread, "
            f"{local.value} B local memory")

    # 2. kernel vs plain, on the card
    t0 = time.perf_counter()
    errs = check_gemm(dev)
    errs.update(check_gp(dev))
    log(f"[2] kernel-vs-plain checks passed in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.quick:
        log(f"[quick] done in {time.perf_counter() - t_start:.1f} s")
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": card,
            "count": torch.cuda.device_count()}}))
        return 0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as sdir:
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
        launches = {"gemm": kg.launches, "gp": kgp.launches}
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
            f"gp {launches['gp']}")
        if launches["gemm"] <= 0 or launches["gp"] <= 0:
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

    # 6. yardsticks at the main-path shapes
    a, b = cell.meta["inputs"]
    M, N, K = MAIN_GEMM
    g_ms = event_ms(lambda: kg.gemm(a, b, **best_cfg))
    g_plain = event_ms(lambda: ref.gemm(a, b))
    g_lib = event_ms(lambda: torch.matmul(a, b))
    g_bound, g_by = bound_ms(2.0 * M * N * K, 4.0 * (M * K + K * N + M * N),
                             card)
    Xc, x_obs, vinv, w, mask = gp_problem(*MAIN_GP, "matern32", MAIN_T)
    gargs = [torch.from_numpy(x).to(dev) for x in (Xc, x_obs, vinv, w, mask)]
    N_, T_, d_ = Xc.shape[0], MAIN_T, Xc.shape[1]
    p_ms = event_ms(lambda: kgp.gp_posterior(*gargs, ell=2.0, nu="matern32",
                                             block_n=best_bn))
    p_plain = event_ms(lambda: ref.gp_posterior(*gargs[:4], 2.0, "matern32",
                                                mask=gargs[4]))
    p_bound, p_by = bound_ms(
        N_ * (3.0 * T_ * d_ + T_ * T_),
        4.0 * (N_ * d_ + T_ * d_ + T_ * T_ + 2 * T_ + 2 * N_), card)
    log(f"[6] gemm {M}x{N}x{K} fp32 {best_cfg}: kernel {g_ms:.4f} ms, plain "
        f"{g_plain:.4f} ms, torch.matmul {g_lib:.4f} ms, bound {g_bound:.4f} "
        f"ms ({g_by})")
    log(f"[6] gp N={N_} T={T_} d={d_} block_n={best_bn}: kernel {p_ms:.4f} "
        f"ms, plain {p_plain:.4f} ms, bound {p_bound:.4f} ms ({p_by}); no "
        "single PyTorch call computes it (library: none)")

    summary = {"kernels": [
        {"name": "gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "replaces": "src/repro/kernels/gemm.py:21",
         "launches": launches["gemm"], "max_abs_err": errs["gemm"],
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": g_lib},
        {"name": "matern_gp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matern_gp.cu",
         "replaces": "src/repro/kernels/matern_gp.py:44",
         "launches": launches["gp"], "max_abs_err": errs["gp"],
         "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound,
         "bound_by": p_by, "library_ms": None}]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(summary))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
