"""The paper's evaluation on the port: the strategy comparisons (Figs. 1,
5 and 6-7), the evaluations the baselines need to match EI (Fig. 4), the
BO hyperparameter table (Table I) and the record store's cross-size warm
start.

    PYTHONPATH=src python -m repro_torch.launch.compare --figure 1|4|5|6 \
        [--repeats N] [--device cuda|cpu] [--out PATH]
    PYTHONPATH=src python -m repro_torch.launch.compare --table 1 [...]
    PYTHONPATH=src python -m repro_torch.launch.compare --warm-start \
        [--smoke] [--kernel NAME] [...]

Port of the reference's ``benchmarks/common.py::run_matrix`` and
``mdf_from_matrix`` and of its benchmark scripts: ``fig1_comparison.py``
(BO against Kernel Tuner's baselines, GTX Titan X spaces),
``fig5_frameworks.py`` (BO against the BayesianOptimization and
scikit-optimize analogues, RTX 2070 Super spaces), ``fig6_7_unseen.py``
(the unseen ExpDist and Adding kernels on the A100 spaces),
``fig4_extended.py`` (GEMM on the GTX Titan X space: EI's mean best at 220
evaluations is the target; the baselines run to 1,020 and are scored by
the evaluations they need to match it), ``table1_hyperparams.py`` (ten
``BOConfig`` variants over the three GTX Titan X kernels, ranked by MDF)
and ``warm_start.py`` (ExpDist on the A100 at sequence 512 journaled into a
store, then sequence 4,096 tuned cold and warm-started from a fresh copy of
that store; scored by the evaluations to the cold run's best, against the
30% bar; ``--kernel`` runs it on another simulated space: ExpDist's runs
observe few valid configurations, so its warm GP ends near 80
observations, where GEMM's holds 256 priors and 220 evaluations, T 512 in
the GP kernel). A figure's (kernel, strategy) runs ``repeats`` seeds (random
search twice as many, at least 10) of the paper's 220 evaluations over the
simulated spaces and reports the paper's MAE, and each strategy its MDF
over the kernels. Cut: the reference's worker/batch parallelism and store
journaling of the matrices (every run here is the sequential paper loop).

On the card (the default) BO's surrogate runs on the hand-written GP kernel
(``gp_backend="cuda"``, Table I's variants too) and the frameworks' padded
GP on the card; with ``--device cpu`` every result is the reference's
(numpy GP; the frameworks' GP on the CPU). The objectives are simulated,
so MAE, MDF and evaluation counts depend on the card only through the GP's
arithmetic. It prints the reference's rows (``fig<N>/<kernel>/<strategy>,
<us per run>,mae=``, ``fig4/<strategy>``, ``table1/<variant>``,
``warm_start/...``) and writes nothing unless ``--out`` names a JSON file:
the warm start's stores are temporary directories, removed afterwards.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import evals_to_match, mae, mdf_table
from repro_torch.core.objectives import SimulatedObjective
from repro_torch.core.runner import TuneResult, run_strategy
from repro_torch.core.spaces import make_objective, make_scenario_objective
from repro_torch.core.strategies import (ALL_FRAMEWORKS, BO_NAMES,
                                         make_strategy)
from repro_torch.core.strategies.base import Strategy
from repro_torch.core.strategies.bo import BOConfig, BOStrategy
from repro_torch.kernels.tuning import resolve_device
from repro_torch.store.records import TuningRecordStore

PAPER_BUDGET = 220
KERNELS = ("gemm", "convolution", "pnpoly")
#: figure -> (the paper's GPU whose spaces it runs, strategies, repeats)
FIGURES = {
    1: ("gtx_titan_x", ("advanced_multi", "multi", "ei", "genetic_algorithm",
                        "mls", "simulated_annealing", "random"), 7),
    5: ("rtx_2070_super", ("advanced_multi", "multi", "ei", "bayesopt_ucb",
                           "skopt_gphedge", "random"), 5),
    6: ("a100", ("advanced_multi", "multi", "ei", "genetic_algorithm", "mls",
                 "simulated_annealing", "random"), 7),
}
#: a figure's own kernels where they are not ``KERNELS``: Figs. 6-7 (run
#: as ``--figure 6``) are the unseen kernels, ExpDist (50.8% of its
#: configurations invalid) and Adding
FIGURE_KERNELS = {6: ("expdist", "adding")}
#: the rows' prefix of each figure
FIGURE_TAGS = {6: "fig6_7"}

#: Fig. 4: the kernel and GPU, EI's budget (its mean best is the target),
#: the strategies scored against it, their cap and the paper's repeats
FIG4_KERNEL, FIG4_GPU, FIG4_TARGET = "gemm", "gtx_titan_x", "ei"
FIG4_OTHERS = ("genetic_algorithm", "mls", "simulated_annealing", "random")
FIG4_BUDGET, FIG4_CAP, FIG4_REPEATS = PAPER_BUDGET, 1020, 7

#: Table I: the kernels, GPU, budget and repeats, and the ten BO variants
#: (the reference's ``benchmarks/table1_hyperparams.py``, name for name)
TABLE1_KERNELS, TABLE1_GPU = ("gemm", "convolution", "pnpoly"), "gtx_titan_x"
TABLE1_BUDGET, TABLE1_REPEATS = PAPER_BUDGET, 5
VARIANTS: Dict[str, BOConfig] = {
    # Table I winner
    "m32_l2.0_cv_advmulti": BOConfig(acquisition="advanced_multi",
                                     kernel="matern32", lengthscale_cv=1.5),
    "m32_l2.0_cv_multi": BOConfig(acquisition="multi", kernel="matern32"),
    "m32_l2.0_cv_ei": BOConfig(acquisition="ei", kernel="matern32"),
    # covariance alternatives
    "m52_l0.5_cv_advmulti": BOConfig(acquisition="advanced_multi",
                                     kernel="matern52", lengthscale_cv=0.5),
    "rbf_l1.0_cv_advmulti": BOConfig(acquisition="advanced_multi",
                                     kernel="rbf", lengthscale_cv=1.0),
    # constant exploration instead of CV
    "m32_l2.0_x0.01_advmulti": BOConfig(acquisition="advanced_multi",
                                        exploration=0.01, lengthscale=2.0),
    "m32_l2.0_x0.1_advmulti": BOConfig(acquisition="advanced_multi",
                                       exploration=0.1, lengthscale=2.0),
    # discount / improvement factor
    "advmulti_disc0.9": BOConfig(acquisition="advanced_multi", discount=0.9),
    "advmulti_if0.05": BOConfig(acquisition="advanced_multi",
                                improvement_factor=0.05),
    # initial sampling: random instead of maximin LHS
    "advmulti_random_init": BOConfig(acquisition="advanced_multi",
                                     maximin=False),
}

#: the cross-size warm start: kernel, GPU, source and target problem
#: sizes, strategy, budget, source runs (seeds 100, 101, ...), the
#: acceptance bar, the paper's repeats, and ``--smoke``'s cut (source
#: runs, budget, at most this many seeds)
WARM_KERNEL, WARM_GPU = "expdist", "a100"
WARM_SOURCE, WARM_TARGET = "seq512", "seq4096"
WARM_STRATEGY, WARM_BUDGET, WARM_SOURCE_RUNS = "advanced_multi", 220, 3
WARM_TARGET_REDUCTION, WARM_REPEATS = 0.30, 5
WARM_SMOKE = (1, 60, 2)


def bo_kwargs(device) -> Dict:
    """``BOConfig`` fields that put BO's surrogate on ``device``: the GP
    kernel (and the ``jax`` engine's padded GP) on the card, the numpy GP
    on the CPU."""
    dev = torch.device(device)
    return ({"gp_backend": "cuda", "gp_device": str(dev)}
            if dev.type == "cuda" else {"gp_device": "cpu"})


def strategy_kwargs(name: str, device) -> Dict:
    """``make_strategy`` arguments that put a strategy's surrogate on
    ``device``: BO's as :func:`bo_kwargs`, the frameworks' padded GP on
    ``device``; the baselines have none."""
    dev = torch.device(device)
    if name in BO_NAMES:
        return bo_kwargs(dev)
    if name in ALL_FRAMEWORKS:
        return {"device": str(dev)}
    return {}


class TimedStrategy(Strategy):
    """A strategy whose ``suggest``/``observe`` time (host clock) is summed
    in ``seconds``: the tuner's own time, the surrogate's included (its
    results come back to the host, so device work is inside the clock).
    ``proposals`` counts what ``suggest`` handed out."""

    def __init__(self, inner: Strategy):
        self.inner = inner
        self.name = inner.name
        self.seconds = 0.0
        self.proposals = 0

    def reset(self, ctx) -> None:
        self.inner.reset(ctx)

    def warm_start(self, warm) -> None:
        self.inner.warm_start(warm)

    def suggest(self, n: int):
        t0 = time.perf_counter()
        out = self.inner.suggest(n)
        self.seconds += time.perf_counter() - t0
        self.proposals += len(out)
        return out

    def observe(self, proposal, value: float) -> None:
        t0 = time.perf_counter()
        self.inner.observe(proposal, value)
        self.seconds += time.perf_counter() - t0


@dataclass
class Run:
    """One run of the evaluation, as ``on_run`` receives it. ``label`` is
    ``<what>/<strategy>/seed<seed>``."""
    label: str
    strategy: "TimedStrategy"
    objective: SimulatedObjective
    budget: int
    seed: int
    result: TuneResult
    wall_s: float


#: Called after every run: how a caller checks each one (``chip_smoke.py``
#: counts its GP-kernel launches, holds a baseline's trace to the CPU's,
#: and looks for a config evaluated twice).
OnRun = Callable[[Run], None]


def timed_run(strategy: Strategy, obj, budget: int, seed: int, label: str, *,
              on_run: Optional[OnRun] = None, timer=None, store=None,
              warm_start: bool = True) -> Run:
    """One sequential paper-loop run of ``strategy`` wrapped in ``timer``
    (a ``TimedStrategy`` class, the default), passed to ``on_run``."""
    s = (timer or TimedStrategy)(strategy)
    t0 = time.time()
    res = run_strategy(s, obj, budget=budget, seed=seed, store=store,
                       warm_start=warm_start)
    run = Run(label, s, obj, budget, seed, res, time.time() - t0)
    if on_run is not None:
        on_run(run)
    return run


def tuner_ms(run: Run) -> float:
    """The tuner's own milliseconds per proposal."""
    return 1e3 * run.strategy.seconds / max(run.strategy.proposals, 1)


def run_matrix(kernels: Sequence[str], gpu: str, strategies: Sequence[str],
               repeats: int, budget: int = PAPER_BUDGET,
               random_repeats: Optional[int] = None,
               device=None, on_run: Optional[OnRun] = None,
               timer=None) -> Dict:
    """Per (kernel, strategy): traces + mean MAE (paper methodology), plus
    the tuner's own milliseconds per proposal."""
    dev = resolve_device(device)
    out: Dict[str, Dict[str, Dict]] = {}
    for kernel in kernels:
        obj = make_objective(kernel, gpu)
        out[kernel] = {}
        for strat in strategies:
            reps = (random_repeats or repeats) if strat == "random" else repeats
            traces, times, ms = [], [], []
            for seed in range(reps):
                run = timed_run(
                    make_strategy(strat, **strategy_kwargs(strat, dev)), obj,
                    budget, seed, f"{kernel}/{strat}/seed{seed}",
                    on_run=on_run, timer=timer, warm_start=False)
                times.append(run.wall_s)
                traces.append(run.result.trace)
                ms.append(tuner_ms(run))
            maes = [mae(t, obj.optimum) for t in traces]
            out[kernel][strat] = {
                "mean_mae": float(np.mean(maes)),
                "std_mae": float(np.std(maes)),
                "mean_wall_s": float(np.mean(times)),
                "tuner_ms_per_eval": float(np.mean(ms)),
                "best_final": float(np.mean([t[min(len(t), budget) - 1]
                                             for t in traces])),
                "optimum": obj.optimum,
                "traces": [t.tolist() for t in traces],
            }
    return out


def mdf_from_matrix(matrix: Dict) -> Dict:
    per_kernel = {k: {s: v["mean_mae"] for s, v in d.items()}
                  for k, d in matrix.items()}
    return mdf_table(per_kernel)


def strip_traces(matrix: Dict) -> Dict:
    return {k: {s: {kk: vv for kk, vv in v.items() if kk != "traces"}
                for s, v in d.items()} for k, d in matrix.items()}


def fig4(repeats: int, budget: int = FIG4_BUDGET, cap: int = FIG4_CAP,
         device=None, on_run: Optional[OnRun] = None, timer=None) -> Dict:
    """Fig. 4: EI's mean best over ``repeats`` seeds at ``budget`` is the
    target; each other strategy runs the same seeds to ``cap`` evaluations
    and is scored by the evaluations it needs to match the target
    (``cap + 1`` where it never does)."""
    dev = resolve_device(device)
    obj = make_objective(FIG4_KERNEL, FIG4_GPU)
    best, walls, ms = [], [], []
    for seed in range(repeats):
        run = timed_run(
            make_strategy(FIG4_TARGET, **strategy_kwargs(FIG4_TARGET, dev)),
            obj, budget, seed, f"fig4/{FIG4_TARGET}/seed{seed}",
            on_run=on_run, timer=timer)
        best.append(run.result.best_value)
        walls.append(run.wall_s)
        ms.append(tuner_ms(run))
    out = {"target": float(np.mean(best)), "budget": budget, "cap": cap,
           "target_runs": {"best": [float(b) for b in best],
                           "mean_wall_s": float(np.mean(walls)),
                           "tuner_ms_per_eval": float(np.mean(ms))},
           "others": {}}
    for strat in FIG4_OTHERS:
        evals, walls = [], []
        for seed in range(repeats):
            run = timed_run(
                make_strategy(strat, **strategy_kwargs(strat, dev)), obj,
                cap, seed, f"fig4/{strat}/seed{seed}", on_run=on_run,
                timer=timer)
            evals.append(evals_to_match(run.result.trace, out["target"],
                                        cap))
            walls.append(run.wall_s)
        out["others"][strat] = {
            "evals": evals, "mean_evals": float(np.mean(evals)),
            "frac_matched": float(np.mean([e <= cap for e in evals])),
            "mean_wall_s": float(np.mean(walls))}
    return out


def table1(repeats: int, budget: int = TABLE1_BUDGET,
           kernels: Sequence[str] = TABLE1_KERNELS, device=None,
           on_run: Optional[OnRun] = None, timer=None) -> Dict:
    """Table I: each BO variant's mean MAE over ``repeats`` seeds on each
    kernel, the MDF over the kernels, and the variants ranked by it. On the
    card each variant's surrogate runs the GP kernel (its covariance
    included)."""
    dev = resolve_device(device)
    per_kernel: Dict[str, Dict[str, float]] = {k: {} for k in kernels}
    wall_s: Dict[str, Dict[str, float]] = {k: {} for k in kernels}
    for kernel in kernels:
        obj = make_objective(kernel, TABLE1_GPU)
        for name, cfg in VARIANTS.items():
            cfg = dataclasses.replace(cfg, **bo_kwargs(dev))
            maes, walls = [], []
            for seed in range(repeats):
                run = timed_run(
                    BOStrategy(cfg, name=name), obj, budget, seed,
                    f"table1/{kernel}/{name}/seed{seed}", on_run=on_run,
                    timer=timer)
                maes.append(mae(run.result.trace, obj.optimum))
                walls.append(run.wall_s)
            per_kernel[kernel][name] = float(np.mean(maes))
            wall_s[kernel][name] = float(np.mean(walls))
    mdf = mdf_table(per_kernel)
    ranked = sorted(mdf.items(), key=lambda kv: kv[1]["mdf"])
    return {"per_kernel": per_kernel, "mdf": mdf,
            "ranked": [name for name, _ in ranked], "mean_wall_s": wall_s}


def evals_to_reach(trace: np.ndarray, value: float) -> Optional[int]:
    """1-based unique-eval count at which best-so-far first reaches value
    (the reference's ``benchmarks/warm_start.py``)."""
    hit = np.flatnonzero(trace <= value + 1e-12)
    return int(hit[0]) + 1 if hit.size else None


def warm_start(repeats: int, *, kernel: str = WARM_KERNEL,
               smoke: bool = False, device=None,
               on_run: Optional[OnRun] = None, timer=None,
               log=print) -> Dict:
    """The store's cross-size warm start: ``WARM_SOURCE_RUNS`` runs on the
    source size journaled into a temporary store, then per seed a cold run
    on the target size and a warm run journaled into a fresh copy of the
    source-only store (a shared one would leak earlier seeds' exact target
    records, and the metric would measure replay, not transfer). Scored by
    the evaluations to the cold run's best; a warm run that never reaches
    it scores the full budget. The stores are removed afterwards.
    ``kernel`` is the reference's ExpDist unless another of the simulated
    spaces is named: ExpDist's runs observe few valid configurations (the
    GP holds about 80 observations at the warm run's end), GEMM's hold
    the 256 priors beside 220 evaluations (T 512)."""
    dev = resolve_device(device)
    budget, source_runs = WARM_BUDGET, WARM_SOURCE_RUNS
    if smoke:
        source_runs, budget, most = WARM_SMOKE
        repeats = max(min(repeats, most), 1)
    kw = strategy_kwargs(WARM_STRATEGY, dev)
    src = make_scenario_objective(kernel, WARM_GPU, WARM_SOURCE)
    tgt = make_scenario_objective(kernel, WARM_GPU, WARM_TARGET)
    rows, sources = [], []
    with tempfile.TemporaryDirectory(prefix="warm_start_") as tmp:
        store_path = os.path.join(tmp, "source")
        for s in range(source_runs):
            run = timed_run(
                make_strategy(WARM_STRATEGY, **kw), src, budget, 100 + s,
                f"warm_start/source/seed{100 + s}", on_run=on_run,
                timer=timer, store=store_path)
            best = run.result.best_value
            sources.append({"best": float(best), "wall_s": run.wall_s})
            log(f"warm_start/source_run_{s},{run.wall_s * 1e6:.1f},"
                f"best={best:.3f}")
        n_records = len(TuningRecordStore(store_path))
        for seed in range(repeats):
            cold = timed_run(
                make_strategy(WARM_STRATEGY, **kw), tgt, budget, seed,
                f"warm_start/cold/seed{seed}", on_run=on_run, timer=timer)
            seed_store = os.path.join(tmp, f"seed{seed}")
            shutil.copytree(store_path, seed_store)
            warm = timed_run(
                make_strategy(WARM_STRATEGY, **kw), tgt, budget, seed,
                f"warm_start/warm/seed{seed}", on_run=on_run, timer=timer,
                store=seed_store)
            cold_best = cold.result.best_value
            c = evals_to_reach(cold.result.trace, cold_best)
            w = evals_to_reach(warm.result.trace, cold_best)
            rows.append({
                "seed": seed, "cold_best": float(cold_best),
                "warm_best": float(warm.result.best_value),
                "cold_evals_to_best": c, "warm_evals_to_cold_best": w,
                "warm_reached": w is not None,
                "cold_wall_s": cold.wall_s, "warm_wall_s": warm.wall_s,
                "cold_tuner_ms_per_eval": tuner_ms(cold),
                "warm_tuner_ms_per_eval": tuner_ms(warm)})
            log(f"warm_start/seed{seed},0.0,cold={c} "
                f"warm={w if w is not None else f'>{budget}'}"
                f" tuner_ms_per_eval cold={tuner_ms(cold):.3f} "
                f"warm={tuner_ms(warm):.3f}")
    cold_mean = float(np.mean([r["cold_evals_to_best"] for r in rows]))
    warm_mean = float(np.mean([budget if r["warm_evals_to_cold_best"] is None
                               else r["warm_evals_to_cold_best"]
                               for r in rows]))
    reduction = 1.0 - warm_mean / cold_mean
    log(f"warm_start/reduction,0.0,{reduction:.1%}")
    return {
        "scenario": {"kernel": kernel, "gpu": WARM_GPU,
                     "source": WARM_SOURCE, "target": WARM_TARGET,
                     "strategy": WARM_STRATEGY, "budget": budget,
                     "source_runs": source_runs,
                     "source_space": src.space.size,
                     "target_space": tgt.space.size,
                     "store_records": n_records},
        "sources": sources, "rows": rows,
        "cold_mean_evals_to_best": cold_mean,
        "warm_mean_evals_to_cold_best": warm_mean,
        "reduction": reduction,
        "acceptance": {"target_reduction": WARM_TARGET_REDUCTION,
                       "meets_target": reduction >= WARM_TARGET_REDUCTION}}


def _figure(figure: int, repeats: Optional[int], dev, where: str) -> Dict:
    gpu, strategies, paper_repeats = FIGURES[figure]
    repeats = repeats or paper_repeats
    tag = FIGURE_TAGS.get(figure, f"fig{figure}")
    print(f"# {tag}: {gpu} spaces, {repeats} repeats "
          f"(random {max(repeats * 2, 10)}), tuner on {where}", flush=True)
    matrix = run_matrix(FIGURE_KERNELS.get(figure, KERNELS), gpu, strategies,
                        repeats, budget=PAPER_BUDGET,
                        random_repeats=max(repeats * 2, 10), device=dev)
    mdf = mdf_from_matrix(matrix)
    for kernel, d in matrix.items():
        for strat, v in d.items():
            print(f"{tag}/{kernel}/{strat},{v['mean_wall_s'] * 1e6:.1f},"
                  f"mae={v['mean_mae']:.4f}"
                  f" tuner_ms_per_eval={v['tuner_ms_per_eval']:.3f}")
    for strat, v in mdf.items():
        print(f"{tag}/mdf/{strat},0.0,mdf={v['mdf']:.4f}±{v['std']:.3f}")
    return {"figure": figure, "repeats": repeats,
            "matrix": strip_traces(matrix), "mdf": mdf}


def _fig4(repeats: Optional[int], dev, where: str) -> Dict:
    repeats = repeats or FIG4_REPEATS
    print(f"# fig4: {FIG4_KERNEL} on {FIG4_GPU}, {repeats} repeats, "
          f"{FIG4_TARGET} at {FIG4_BUDGET}, cap {FIG4_CAP}, tuner on {where}",
          flush=True)
    out = fig4(repeats, budget=FIG4_BUDGET, cap=FIG4_CAP, device=dev)
    print(f"fig4/{FIG4_TARGET}_target,0.0,best_at_{FIG4_BUDGET}="
          f"{out['target']:.4f}"
          f" tuner_ms_per_eval={out['target_runs']['tuner_ms_per_eval']:.3f}")
    for strat, v in out["others"].items():
        print(f"fig4/{strat},0.0,evals_to_match={v['mean_evals']:.0f} "
              f"matched={v['frac_matched']:.0%}")
    return {"figure": 4, "repeats": repeats, **out}


def _table1(repeats: Optional[int], dev, where: str) -> Dict:
    repeats = repeats or TABLE1_REPEATS
    print(f"# table1: {', '.join(TABLE1_KERNELS)} on {TABLE1_GPU}, "
          f"{len(VARIANTS)} variants, {repeats} repeats at {TABLE1_BUDGET}, "
          f"tuner on {where}", flush=True)
    out = table1(repeats, budget=TABLE1_BUDGET, kernels=TABLE1_KERNELS,
                 device=dev)
    for name in out["ranked"]:
        print(f"table1/{name},0.0,mdf={out['mdf'][name]['mdf']:.4f}")
    return {"table": 1, "repeats": repeats, **out}


def _warm_start(repeats: Optional[int], kernel: str, smoke: bool, dev,
                where: str) -> Dict:
    repeats = repeats or WARM_REPEATS
    print(f"# warm_start: {kernel} on {WARM_GPU}, {WARM_SOURCE} -> "
          f"{WARM_TARGET}, {WARM_STRATEGY}{', smoke' if smoke else ''}, "
          f"tuner on {where}", flush=True)
    out = warm_start(repeats, kernel=kernel, smoke=smoke, device=dev)
    return {"warm_start": True, "smoke": smoke, **out}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--figure", type=int, choices=sorted({*FIGURES, 4}),
                      help="1, 4, 5, or 6 (Figs. 6-7)")
    what.add_argument("--table", type=int, choices=(1,))
    what.add_argument("--warm-start", action="store_true",
                      help="the store's cross-size warm start")
    ap.add_argument("--smoke", action="store_true",
                    help="with --warm-start: 1 source run, budget 60, at "
                         "most 2 seeds")
    ap.add_argument("--kernel", default=None,
                    help=f"with --warm-start: the simulated kernel "
                         f"(default {WARM_KERNEL}, the reference's)")
    ap.add_argument("--repeats", type=int, default=None,
                    help="seeds (the paper's: 7 for Figs. 1, 4 and 6-7, 5 "
                         "for Fig. 5, Table I and the warm start); random "
                         "search in a figure twice as many")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    if (args.smoke or args.kernel) and not args.warm_start:
        ap.error("--smoke and --kernel go with --warm-start")
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    t0 = time.time()
    if args.warm_start:
        tag, payload = "warm_start", _warm_start(
            args.repeats, args.kernel or WARM_KERNEL, args.smoke, dev, where)
    elif args.table:
        tag, payload = "table1", _table1(args.repeats, dev, where)
    elif args.figure == 4:
        tag, payload = "fig4", _fig4(args.repeats, dev, where)
    else:
        tag = FIGURE_TAGS.get(args.figure, f"fig{args.figure}")
        payload = _figure(args.figure, args.repeats, dev, where)
    wall = time.time() - t0
    print(f"# {tag}: {wall:.1f} s on {where}", flush=True)
    payload = {"device": where, "wall_s": wall, **payload}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1, default=float)
    return payload


if __name__ == "__main__":
    main()
