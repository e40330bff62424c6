"""The paper's strategy comparisons (Figs. 1 and 5) on the port.

    PYTHONPATH=src python -m repro_torch.launch.compare --figure 1|5 \
        [--repeats N] [--device cuda|cpu] [--out PATH]

Port of the reference's ``benchmarks/common.py::run_matrix`` and
``mdf_from_matrix`` and of the kernel and strategy lists of
``benchmarks/fig1_comparison.py`` (BO against Kernel Tuner's baselines,
GTX Titan X spaces) and ``fig5_frameworks.py`` (BO against the
BayesianOptimization and scikit-optimize analogues, RTX 2070 Super spaces).
Each (kernel, strategy) runs ``repeats`` seeds (random search twice as
many, at least 10) of the paper's 220 evaluations over the simulated
spaces and reports the paper's MAE, and each strategy its MDF over the
three kernels. Cut: the reference's worker/batch parallelism and store
journaling (every run here is the sequential paper loop, unjournaled).

On the card (the default) BO's surrogate runs on the hand-written GP kernel
(``gp_backend="cuda"``) and the frameworks' padded GP on the card; with
``--device cpu`` the matrix is the reference's (numpy GP; the frameworks'
GP on the CPU). The objectives are simulated, so MAE and MDF depend on the
card only through the GP's arithmetic. It prints the reference's
``fig<N>/<kernel>/<strategy>,<us per run>,mae=`` and ``fig<N>/mdf/...``
rows and writes nothing unless ``--out`` names a JSON file.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import mae, mdf_table
from repro_torch.core.runner import run_strategy
from repro_torch.core.spaces import make_objective
from repro_torch.core.strategies import (ALL_FRAMEWORKS, BO_NAMES,
                                         make_strategy)
from repro_torch.core.strategies.base import Strategy
from repro_torch.kernels.tuning import resolve_device

KERNELS = ("gemm", "convolution", "pnpoly")
#: figure -> (the paper's GPU whose spaces it runs, strategies, repeats)
FIGURES = {
    1: ("gtx_titan_x", ("advanced_multi", "multi", "ei", "genetic_algorithm",
                        "mls", "simulated_annealing", "random"), 7),
    5: ("rtx_2070_super", ("advanced_multi", "multi", "ei", "bayesopt_ucb",
                           "skopt_gphedge", "random"), 5),
}


def strategy_kwargs(name: str, device) -> Dict:
    """``make_strategy`` arguments that put a strategy's surrogate on
    ``device``: BO's GP kernel (and the ``jax`` engine's padded GP) on the
    card, the frameworks' padded GP on ``device``; the baselines have none."""
    dev = torch.device(device)
    if name in BO_NAMES:
        return ({"gp_backend": "cuda", "gp_device": str(dev)}
                if dev.type == "cuda" else {"gp_device": "cpu"})
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


def run_matrix(kernels: Sequence[str], gpu: str, strategies: Sequence[str],
               repeats: int, budget: int = 220,
               random_repeats: Optional[int] = None,
               device=None) -> Dict:
    """Per (kernel, strategy): traces + mean MAE (paper methodology), plus
    the tuner's own milliseconds per proposal."""
    dev = resolve_device(device)
    out: Dict[str, Dict[str, Dict]] = {}
    for kernel in kernels:
        obj = make_objective(kernel, gpu)
        out[kernel] = {}
        for strat in strategies:
            reps = (random_repeats or repeats) if strat == "random" else repeats
            traces, times, tuner_ms = [], [], []
            for seed in range(reps):
                s = TimedStrategy(make_strategy(strat,
                                                **strategy_kwargs(strat, dev)))
                t0 = time.time()
                res = run_strategy(s, obj, budget=budget, seed=seed,
                                   warm_start=False)
                times.append(time.time() - t0)
                traces.append(res.trace)
                tuner_ms.append(1e3 * s.seconds / max(s.proposals, 1))
            maes = [mae(t, obj.optimum) for t in traces]
            out[kernel][strat] = {
                "mean_mae": float(np.mean(maes)),
                "std_mae": float(np.std(maes)),
                "mean_wall_s": float(np.mean(times)),
                "tuner_ms_per_eval": float(np.mean(tuner_ms)),
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


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--figure", type=int, choices=sorted(FIGURES),
                    required=True)
    ap.add_argument("--repeats", type=int, default=None,
                    help="seeds per strategy (the paper's: 7 for Fig. 1, "
                         "5 for Fig. 5); random search twice as many")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    gpu, strategies, paper_repeats = FIGURES[args.figure]
    repeats = args.repeats or paper_repeats
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"# fig{args.figure}: {gpu} spaces, {repeats} repeats "
          f"(random {max(repeats * 2, 10)}), tuner on {where}", flush=True)
    t0 = time.time()
    matrix = run_matrix(KERNELS, gpu, strategies, repeats,
                        random_repeats=max(repeats * 2, 10), device=dev)
    wall = time.time() - t0
    mdf = mdf_from_matrix(matrix)
    tag = f"fig{args.figure}"
    for kernel, d in matrix.items():
        for strat, v in d.items():
            print(f"{tag}/{kernel}/{strat},{v['mean_wall_s'] * 1e6:.1f},"
                  f"mae={v['mean_mae']:.4f}"
                  f" tuner_ms_per_eval={v['tuner_ms_per_eval']:.3f}")
    for strat, v in mdf.items():
        print(f"{tag}/mdf/{strat},0.0,mdf={v['mdf']:.4f}±{v['std']:.3f}")
    print(f"# {tag}: {wall:.1f} s on {where}", flush=True)
    payload = {"figure": args.figure, "device": where, "repeats": repeats,
               "wall_s": wall, "matrix": strip_traces(matrix), "mdf": mdf}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1, default=float)
    return payload


if __name__ == "__main__":
    main()
