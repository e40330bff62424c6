"""Evaluation metrics from the paper (§IV-A).

Port of ``repro/core/metrics.py``, whole: pure numpy, nothing cut.

MAE: mean absolute error of the best-found value vs the global optimum,
sampled at function evaluations 40, 60, ..., 220 (the first evaluations are
noise/initial-sample dominated):  MAE = (1/10) Σ_{i=2..11} |f(x⁺_{20i}) - f(x')|

MDF (Mean Deviation Factor): per kernel, mean MAE across repeats divided by
the mean of mean-MAEs of all strategies on that kernel — comparable across
kernels with different scales; the paper reports the mean over kernels.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


def mae(trace: np.ndarray, optimum: float, checkpoints: Sequence[int] = tuple(
        range(40, 221, 20))) -> float:
    """trace[i] = best-so-far after i+1 unique evaluations."""
    errs = []
    for c in checkpoints:
        i = min(c, len(trace)) - 1
        if i < 0:
            continue
        v = trace[i]
        errs.append(abs(v - optimum) if math.isfinite(v) else abs(10 * optimum))
    return float(np.mean(errs)) if errs else math.nan


def mean_mae(traces: List[np.ndarray], optimum: float) -> float:
    return float(np.mean([mae(t, optimum) for t in traces]))


def deviation_factors(mean_maes: Dict[str, float]) -> Dict[str, float]:
    """Per-strategy MAE / mean-over-strategies, for one kernel."""
    vals = [v for v in mean_maes.values() if math.isfinite(v)]
    denom = float(np.mean(vals)) if vals else 1.0
    if denom == 0:
        denom = 1.0
    return {k: v / denom for k, v in mean_maes.items()}


def mdf_table(per_kernel: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """per_kernel[kernel][strategy] = mean MAE → MDF mean/std per strategy."""
    strategies = sorted({s for d in per_kernel.values() for s in d})
    factors: Dict[str, List[float]] = {s: [] for s in strategies}
    for kernel, d in per_kernel.items():
        dev = deviation_factors(d)
        for s in strategies:
            if s in dev and math.isfinite(dev[s]):
                factors[s].append(dev[s])
    return {s: {"mdf": float(np.mean(v)) if v else math.nan,
                "std": float(np.std(v)) if v else math.nan,
                "n_kernels": len(v)}
            for s, v in factors.items()}


def evals_to_match(trace: np.ndarray, target: float, max_evals: int) -> int:
    """First unique-evaluation count at which trace <= target (Fig. 4)."""
    for i, v in enumerate(trace[:max_evals]):
        if math.isfinite(v) and v <= target:
            return i + 1
    return max_evals + 1
