"""Acquisition functions + the paper's novel selection mechanisms (§III-C/F/G).

Basic AFs (minimization variants): EI, POI, LCB. All return scores where
HIGHER = more desirable; the suggestion is argmax over *unevaluated* configs.

Contextual Variance (§III-F): scale-independent dynamic exploration factor for
minimization,  λ = (σ̄² / (μ_s / f(x⁺))) / σ̄²_s  — proportional to the current
mean posterior variance, inversely proportional to the achieved improvement
over the initial-sample mean, normalized by the post-initial-sample variance.

`multi` / `advanced multi` (§III-G): round-robin portfolios that skip or
promote AFs based on a discounted-observation score
    dos_t = Σ_i o_i · γ^(t-i)
(we use the recency-weighted *mean* — normalized by Σ γ^(t-i) — so AFs with
different usage counts stay comparable; the paper is ambiguous here, see
DESIGN.md §7). Invalid observations contribute the median of valid
observations to the dos (advanced multi, per the paper).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SQRT2 = math.sqrt(2.0)


def _phi(z):   # standard normal pdf
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _Phi(z):   # standard normal cdf (vectorized erf; no scipy in this env)
    return 0.5 * (1.0 + _np_erf(z / _SQRT2))


def _np_erf(x):
    # Abramowitz & Stegun 7.1.26, max abs err ~1.5e-7 — fine for acquisition
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def ei_scores(mu, sigma, f_best, xi: float, y_std: float = 1.0):
    """Expected improvement (minimization), standardized for scale freedom."""
    s = np.maximum(sigma / max(y_std, 1e-12), 1e-12)
    imp = (f_best - mu) / max(y_std, 1e-12) - xi
    z = imp / s
    return imp * _Phi(z) + s * _phi(z)


def poi_scores(mu, sigma, f_best, xi: float, y_std: float = 1.0):
    s = np.maximum(sigma / max(y_std, 1e-12), 1e-12)
    imp = (f_best - mu) / max(y_std, 1e-12) - xi
    return _Phi(imp / s)


def lcb_scores(mu, sigma, lam: float, y_std: float = 1.0):
    """Lower confidence bound; higher score = lower bound (minimization)."""
    return -(mu - lam * sigma)


AF_ORDER_DEFAULT = ("ei", "poi", "lcb")


def af_scores(name: str, mu, sigma, f_best, explore: float, y_std: float = 1.0):
    if name == "ei":
        return ei_scores(mu, sigma, f_best, explore, y_std)
    if name == "poi":
        return poi_scores(mu, sigma, f_best, explore, y_std)
    if name == "lcb":
        return lcb_scores(mu, sigma, max(explore, 0.0) if explore else 1.0, y_std)
    raise ValueError(name)


def contextual_variance(sigma: np.ndarray, f_best: float, mu_s: float,
                        var_s: float) -> float:
    """λ per §III-F (minimization form). All quantities in raw y units."""
    mean_var = float(np.mean(np.square(sigma)))
    if var_s <= 0 or f_best == 0:
        return 0.01
    ratio = mu_s / f_best if f_best > 0 else 1.0
    if ratio <= 0:
        ratio = 1.0
    lam = (mean_var / ratio) / var_s
    return float(max(lam, 0.0))


def batch_contextual_variance(sigma: np.ndarray, evaluated: np.ndarray,
                              pending: np.ndarray, f_best: float, mu_s: float,
                              var_s: float) -> float:
    """Contextual Variance for batch/async suggestion (DESIGN.md §4).

    During constant-liar batch construction, configs already holding a fantasy
    observation (``pending``) are no longer exploration targets: their
    posterior variance has been collapsed by the speculative GP update, and
    counting them in the mean posterior variance would bias λ downward —
    every fantasy would make the remaining batch members greedier. Exclude
    both evaluated and pending configs, exactly as the sequential path
    excludes evaluated ones; ``sigma`` must come from the fantasy-updated GP
    so λ reflects the variance that actually remains on the table.
    """
    free = ~(np.asarray(evaluated, bool) | np.asarray(pending, bool))
    if not np.any(free):
        return 0.01
    return contextual_variance(sigma[free], f_best, mu_s, var_s)


def pool_contextual_variance(sigma_pool: np.ndarray, f_best: float,
                             mu_s: float, var_s: float) -> float:
    """Contextual Variance from a candidate pool (DESIGN.md §10).

    In pool mode the full-space posterior is never computed, so the mean
    posterior variance in §III-F is *estimated* from the pool. The pool's
    stratified-random component keeps the estimate representative of the
    unevaluated space; incumbent-neighborhood members bias σ̄² slightly
    downward (they sit near observations), which only makes λ a little more
    conservative. ``sigma_pool`` must already exclude evaluated/pending
    configs — pools are built that way — matching the sequential path's
    exclusion of evaluated ones. ``var_s`` must come from the same estimator
    at initial-sample time (a stratified draw scored once) so the ratio
    λ = (σ̄²/ratio)/σ̄²_s compares like with like."""
    if sigma_pool.size == 0:
        return 0.01
    return contextual_variance(sigma_pool, f_best, mu_s, var_s)


@dataclass
class AFStats:
    name: str
    observations: List[float] = field(default_factory=list)
    dup_count: int = 0
    worse_count: int = 0
    better_count: int = 0
    active: bool = True

    def dos(self, discount: float, median_valid: float) -> float:
        """Recency-weighted mean of this AF's observations (lower = better)."""
        if not self.observations:
            return math.inf
        num = den = 0.0
        t = len(self.observations)
        for i, o in enumerate(self.observations, start=1):
            w = discount ** (t - i)
            v = median_valid if (o is None or not math.isfinite(o)) else o
            num += v * w
            den += w
        return num / den if den > 0 else math.inf


class MultiAcquisition:
    """The paper's `multi` and `advanced multi` controllers.

    mode="multi": one shared GP prediction per iteration; every active AF
    nominates its argmax; duplicate nominations increment dup counters; past
    `skip_threshold`, conflicting AFs are pitted and only the best-dos one
    survives. The evaluating AF rotates round-robin.

    mode="advanced": no duplicate-avoidance predictions — AFs are judged
    directly on dos. An AF whose dos is `improvement_factor` worse than the
    mean for `skip_threshold` consecutive judgments is skipped (others'
    counters reset); one that is `improvement_factor` better is PROMOTED to
    sole AF for the rest of the run.
    """

    def __init__(self, mode: str = "advanced",
                 order: Sequence[str] = AF_ORDER_DEFAULT,
                 skip_threshold: int = 5,
                 improvement_factor: float = 0.1,
                 discount: Optional[float] = None):
        assert mode in ("multi", "advanced")
        self.mode = mode
        self.afs = [AFStats(n) for n in order]
        self.skip_threshold = skip_threshold
        self.improvement_factor = improvement_factor
        self.discount = discount if discount is not None else (
            0.75 if mode == "advanced" else 0.65)
        self._rr = 0
        self.valid_observations: List[float] = []

    # -- round robin --------------------------------------------------------
    def active_afs(self) -> List[AFStats]:
        return [a for a in self.afs if a.active]

    def next_af(self) -> AFStats:
        act = self.active_afs()
        af = act[self._rr % len(act)]
        self._rr += 1
        return af

    # -- recording ----------------------------------------------------------
    def _median_valid(self) -> float:
        return float(np.median(self.valid_observations)) if self.valid_observations else 0.0

    def record(self, af: AFStats, value: Optional[float], valid: bool):
        af.observations.append(value if valid else math.nan)
        if valid and value is not None and math.isfinite(value):
            self.valid_observations.append(value)
        if self.mode == "advanced":
            self._judge()

    def register_duplicates(self, nominations: Dict[str, int]):
        """mode="multi": nominations maps AF name -> suggested config index."""
        if self.mode != "multi":
            return
        by_idx: Dict[int, List[str]] = {}
        for name, idx in nominations.items():
            by_idx.setdefault(idx, []).append(name)
        conflict_sets = [names for names in by_idx.values() if len(names) > 1]
        for names in conflict_sets:
            for a in self.afs:
                if a.name in names and a.active:
                    a.dup_count += 1
        # pit AFs whose counter exceeded the threshold
        med = self._median_valid()
        for names in conflict_sets:
            group = [a for a in self.afs
                     if a.name in names and a.active and a.dup_count > self.skip_threshold]
            if len(group) > 1:
                best = min(group, key=lambda a: a.dos(self.discount, med))
                for a in group:
                    if a is not best:
                        a.active = False
        if not self.active_afs():  # never kill everything
            self.afs[0].active = True

    def _judge(self):
        act = self.active_afs()
        if len(act) <= 1:
            return
        med = self._median_valid()
        doses = {a.name: a.dos(self.discount, med) for a in act}
        finite = [v for v in doses.values() if math.isfinite(v)]
        if not finite:
            return
        mean_dos = float(np.mean(finite))
        if mean_dos == 0:
            return
        for a in act:
            d = doses[a.name]
            if not math.isfinite(d):
                continue
            # minimization: dos ABOVE mean by `improvement_factor` = worse
            if d > mean_dos * (1.0 + self.improvement_factor):
                a.worse_count += 1
                a.better_count = 0
            elif d < mean_dos * (1.0 - self.improvement_factor):
                a.better_count += 1
                a.worse_count = 0
            else:
                a.worse_count = 0
                a.better_count = 0
        # skips first: removing a loser resets everyone's counters (paper:
        # "...will be skipped and the counts of others reset"), so a
        # promotion must re-earn its streak against the remaining AFs.
        skipped = False
        for a in act:
            if a.worse_count >= self.skip_threshold and len(self.active_afs()) > 1:
                a.active = False
                skipped = True
        if skipped:
            for b in self.afs:
                b.worse_count = 0
                b.better_count = 0
            return
        for a in act:
            if a.better_count >= self.skip_threshold:
                for b in self.afs:
                    b.active = b is a   # promotion to sole AF
                break
