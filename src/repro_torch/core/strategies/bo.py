"""The paper's Bayesian Optimization search strategy (§III), ask/tell form.

Structure (paper's contributions all present):
  * discrete normalized search space; acquisition optimized ONLY over
    not-yet-evaluated configs by exhaustive prediction (no BFGS);
  * invalid observations consume budget but are never fitted to the GP;
  * maximin-LHS initial sample with random repair of invalid draws;
  * Matérn-3/2 GP, fixed lengthscale 2.0 (1.5 under contextual variance);
  * exploration factor: constant or Contextual Variance;
  * acquisition: ei | poi | lcb | multi | advanced_multi (Table I defaults).

Beyond the paper (DESIGN.md §3–4): ``suggest(n)`` with n > 1 builds a batch
by kriging-believer fantasies — each pick is speculatively added to the GP at
its posterior mean, the acquisition is re-scored, and the speculative
observations are rolled back once the batch is out the door. In-flight
configs (suggested earlier, not yet observed) are fantasized the same way, so
asynchronous engines never get duplicate suggestions and the batch spreads
out instead of piling onto one optimum. At ``batch_size=1`` no speculation
happens and the interaction sequence is bit-for-bit the sequential paper
loop (pinned by the golden-trace tests).

Candidate-pool mode (DESIGN.md §10): above ``pool_threshold`` configs the
exhaustive per-iteration prediction is replaced by scoring a pool of
incumbent neighborhoods + stratified random draws + a periodic LHS refresh,
with the GP predicting only at pool points (chunked, no (max_obs, N)
panel). Small spaces keep the full-space path untouched, so paper-parity
results are unchanged.

Port notes: the surrogate's posterior can run on the card through the
hand-written CUDA Matérn-GP kernel (``gp_backend="cuda"``). The reference's
``engine="jax"`` branch (its padded jit GP, ``repro/core/gp.py``) is cut
until that module is ported: ``engine="jax"`` raises.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import acquisition as A
from repro_torch.core.gp_fast import IncrementalGP
from repro_torch.core.lhs import initial_sample, lhs_unit
from repro_torch.core.strategies.base import Proposal, Strategy, StrategyContext


@dataclass(frozen=True)
class BOConfig:
    acquisition: str = "advanced_multi"   # ei|poi|lcb|multi|advanced_multi
    kernel: str = "matern32"
    lengthscale: float = 2.0
    lengthscale_cv: float = 1.5
    exploration: object = "cv"            # "cv" or a float
    initial_samples: int = 20
    maximin: bool = True
    skip_threshold: int = 5
    improvement_factor: float = 0.1
    discount: Optional[float] = None      # None -> per-mode Table I default
    af_order: Sequence[str] = ("ei", "poi", "lcb")
    noise: float = 1e-6
    # "fast": incremental-Cholesky exact GP (beyond-paper, ~100x less work);
    # "jax" (the reference's padded jit GP) is not ported and raises
    engine: str = "fast"
    # -- self-hosted posterior scoring (DESIGN.md §14) -----------------------
    # "numpy" | "cuda": backend for the §III-G exhaustive prediction loop;
    # "cuda" runs it through the hand-written matern_gp kernel on the card
    # (on ``gp_device``, default the card), block_n ideally from the
    # kernel-tuning store (tuned_gp_block_n)
    gp_backend: str = "numpy"
    gp_block_n: int = 512
    gp_device: Optional[str] = None
    # -- candidate-pool acquisition (DESIGN.md §10) --------------------------
    pool_mode: str = "auto"               # "auto" | "full" | "pool"
    pool_threshold: int = 100_000         # auto: pool above this many configs
    pool_size: int = 2048                 # stratified random draws per round
    pool_incumbents: int = 3              # best-k whose neighborhoods join
    pool_lhs_every: int = 16              # LHS refresh cadence (rounds)
    pool_lhs_points: int = 64
    # -- surrogate-guided pool seeding (DESIGN.md §15) -----------------------
    # after warmup, a slice of each round's pool comes from coordinate-
    # exchange refinement of the GP's top-k posterior-mean incumbents; each
    # exchange step is validated by the space's per-dimension pruner
    # (axis_exchange), never by rejection draws
    pool_refine_topk: int = 3             # posterior-mean incumbents refined
    pool_refine_steps: int = 2            # exchange sweeps per incumbent
    pool_refine_max: int = 256            # refined-candidate cap per round
    # -- transfer-aware warm start (DESIGN.md §11) ---------------------------
    warm_topk: int = 5                    # prior best configs re-evaluated first
    warm_min_init: int = 3                # LHS floor kept under warm priors

    def pool_active(self, space_size: int) -> bool:
        return (self.pool_mode == "pool"
                or (self.pool_mode == "auto"
                    and space_size > self.pool_threshold))


def _stratified_indices(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """m draws, one uniform per equal-width stratum of [0, n) — spreads
    coverage over the enumeration order (and so over the leading params)."""
    m = min(m, n)
    edges = np.linspace(0, n, m + 1).astype(np.int64)
    return rng.integers(edges[:-1], np.maximum(edges[1:], edges[:-1] + 1))


class _SparseFlags:
    """Set-backed stand-in for a dense boolean flag array.

    The generative backend keys configs by mixed-radix code over grids with
    10^9+ cells; ``np.zeros(space.size, bool)`` would be gigabytes for a
    handful of set flags. Supports exactly the access patterns BOStrategy
    uses — scalar get/set, fancy-index get, ``sum()``, and enumeration of
    the set indices (sorted, matching ``np.flatnonzero`` semantics).
    """

    __slots__ = ("_set",)

    def __init__(self):
        self._set: set = set()

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return int(key) in self._set
        key = np.asarray(key)
        if not self._set:
            return np.zeros(key.shape, bool)
        return np.isin(key, np.fromiter(self._set, np.int64,
                                        count=len(self._set)))

    def __setitem__(self, key, value):
        if value:
            self._set.add(int(key))
        else:
            self._set.discard(int(key))

    def sum(self) -> int:
        return len(self._set)

    def indices(self) -> np.ndarray:
        if not self._set:
            return np.zeros(0, np.int64)
        return np.sort(np.fromiter(self._set, np.int64, count=len(self._set)))


def _flag_indices(flags) -> np.ndarray:
    """Set indices of a dense bool array or a _SparseFlags, sorted."""
    if isinstance(flags, _SparseFlags):
        return flags.indices()
    return np.flatnonzero(flags)


class _EngineAdapter:
    """Uniform .add / .predict_all / .predict_at / .y_std / .mark /
    .rollback over the GP engine. ``X_cand=None`` selects candidate-pool
    mode: no fixed candidate panel, prediction only at requested points."""

    def __init__(self, cfg: BOConfig, X_cand: Optional[np.ndarray],
                 max_obs: int, ell: float, dim: Optional[int] = None):
        if cfg.engine != "fast":
            raise ValueError(
                f"BOConfig.engine={cfg.engine!r}: only the 'fast' engine is "
                "ported; the padded jit GP behind 'jax' (core/gp.py) is not")
        self.gp = IncrementalGP(X_cand, max_obs=max_obs, kernel=cfg.kernel,
                                ell=ell, noise=cfg.noise, dim=dim,
                                backend=cfg.gp_backend,
                                block_n=cfg.gp_block_n, device=cfg.gp_device)

    def add(self, x, y, extra_noise: float = 0.0):
        self.gp.add(x, y, extra_noise)

    def mark(self):
        self.gp.mark()

    def rollback(self):
        self.gp.rollback()

    def predict_all(self):
        return self.gp.predict()

    def predict_at(self, X: np.ndarray):
        return self.gp.predict_at(X)

    @property
    def y_std(self) -> float:
        return self.gp.y_std


class BOStrategy(Strategy):
    def __init__(self, cfg: BOConfig = BOConfig(), name: Optional[str] = None):
        self.cfg = cfg
        self.name = name or f"bo_{cfg.acquisition}"

    # -- lifecycle ----------------------------------------------------------
    def reset(self, ctx: StrategyContext) -> None:
        cfg = self.cfg
        self.space = ctx.space
        self.rng = ctx.rng
        self._budget = ctx.budget
        ell = (cfg.lengthscale_cv if cfg.exploration == "cv"
               else cfg.lengthscale)
        # the generative backend has no dense candidate panel at all, so it
        # is always pool-mode regardless of the configured threshold
        self.pool_on = cfg.pool_active(ctx.space.size) or ctx.space.generative
        if self.pool_on:
            # no fixed candidate panel: an (max_obs, N) V matrix over a
            # multi-million-config space would not fit in memory
            self.gp = _EngineAdapter(cfg, None, max_obs=ctx.budget, ell=ell,
                                     dim=ctx.space.dim)
        else:
            self.gp = _EngineAdapter(cfg, ctx.space.X_norm, max_obs=ctx.budget,
                                     ell=ell)
        if ctx.space.generative:
            self.evaluated = _SparseFlags()
            self.pending = _SparseFlags()                    # in flight
        else:
            self.evaluated = np.zeros(ctx.space.size, dtype=bool)
            self.pending = np.zeros(ctx.space.size, dtype=bool)  # in flight
        self.f_best = math.inf
        self.controller: Optional[A.MultiAcquisition] = None
        self.mu_s = 0.0
        self.var_s = 0.0
        self._finite_obs: List[Tuple[float, int]] = []   # (value, idx)
        self._round = 0

        # resume support: absorb any journal replayed into the run
        replayed_vals: List[float] = []
        for idx, value in ctx.replayed:
            if idx is not None:
                self._absorb(int(idx), value)
            if math.isfinite(value):
                replayed_vals.append(value)

        self.n_init = max(cfg.initial_samples - int(self.evaluated.sum()), 0)
        self.init_vals: List[float] = []
        self._repair_guard = 0
        self._init_outstanding = 0
        if self.n_init > 0:
            self._phase = "init"
            self._init_queue = deque(
                initial_sample(ctx.space, self.n_init, ctx.rng,
                               maximin=cfg.maximin))
        else:
            self._phase = "init"      # finalized on first suggest()
            self._init_queue = deque()
            self.init_vals = replayed_vals

    def _absorb(self, idx: int, value: float):
        self.evaluated[idx] = True
        self.pending[idx] = False
        if math.isfinite(value):
            self.gp.add(self.space.X_norm[idx], value)
            self._finite_obs.append((value, idx))
            if value < self.f_best:
                self.f_best = value

    # -- transfer-aware warm start (DESIGN.md §11) --------------------------
    def warm_start(self, warm) -> None:
        """Prior store records into the surrogate + prior top-k into the
        initial sample.

        The GP is rebuilt with capacity for the priors and told every warm
        observation at its matched position — exact-fingerprint records at
        full weight, cross-size records with their transfer-discount noise —
        so the first acquisition round already knows the prior landscape.
        The best ``warm_topk`` prior configs are evaluated first (replacing
        LHS draws), and the budget-free priors shrink the LHS phase down to
        ``warm_min_init``: that is where the measured 30%+ evaluation saving
        on unseen scenarios comes from (benchmarks/warm_start.py)."""
        cfg = self.cfg
        warm = [w for w in warm
                if w.idx is not None and not self.evaluated[w.idx]]
        if not warm:
            return
        ell = (cfg.lengthscale_cv if cfg.exploration == "cv"
               else cfg.lengthscale)
        max_obs = self._budget + len(warm)
        if self.pool_on:
            self.gp = _EngineAdapter(cfg, None, max_obs=max_obs, ell=ell,
                                     dim=self.space.dim)
        else:
            self.gp = _EngineAdapter(cfg, self.space.X_norm, max_obs=max_obs,
                                     ell=ell)
        for w in warm:
            self.gp.add(w.x, float(w.value), extra_noise=float(w.noise))
        # re-absorb replayed real observations into the rebuilt surrogate
        for v, i in self._finite_obs:
            self.gp.add(self.space.X_norm[i], v)
        if self._phase == "init" and self._init_queue:
            seeds: List[int] = []
            for w in sorted(warm, key=lambda w: (not w.exact, w.value)):
                if w.idx not in seeds:
                    seeds.append(w.idx)
                if len(seeds) >= cfg.warm_topk:
                    break
            lhs_keep = max(
                max(cfg.warm_min_init, self.n_init - len(warm)) - len(seeds),
                0)
            kept = [i for i in list(self._init_queue)
                    if i not in seeds][:lhs_keep]
            self._init_queue = deque(seeds + kept)
            self.n_init = len(self._init_queue)

    def _finalize_init(self):
        """Initial sample complete: fix μ_s, σ̄²_s, build the AF controller."""
        cfg = self.cfg
        if not self.init_vals:  # pathological space: no valid init found
            self.init_vals = [1.0]
        self.mu_s = float(np.mean(self.init_vals))
        if self.pool_on:
            # σ̄²_s estimated on a stratified draw — the same estimator every
            # later pool round uses, so the contextual-variance ratio is
            # like-for-like (acquisition.pool_contextual_variance)
            probe = self._pool_strata(max(self.cfg.pool_size, 256))
            _, sigma0 = self.gp.predict_at(self.space.X_norm[probe])
        else:
            _, sigma0 = self.gp.predict_all()
        self.var_s = float(np.mean(np.square(np.asarray(sigma0))))
        if cfg.acquisition in ("multi", "advanced_multi"):
            self.controller = A.MultiAcquisition(
                mode="advanced" if cfg.acquisition == "advanced_multi"
                else "multi",
                order=cfg.af_order, skip_threshold=cfg.skip_threshold,
                improvement_factor=cfg.improvement_factor,
                discount=cfg.discount)
        self._phase = "bo"

    # -- ask ----------------------------------------------------------------
    def suggest(self, n: int) -> List[Proposal]:
        if self._phase == "init":
            props = self._suggest_init(n)
            if props or self._phase == "init":
                return props
            # fell through to bo on this very call
        if self.pool_on:
            return self._suggest_bo_pool(n)
        return self._suggest_bo(n)

    def _suggest_init(self, n: int) -> List[Proposal]:
        out: List[Proposal] = []
        while len(out) < n and self._init_queue:
            idx = int(self._init_queue.popleft())
            self.pending[idx] = True
            self._init_outstanding += 1
            out.append(Proposal(idx, af="init"))
        # paper: replace invalid draws with random samples until all valid.
        # Only once every earlier init proposal is observed do we know how
        # many repairs are still owed (invalid draws in flight may yet fail).
        if not out and self._init_outstanding == 0:
            need = self.n_init - len(self.init_vals)
            while (len(out) < min(n, max(need, 0))
                   and self._repair_guard < 20 * self.n_init):
                self._repair_guard += 1
                idx = self.space.random_index(self.rng)
                if self.evaluated[idx] or self.pending[idx]:
                    continue
                self.pending[idx] = True
                self._init_outstanding += 1
                out.append(Proposal(int(idx), af="init"))
            if not out:  # init done (or guard exhausted) -> switch phase
                self._finalize_init()
        return out

    def _suggest_bo(self, n: int) -> List[Proposal]:
        cfg = self.cfg
        out: List[Proposal] = []
        in_flight = np.flatnonzero(self.pending)
        speculate = n > 1 or in_flight.size > 0
        if speculate:
            self.gp.mark()
            if in_flight.size:
                # fantasize in-flight configs at their posterior mean so an
                # async engine never gets the same suggestion twice
                mu0, _ = self.gp.predict_all()
                for i in in_flight:
                    self.gp.add(self.space.X_norm[i], float(mu0[i]))
        try:
            for j in range(n):
                blocked = self.evaluated | self.pending
                if blocked.all():
                    break
                mu, sigma = self.gp.predict_all()
                f_best = self.f_best if math.isfinite(self.f_best) else self.mu_s
                y_std = self.gp.y_std

                if cfg.exploration == "cv":
                    if speculate:
                        explore = A.batch_contextual_variance(
                            np.asarray(sigma), self.evaluated, self.pending,
                            f_best, self.mu_s, self.var_s)
                    else:
                        explore = A.contextual_variance(
                            sigma[~self.evaluated], f_best, self.mu_s,
                            self.var_s)
                else:
                    explore = float(cfg.exploration)

                def pick(af_name: str) -> int:
                    scores = A.af_scores(af_name, mu, sigma, f_best, explore,
                                         y_std)
                    scores = np.where(blocked, -np.inf, scores)
                    return int(np.argmax(scores))

                controller = self.controller
                if controller is None:
                    af_name = cfg.acquisition
                    idx = pick(af_name)
                elif controller.mode == "multi":
                    noms = {a.name: pick(a.name)
                            for a in controller.active_afs()}
                    controller.register_duplicates(noms)
                    af = controller.next_af()
                    af_name = af.name
                    idx = noms.get(af.name, pick(af.name))
                else:  # advanced multi: only the evaluating AF predicts
                    af = controller.next_af()
                    af_name = af.name
                    idx = pick(af.name)

                self.pending[idx] = True
                out.append(Proposal(idx, af=af_name))
                if j < n - 1:
                    # kriging-believer fantasy for the remaining picks
                    self.gp.add(self.space.X_norm[idx], float(mu[idx]))
        finally:
            if speculate:
                self.gp.rollback()
        return out

    # -- ask, candidate-pool mode (DESIGN.md §10) ---------------------------
    def _pool_strata(self, m: int) -> np.ndarray:
        """Stratified coverage draws: dense positions on the enumerated
        backend, feasible codes (rejection-sampled per stratum) on the
        generative one."""
        if self.space.generative:
            return self.space.stratified_feasible(self.rng, m)
        return _stratified_indices(self.space.size, m, self.rng)

    def _refine_pool(self) -> Optional[np.ndarray]:
        """Coordinate-exchange refinement of the GP's top-k posterior-mean
        incumbents (ROADMAP "interaction-aware seed"). Each incumbent is
        walked one axis at a time: the move set comes from the space's
        ``axis_exchange`` — on the generative backend that is the
        constraint-propagating per-dimension pruner, so no rejection draws
        happen even on tightly-constrained grids — and the walk steps to
        the candidate with the best posterior mean. Every candidate the GP
        scored joins the pool (the interaction-aware slice), capped at
        ``pool_refine_max``."""
        cfg, space = self.cfg, self.space
        if (cfg.pool_refine_topk <= 0 or self._phase != "bo"
                or not self._finite_obs):
            return None
        obs = sorted({int(i) for _, i in self._finite_obs})
        mu_obs, _ = self.gp.predict_at(space.X_norm[np.asarray(obs, np.int64)])
        order = np.argsort(mu_obs)[:cfg.pool_refine_topk]
        out: List[int] = []
        seen: set = set()
        for k in order:
            idx, cur_mu = obs[int(k)], float(mu_obs[int(k)])
            for _ in range(max(cfg.pool_refine_steps, 1)):
                moved = False
                for j in self.rng.permutation(space.dim):
                    cands = space.axis_exchange(idx, int(j))
                    if not cands:
                        continue
                    mu_c, _ = self.gp.predict_at(
                        space.X_norm[np.asarray(cands, np.int64)])
                    for c in cands:
                        if c not in seen and len(out) < cfg.pool_refine_max:
                            seen.add(c)
                            out.append(int(c))
                    b = int(np.argmin(mu_c))
                    if float(mu_c[b]) < cur_mu:
                        idx, cur_mu = int(cands[b]), float(mu_c[b])
                        moved = True
                if not moved or len(out) >= cfg.pool_refine_max:
                    break
            if len(out) >= cfg.pool_refine_max:
                break
        return np.asarray(out, np.int64) if out else None

    def _build_pool(self) -> np.ndarray:
        """Pool = incumbent Hamming neighborhoods + coordinate-exchange
        refinement of the GP's top posterior-mean incumbents + stratified
        random draws (+ periodic LHS refresh), minus evaluated/pending
        configs."""
        cfg, space, rng = self.cfg, self.space, self.rng
        parts: List[np.ndarray] = []
        if self._finite_obs and cfg.pool_incumbents > 0:
            for _, i in heapq.nsmallest(cfg.pool_incumbents, self._finite_obs):
                nbrs = space.hamming_neighbors(int(i))
                if nbrs:
                    parts.append(np.asarray(nbrs, np.int64))
        refined = self._refine_pool()
        if refined is not None and refined.size:
            parts.append(refined)
        parts.append(self._pool_strata(cfg.pool_size))
        if (cfg.pool_lhs_points > 0
                and self._round % max(cfg.pool_lhs_every, 1) == 0):
            pts = lhs_unit(cfg.pool_lhs_points, space.dim, rng,
                           maximin_tries=1)
            parts.append(space.nearest_indices(pts))
        pool = np.unique(np.concatenate(parts))
        pool = pool[~(self.evaluated[pool] | self.pending[pool])]
        if pool.size == 0:
            if space.generative:
                # no dense free-set to fall back on: draw fresh feasible
                # codes and keep whatever is not already tried/in flight
                cand = np.unique(space.sample_feasible(rng, cfg.pool_size))
                pool = cand[~(self.evaluated[cand] | self.pending[cand])]
            else:
                free = np.flatnonzero(~(self.evaluated | self.pending))
                if free.size:
                    pool = rng.choice(free,
                                      size=min(cfg.pool_size, free.size),
                                      replace=False)
        return pool

    def _suggest_bo_pool(self, n: int) -> List[Proposal]:
        """Mirror of ``_suggest_bo`` that scores a candidate pool instead of
        the whole space. All indices below are pool-local until mapped."""
        cfg = self.cfg
        out: List[Proposal] = []
        self._round += 1
        pool = self._build_pool()
        if pool.size == 0:
            return out
        Xp = self.space.X_norm[pool]
        in_flight = _flag_indices(self.pending)
        speculate = n > 1 or in_flight.size > 0
        if speculate:
            self.gp.mark()
            if in_flight.size:
                mu0, _ = self.gp.predict_at(self.space.X_norm[in_flight])
                for k, i in enumerate(in_flight):
                    self.gp.add(self.space.X_norm[i], float(mu0[k]))
        try:
            alive = np.ones(pool.size, dtype=bool)
            for j in range(n):
                if not alive.any():
                    break
                mu, sigma = self.gp.predict_at(Xp)
                f_best = self.f_best if math.isfinite(self.f_best) else self.mu_s
                y_std = self.gp.y_std

                if cfg.exploration == "cv":
                    explore = A.pool_contextual_variance(
                        sigma[alive], f_best, self.mu_s, self.var_s)
                else:
                    explore = float(cfg.exploration)

                def pick(af_name: str) -> int:
                    scores = A.af_scores(af_name, mu, sigma, f_best, explore,
                                         y_std)
                    scores = np.where(alive, scores, -np.inf)
                    return int(np.argmax(scores))

                controller = self.controller
                if controller is None:
                    af_name = cfg.acquisition
                    k = pick(af_name)
                elif controller.mode == "multi":
                    noms = {a.name: pick(a.name)
                            for a in controller.active_afs()}
                    controller.register_duplicates(
                        {name: int(pool[k2]) for name, k2 in noms.items()})
                    af = controller.next_af()
                    af_name = af.name
                    k = noms.get(af.name, pick(af.name))
                else:  # advanced multi: only the evaluating AF predicts
                    af = controller.next_af()
                    af_name = af.name
                    k = pick(af.name)

                idx = int(pool[k])
                self.pending[idx] = True
                alive[k] = False
                out.append(Proposal(idx, af=af_name))
                if j < n - 1:
                    # kriging-believer fantasy for the remaining picks
                    self.gp.add(self.space.X_norm[idx], float(mu[k]))
        finally:
            if speculate:
                self.gp.rollback()
        return out

    # -- tell ---------------------------------------------------------------
    def observe(self, proposal: Proposal, value: float) -> None:
        idx = proposal.idx
        if idx is None:
            return
        self._absorb(idx, value)
        if proposal.af == "init":
            self._init_outstanding = max(self._init_outstanding - 1, 0)
            if math.isfinite(value):
                self.init_vals.append(value)
        elif self.controller is not None:
            af = next((a for a in self.controller.afs
                       if a.name == proposal.af), None)
            if af is not None:
                self.controller.record(af, value, math.isfinite(value))
