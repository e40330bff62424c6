"""Other-framework BO analogues (paper §IV-D), ask/tell generator ports.

The paper compares against the BayesianOptimization and scikit-optimize
packages, whose defaults (a) cannot express search-space constraints — they
model the full Cartesian box — and (b) optimize the acquisition over a
continuous relaxation and SNAP to the grid, exactly the failure mode §III-D1
warns about (duplicate suggestions, distorted surrogate). Invalid/infeasible
evaluations are imputed with a large penalty — distorting the surrogate
(§III-D2) — because these frameworks must fit *something*.

  * UCBSnapBO  ≈ BayesianOptimization defaults: UCB(κ=2.576)
  * GPHedgeSnapBO ≈ scikit-optimize defaults: GP-Hedge over (EI ξ=0.01,
    PI ξ=0.01, LCB κ=1.96), softmax gains

These propose raw config dicts (``Proposal(config=...)``): the evaluator maps
them back into the restricted space where possible and records NaN otherwise,
so infeasible proposals waste budget — the paper's explanation for these
frameworks' poor showing.

Port of ``repro/core/strategies/frameworks.py``, whole, on the port's padded
torch GP (``repro_torch.core.gp``), which runs on ``device``: the card unless
the caller passes ``"cpu"``. Candidate draws stay on the strategy's numpy
``rng``, so they are the reference's draw for draw; the GP's posterior comes
back to the host as fp32 numpy, as the reference's does.
"""
from __future__ import annotations

import math
from typing import Generator, List, Optional, Tuple

import numpy as np

from repro_torch.core import acquisition as A
from repro_torch.core.gp import GP
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.strategies.base import (GeneratorStrategy, Proposal,
                                              StrategyContext)


def _unrestricted(space: SearchSpace) -> SearchSpace:
    """The Cartesian box (restrictions dropped), as these frameworks see it."""
    return SearchSpace(space.params, (), name=space.name + "_box")


def _host(mu_sigma) -> Tuple[np.ndarray, np.ndarray]:
    """A GP's (mean, std) tensors as fp32 numpy arrays on the host."""
    return tuple(t.cpu().numpy() for t in mu_sigma)


class _SnapBOBase(GeneratorStrategy):
    n_init: int = 20
    penalty_quantile: float = 0.99

    def __init__(self, device: Optional[str] = None):
        self.name = "framework_bo"
        self.device = device

    def _propose(self, gp: GP, box: SearchSpace, evaluated: np.ndarray,
                 f_best: float, rng: np.random.Generator, it: int) -> int:
        raise NotImplementedError

    def proposals(self, ctx: StrategyContext) -> Generator[Proposal, float, None]:
        rng = ctx.rng
        box = _unrestricted(ctx.space)
        # continuous-snap duplicates make the kernel matrix singular — the
        # frameworks survive via jitter, so use a larger noise term here
        gp = GP(box.dim, max_obs=ctx.budget + 8, kernel="matern52", ell=1.0,
                noise=1e-4, device=self.device)
        self.gp = gp          # the last run's surrogate, for inspection
        evaluated = np.zeros(box.size, dtype=bool)
        values: List[float] = []

        def observe(bidx: int, v: float):
            evaluated[bidx] = True
            if math.isfinite(v):
                values.append(v)
                gp.add(box.X_norm[bidx], v)
            else:
                # constraint-unaware frameworks impute a penalty — the
                # surrogate distortion the paper describes
                pen = (np.quantile(values, self.penalty_quantile) * 2.0
                       if values else 1e6)
                gp.add(box.X_norm[bidx], float(pen))

        for _ in range(self.n_init):
            bidx = box.random_index(rng)
            if evaluated[bidx]:
                continue
            v = yield Proposal(config=box.config(bidx), af=self.name)
            observe(bidx, v)

        it = 0
        while True:
            it += 1
            gp.fit()
            f_best = min(values) if values else 1e6
            bidx = self._propose(gp, box, evaluated, f_best, rng, it)
            v = yield Proposal(config=box.config(bidx), af=self.name)
            observe(bidx, v)


class UCBSnapBO(_SnapBOBase):
    """BayesianOptimization-like: UCB κ=2.576, continuous argmax + snap."""

    def __init__(self, kappa: float = 2.576, device: Optional[str] = None):
        super().__init__(device)
        self.kappa = kappa
        self.name = "bayesopt_ucb"

    def _propose(self, gp, box, evaluated, f_best, rng, it):
        # continuous optimization emulated by dense random restarts + local
        # refinement, then SNAP to the grid (duplicates possible -> they
        # repeatedly hit the cache, wasting their iteration, like the paper
        # observes for these frameworks)
        cand = rng.random((2048, box.dim)).astype(np.float32)
        mu, sigma = _host(gp.predict(cand))
        scores = mu - self.kappa * sigma
        x = cand[int(np.argmin(scores))]
        return box.nearest_index(x)


class GPHedgeSnapBO(_SnapBOBase):
    """scikit-optimize-like GP-Hedge portfolio with softmax gains."""

    def __init__(self, eta: float = 1.0, device: Optional[str] = None):
        super().__init__(device)
        self.eta = eta
        self.gains = np.zeros(3)
        self.name = "skopt_gphedge"

    def reset(self, ctx: StrategyContext) -> None:
        self.gains = np.zeros(3)   # fresh hedge state per run
        super().reset(ctx)

    def _propose(self, gp, box, evaluated, f_best, rng, it):
        cand = rng.random((2048, box.dim)).astype(np.float32)
        mu, sigma = _host(gp.predict(cand))
        y_std = float(gp.state.y_std) if gp.state is not None else 1.0
        props = [
            int(np.argmax(A.ei_scores(mu, sigma, f_best, 0.01, y_std))),
            int(np.argmax(A.poi_scores(mu, sigma, f_best, 0.01, y_std))),
            int(np.argmin(mu - 1.96 * sigma)),
        ]
        self.gains = np.nan_to_num(self.gains, nan=0.0, posinf=0.0, neginf=0.0)
        p = np.exp(self.eta * (self.gains - self.gains.max()))
        s = p.sum()
        p = p / s if np.isfinite(s) and s > 0 else np.full(3, 1 / 3)
        k = int(rng.choice(3, p=p))
        x = cand[props[k]]
        # hedge gain update: negative posterior mean at the chosen point
        mu_k, _ = gp.predict(x[None, :])
        g = -float(mu_k[0])
        if np.isfinite(g):
            self.gains[k] += g
        return box.nearest_index(x)
