"""Kernel Tuner baseline strategies the paper compares against (§IV-B).

Random Search, Simulated Annealing, Multi-start Local Search, and a Genetic
Algorithm — the best-performing non-BO strategies in Kernel Tuner on the test
kernels. All operate on Hamming neighborhoods of the restricted space and see
invalid configurations as failed evaluations (consuming budget).

Port of ``repro/core/strategies/baselines.py``, whole: host-only numpy
over the port's ``SearchSpace`` neighbourhoods, so a run's journal is the
reference's bit for bit.

Ask/tell ports (DESIGN.md §2): Random Search and the GA are naturally
batchable — a random permutation is embarrassingly parallel, and a GA
generation's fitness evaluations are independent — so they subclass
``Strategy`` directly and hand the engine up to ``n`` configs at once. SA and
MLS are inherently sequential chains (each move depends on the previous
observation), so they are mechanical generator ports: ``run.evaluate`` became
``yield Proposal`` and nothing else changed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Generator, List

import numpy as np

from repro_torch.core.strategies.base import (GeneratorStrategy, Proposal,
                                              Strategy, StrategyContext)


class RandomSearch(Strategy):
    name = "random"

    def reset(self, ctx: StrategyContext) -> None:
        self._order = ctx.rng.permutation(ctx.space.size)
        self._pos = 0

    def suggest(self, n: int) -> List[Proposal]:
        out = [Proposal(int(idx), af="random")
               for idx in self._order[self._pos:self._pos + n]]
        self._pos += len(out)
        return out

    def observe(self, proposal: Proposal, value: float) -> None:
        pass


@dataclass
class SimulatedAnnealing(GeneratorStrategy):
    """Kernel Tuner-style SA: Hamming neighbor moves, geometric cooling."""

    t0: float = 1.0
    t_min: float = 1e-3
    alpha: float = 0.985
    name: str = "simulated_annealing"

    def proposals(self, ctx: StrategyContext) -> Generator[Proposal, float, None]:
        space, rng = ctx.space, ctx.rng
        cur = space.random_index(rng)
        cur_v = yield Proposal(cur, af="sa")
        guard_restarts = 0
        while not math.isfinite(cur_v) and guard_restarts < 1000:
            guard_restarts += 1
            cur = space.random_index(rng)
            cur_v = yield Proposal(cur, af="sa")
        T = self.t0
        scale = max(abs(cur_v), 1e-9) if math.isfinite(cur_v) else 1.0
        while True:
            nbrs = space.hamming_neighbors(cur)
            if not nbrs:
                cur = space.random_index(rng)
                cur_v = yield Proposal(cur, af="sa")
                continue
            cand = int(nbrs[rng.integers(len(nbrs))])
            cand_v = yield Proposal(cand, af="sa")
            accept = False
            if math.isfinite(cand_v):
                if not math.isfinite(cur_v) or cand_v < cur_v:
                    accept = True
                else:
                    delta = (cand_v - cur_v) / scale
                    accept = rng.random() < math.exp(-delta / max(T, 1e-9))
            if accept:
                cur, cur_v = cand, cand_v
            T = max(T * self.alpha, self.t_min)


@dataclass
class MultiStartLocalSearch(GeneratorStrategy):
    """Greedy best-improvement hill-climbing on Hamming neighborhoods,
    restarted from random configs until the budget runs out."""

    name: str = "mls"

    def proposals(self, ctx: StrategyContext) -> Generator[Proposal, float, None]:
        space, rng = ctx.space, ctx.rng
        while True:
            cur = space.random_index(rng)
            cur_v = yield Proposal(cur, af="mls")
            if not math.isfinite(cur_v):
                continue
            improved = True
            while improved:
                improved = False
                best_n, best_v = None, cur_v
                for n in space.hamming_neighbors(cur):
                    v = yield Proposal(int(n), af="mls")
                    if math.isfinite(v) and v < best_v:
                        best_n, best_v = int(n), v
                if best_n is not None:
                    cur, cur_v = best_n, best_v
                    improved = True


@dataclass
class GeneticAlgorithm(Strategy):
    """Tournament GA with uniform crossover and per-gene mutation.

    One generation's fitness evaluations are independent, so ``suggest``
    hands out the whole current population; breeding happens in ``observe``
    once the last fitness of the generation lands (observation order is the
    engine's acceptance order, so the rng stream matches the sequential
    implementation exactly).
    """

    pop_size: int = 20
    mutation_rate: float = 0.1
    tournament: int = 3
    elitism: int = 2
    name: str = "genetic_algorithm"

    def reset(self, ctx: StrategyContext) -> None:
        self.space, self.rng = ctx.space, ctx.rng
        self.nvals = [len(p.values) for p in ctx.space.params]
        self.pop: List[int] = [ctx.space.random_index(ctx.rng)
                               for _ in range(self.pop_size)]
        self.fit: List[float] = []
        self._queued = 0

    def suggest(self, n: int) -> List[Proposal]:
        out: List[Proposal] = []
        while len(out) < n and self._queued < len(self.pop):
            out.append(Proposal(self.pop[self._queued], af="ga"))
            self._queued += 1
        return out

    def observe(self, proposal: Proposal, value: float) -> None:
        self.fit.append(value if math.isfinite(value) else math.inf)
        if len(self.fit) == self.pop_size:
            self._breed()

    def _tournament_pick(self) -> int:
        best, best_f = None, math.inf
        for _ in range(self.tournament):
            j = int(self.rng.integers(self.pop_size))
            if self.fit[j] <= best_f:
                best, best_f = self.pop[j], self.fit[j]
        return best if best is not None else self.pop[0]

    def _breed(self) -> None:
        space, rng = self.space, self.rng
        order = np.argsort(self.fit)
        new_pop = [self.pop[i] for i in order[:self.elitism]]
        while len(new_pop) < self.pop_size:
            p1 = space.value_indices[self._tournament_pick()]
            p2 = space.value_indices[self._tournament_pick()]
            mask = rng.random(space.dim) < 0.5
            child = np.where(mask, p1, p2).astype(np.int64)
            for g in range(space.dim):
                if rng.random() < self.mutation_rate:
                    child[g] = rng.integers(self.nvals[g])
            idx = space.index_of_value_indices(child)
            if idx is None:
                # repair: nearest valid config to the infeasible child
                x = child / np.array([max(n - 1, 1) for n in self.nvals])
                idx = space.nearest_index(x.astype(np.float32))
            new_pop.append(int(idx))
        self.pop = new_pop
        self.fit = []
        self._queued = 0
