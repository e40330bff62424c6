"""Ask/tell strategy protocol (DESIGN.md §2).

The seed implementation inverted control the wrong way round: every strategy
owned a blocking ``run(run, rng)`` loop that called ``run.evaluate`` and was
terminated by a ``BudgetExhausted`` exception. That couples strategies to a
strictly sequential evaluator — one compile-and-run per iteration — which the
paper's own conclusion names as the bottleneck.

Here the evaluator drives the strategy instead:

    strategy.reset(ctx)                  # space, budget, rng, replayed journal
    while not done:
        props = strategy.suggest(n)      # <= n proposals, [] = exhausted
        ... evaluate (possibly in parallel, see repro_torch.core.engine) ...
        strategy.observe(prop, value)    # one tell per accepted proposal,
                                         # in acceptance order

Proposals carry either a config index into the restricted space or a raw
config dict (constraint-unaware framework baselines). Observations arrive in
the exact order proposals were accepted, so a strategy that suggests one
config at a time under ``batch_size=1`` sees the identical interaction
sequence the old blocking loop produced — the golden-trace parity tests pin
this down bit-for-bit.

Two idioms are supported:

  * class-based (subclass ``Strategy``): needed for true batch suggestion
    (BO's constant-liar fantasies, GA generations, random permutations);
  * generator-based (subclass ``GeneratorStrategy``): a mechanical port of a
    sequential loop — ``v = run.evaluate(idx, af)`` becomes
    ``v = yield Proposal(idx, af)``. Inherently suggests one config per tell.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Generator, List, Optional, Sequence

import numpy as np

from repro_torch.core.searchspace import SearchSpace


@dataclass(frozen=True)
class Proposal:
    """One requested evaluation: a space index OR a raw config dict."""
    idx: Optional[int] = None
    af: Optional[str] = None
    config: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if (self.idx is None) == (self.config is None):
            raise ValueError("Proposal needs exactly one of idx/config")


@dataclass
class StrategyContext:
    """Everything a strategy may read at reset time."""
    space: SearchSpace
    budget: int
    rng: np.random.Generator
    # journal replayed from a checkpoint: (idx-or-None, value) pairs, in order
    replayed: Sequence = field(default_factory=tuple)


@dataclass(frozen=True)
class WarmObservation:
    """One prior observation mapped into the current space (store layer).

    Exact-fingerprint records carry their original config index; cross-size
    records were nearest-neighbor matched into this space and carry the extra
    GP ``noise`` discounting the mapping (repro_torch.store.transfer).
    """
    x: np.ndarray                # normalized position in the current space
    value: float                 # finite prior observation
    idx: Optional[int]           # matched config index in the current space
    exact: bool                  # same fingerprint: no mapping, no discount
    noise: float = 0.0           # extra GP noise (transfer discount)
    config: Optional[Dict[str, Any]] = None


class Strategy:
    """Ask/tell strategy ABC. Stateful; ``reset`` starts a fresh run."""

    name: str = "strategy"

    def reset(self, ctx: StrategyContext) -> None:
        raise NotImplementedError

    def suggest(self, n: int) -> List[Proposal]:
        """Up to ``n`` proposals. Empty list = strategy exhausted (the engine
        stops once nothing is in flight). Proposals may duplicate earlier
        evaluations — the evaluator serves those from cache."""
        raise NotImplementedError

    def observe(self, proposal: Proposal, value: float) -> None:
        """One tell per accepted proposal, in acceptance order. ``value`` is
        NaN for invalid configurations (they still consumed budget)."""
        raise NotImplementedError

    def warm_start(self, warm: Sequence[WarmObservation]) -> None:
        """Transfer-aware warm start: prior observations matched from the
        tuning-record store, mapped into the current space. Called at most
        once per run, after ``reset`` and before the first ``suggest`` —
        and only when matches exist, so cold-store runs never enter here
        (bit-for-bit identical to no-store runs). Default: ignore priors."""
        return None


class GeneratorStrategy(Strategy):
    """Port of a sequential blocking loop: override ``proposals`` with a
    generator that yields ``Proposal``s and receives observed values.

    ``suggest`` can only ever hand out the single proposal the generator is
    blocked on — the next one does not exist until the value is sent back —
    so these strategies parallelize across *runs*, not within one. That is
    exactly the contract the old ``run(run, rng)`` loops had.
    """

    def proposals(self, ctx: StrategyContext) -> Generator[Proposal, float, None]:
        raise NotImplementedError

    def reset(self, ctx: StrategyContext) -> None:
        self._gen = self.proposals(ctx)
        self._pending: Optional[Proposal] = None
        self._exhausted = False
        self._advance(first=True)

    def _advance(self, first: bool = False, value: float = math.nan):
        try:
            self._pending = (next(self._gen) if first
                             else self._gen.send(value))
        except StopIteration:
            self._pending, self._exhausted = None, True

    def suggest(self, n: int) -> List[Proposal]:
        if self._exhausted or self._pending is None:
            return []
        p, self._pending = self._pending, None
        return [p]

    def observe(self, proposal: Proposal, value: float) -> None:
        if not self._exhausted:
            self._advance(value=value)
