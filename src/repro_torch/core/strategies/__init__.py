"""Search strategies of the port: the paper's BO in ask/tell form
(base.Strategy), driven by repro_torch.core.engine.ParallelTuningEngine.

Cut from this port: the Kernel Tuner baselines (random, simulated
annealing, MLS, genetic algorithm) and the BayesOpt/scikit-optimize
framework analogues; ``make_strategy`` raises ``KeyError`` for their names
as it does for any unknown name."""
from repro_torch.core.strategies.base import (GeneratorStrategy, Proposal,
                                              Strategy, StrategyContext)
from repro_torch.core.strategies.bo import BOConfig, BOStrategy

ALL_BO = ("ei", "poi", "lcb", "multi", "advanced_multi")


def make_strategy(name: str, **kw):
    """BO strategy by acquisition name; ``kw`` are ``BOConfig`` fields."""
    if name in ALL_BO:
        return BOStrategy(BOConfig(acquisition=name, **kw))
    raise KeyError(f"unknown strategy {name!r}")
