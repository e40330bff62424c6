"""Search strategies: the paper's BO + Kernel Tuner baselines + framework
analogues. All implement the ask/tell protocol (base.Strategy); they are
driven by repro_torch.core.engine.ParallelTuningEngine, never run
standalone. Port of ``repro/core/strategies/__init__.py``, whole: the same
names build the same strategies."""
from repro_torch.core.strategies.base import (GeneratorStrategy, Proposal,
                                              Strategy, StrategyContext)
from repro_torch.core.strategies.baselines import (GeneticAlgorithm,
                                                   MultiStartLocalSearch,
                                                   RandomSearch,
                                                   SimulatedAnnealing)
from repro_torch.core.strategies.bo import BOConfig, BOStrategy
from repro_torch.core.strategies.frameworks import GPHedgeSnapBO, UCBSnapBO


#: the names that build a BOStrategy, one per acquisition
BO_NAMES = ("ei", "poi", "lcb", "multi", "advanced_multi")


def make_strategy(name: str, **kw):
    """Factory used by benchmarks/examples/CLI. ``kw`` are ``BOConfig``
    fields for the BO names, constructor arguments otherwise (the
    frameworks take ``device`` for their GP)."""
    if name in BO_NAMES:
        return BOStrategy(BOConfig(acquisition=name, **kw))
    table = {
        "random": RandomSearch,
        "simulated_annealing": SimulatedAnnealing,
        "mls": MultiStartLocalSearch,
        "genetic_algorithm": GeneticAlgorithm,
        "bayesopt_ucb": UCBSnapBO,
        "skopt_gphedge": GPHedgeSnapBO,
    }
    if name not in table:
        raise KeyError(f"unknown strategy {name!r}")
    return table[name](**kw)


ALL_BO = ("ei", "multi", "advanced_multi")
ALL_BASELINES = ("random", "simulated_annealing", "mls", "genetic_algorithm")
ALL_FRAMEWORKS = ("bayesopt_ucb", "skopt_gphedge")
