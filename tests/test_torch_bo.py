"""The port's BO loop against the JAX package's golden traces and spaces.

``tests/golden/seed_traces.json`` pins every strategy's journal on the toy
objective of ``tests/test_engine.py``; the port's ``run_strategy`` +
``make_strategy`` must reproduce the BO entries exactly, on the same space
rebuilt with the port's ``SearchSpace``.
"""
import json
import math
import os

import numpy as np
import pytest

from repro.core.spaces import make_objective as jax_make_objective
from repro.store.records import SpaceFingerprint as JaxFingerprint

from repro_torch.core.objectives import SimulatedObjective
from repro_torch.core.runner import run_strategy
from repro_torch.core.searchspace import Param, SearchSpace
from repro_torch.core.spaces import make_objective
from repro_torch.core.strategies import BOConfig, make_strategy
from repro_torch.store.records import SpaceFingerprint

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "seed_traces.json")
with open(GOLDEN) as f:
    _GOLDEN = json.load(f)


def _toy_objective(seed=0, n=400, invalid_frac=0.2):
    """tests/test_engine.py's toy objective, built from the port's modules."""
    rng = np.random.default_rng(seed)
    space = SearchSpace([Param("a", tuple(range(20))),
                         Param("b", tuple(range(20)))], name="toy")
    x = space.X_norm
    times = 1.0 + 5 * ((x[:, 0] - 0.3) ** 2 + (x[:, 1] - 0.7) ** 2) \
        + 0.3 * np.sin(7 * x[:, 0]) * np.cos(5 * x[:, 1])
    inv = rng.choice(n, int(invalid_frac * n), replace=False)
    times = times.astype(np.float64)
    times[inv] = math.nan
    return SimulatedObjective(space, times, name="toy")


@pytest.mark.parametrize("case", [f"{s}:{seed}" for s in
                                  ("ei", "multi", "advanced_multi")
                                  for seed in (0, 1)])
def test_port_reproduces_golden_bo_traces(case):
    strat, seed = case.rsplit(":", 1)
    res = run_strategy(make_strategy(strat), _toy_objective(), budget=40,
                       seed=int(seed))
    got = [[o.key, None if not math.isfinite(o.value) else o.value, o.af]
           for o in res.journal]
    assert got == _GOLDEN[case]["journal"], f"{case}: journal diverged"
    got_trace = [None if not math.isfinite(v) else v for v in res.trace]
    assert got_trace == _GOLDEN[case]["trace"]
    assert res.unique_evals == _GOLDEN[case]["unique_evals"]


def test_cuda_gp_backend_on_cpu_runs_the_bo_loop():
    """The kernel-backed surrogate (its plain version on the CPU) drives the
    same loop: finite best, full budget, no repeated config."""
    res = run_strategy(make_strategy("advanced_multi", gp_backend="cuda",
                                     gp_block_n=128, gp_device="cpu"),
                       _toy_objective(), budget=40, seed=0)
    keys = [o.key for o in res.journal]
    assert res.unique_evals == 40 and len(keys) == len(set(keys))
    assert math.isfinite(res.best_value)


def test_paper_gemm_space_and_times_match_reference():
    obj = make_objective("gemm", "a100")
    ref = jax_make_objective("gemm", "a100")
    assert obj.space.size == ref.space.size == 17956
    assert obj.space.dim == 15
    np.testing.assert_array_equal(obj.space.value_indices,
                                  ref.space.value_indices)
    np.testing.assert_array_equal(obj.times, ref.times)
    assert (SpaceFingerprint.of(obj.space, objective=obj.name).digest
            == JaxFingerprint.of(ref.space, objective=ref.name).digest)


def test_make_strategy_covers_bo_names_only():
    for name in ("ei", "poi", "lcb", "multi", "advanced_multi"):
        assert make_strategy(name).cfg.acquisition == name
    for name in ("random", "genetic_algorithm", "skopt_gphedge", "nope"):
        with pytest.raises(KeyError):
            make_strategy(name)


def test_unported_pieces_raise():
    with pytest.raises(ValueError, match="jax"):
        run_strategy(make_strategy("ei", engine="jax"), _toy_objective(),
                     budget=25, seed=0)
    with pytest.raises(ValueError, match="GenerativeSpace"):
        SearchSpace([Param(f"p{i}", tuple(range(10))) for i in range(8)],
                    max_enumeration=10_000)
    assert BOConfig().gp_backend == "numpy"
