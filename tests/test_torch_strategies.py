"""The port's comparison set against the JAX package: the Kernel Tuner
baselines, the framework analogues, the ``engine="jax"`` BO, the paper's
metrics and the comparison matrix.

The baselines are host-only numpy, so their journals must equal the golden
traces of ``tests/golden/seed_traces.json`` exactly. The frameworks and the
``engine="jax"`` BO pick an argmin/argmax over an fp32 posterior; torch and
XLA round differently in the last bits, so they are held to a live
reference run tie-tolerantly (``_assert_tie_tolerant``), against a float64
posterior computed with numpy and scipy (``posterior64``), which shares no
code with either package. The frameworks' GP (Matérn-5/2 at ℓ=1, snapped
duplicates, imputed penalties) is ill-conditioned: each package's fp32
scores lie up to 2.5e-3 of their scale from float64, so a fixed relative
tolerance near 1e-5 cannot tell a tie from a fault (measured at the first
divergences: the reference's own scores of the two picks 3e-5 to 2e-4 of
their scale apart, 0.01 to 0.14 of its largest fp32 error).
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import repro.core.acquisition as JA
import repro.core.strategies.bo as JBO
import repro.core.strategies.frameworks as JF
from repro.core import metrics as JM
from repro.core.runner import run_strategy as j_run_strategy
from repro.core.strategies import make_strategy as j_make_strategy
from repro.kernels.tuning import default_cells as j_default_cells

import repro_torch.core.acquisition as TA
import repro_torch.core.strategies.bo as TBO
import repro_torch.core.strategies.frameworks as TF
from repro_torch.core import metrics as TM
from repro_torch.core.objectives import SimulatedObjective
from repro_torch.core.runner import TuningRun, run_strategy
from repro_torch.core.searchspace import Param, SearchSpace
from repro_torch.core.spaces import make_objective
from repro_torch.core.strategies import (ALL_BASELINES, ALL_BO,
                                         ALL_FRAMEWORKS, BO_NAMES,
                                         make_strategy)
from repro_torch.kernels.tuning import default_cells
from repro_torch.launch import compare

from tests.test_strategies import _toy_objective as j_toy_objective
from tests.test_torch_bo import _toy_objective
from tests.test_torch_gp64 import posterior64
from tests.test_torch_gp_padded import _assert_parity

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "seed_traces.json")
with open(GOLDEN) as f:
    _GOLDEN = json.load(f)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The padded GP's matrices here are 30 to 70 rows: torch's thread pool
    costs more than it saves, and under parallel test workers it takes
    the cores from each other (the frameworks' budget test: 18 s on one
    thread, 40 s on eight, minutes under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name, **kw):
    """A port strategy with its surrogate on the CPU."""
    if name in ALL_FRAMEWORKS:
        kw.setdefault("device", "cpu")
    elif name in BO_NAMES:
        kw.setdefault("gp_device", "cpu")
    return make_strategy(name, **kw)


# -- baselines: exact -------------------------------------------------------

@pytest.mark.parametrize("case", [f"{s}:{seed}" for s in ALL_BASELINES
                                  for seed in (0, 1)])
def test_baselines_reproduce_golden_traces(case):
    strat, seed = case.rsplit(":", 1)
    res = run_strategy(make_strategy(strat), _toy_objective(), budget=40,
                       seed=int(seed))
    got = [[o.key, None if not math.isfinite(o.value) else o.value, o.af]
           for o in res.journal]
    assert got == _GOLDEN[case]["journal"], f"{case}: journal diverged"
    got_trace = [None if not math.isfinite(v) else v for v in res.trace]
    assert got_trace == _GOLDEN[case]["trace"]
    assert res.unique_evals == _GOLDEN[case]["unique_evals"]


@pytest.mark.parametrize("name", ALL_BASELINES)
def test_baselines_equal_live_reference_on_paper_space(name):
    """On the paper's GTX Titan X GEMM space (17,956 configs, 15 dims), at
    the paper's budget, journal for journal."""
    obj = make_objective("gemm", "gtx_titan_x")
    from repro.core.spaces import make_objective as j_make_objective
    jobj = j_make_objective("gemm", "gtx_titan_x")
    res = run_strategy(make_strategy(name), obj, budget=220, seed=3)
    ref = j_run_strategy(j_make_strategy(name), jobj, budget=220, seed=3)
    assert [(o.key, o.af) for o in res.journal] == \
        [(o.key, o.af) for o in ref.journal]
    np.testing.assert_array_equal(res.trace, ref.trace)


# -- test_strategies.py, on the port ----------------------------------------

@pytest.mark.parametrize("name", list(ALL_BO) + list(ALL_BASELINES)
                         + list(ALL_FRAMEWORKS) + ["poi", "lcb"])
def test_strategy_respects_budget(name):
    res = run_strategy(_port(name), _toy_objective(), budget=60, seed=0)
    assert res.unique_evals <= 60
    assert res.best_idx is None or math.isfinite(res.best_value)


@pytest.mark.parametrize("name", ["ei", "random", "genetic_algorithm"])
def test_never_revisits(name):
    res = run_strategy(_port(name), _toy_objective(invalid_frac=0.3),
                       budget=80, seed=1)
    keys = [o.key for o in res.journal]
    assert len(keys) == len(set(keys)), "revisited a configuration"


def test_budget_counts_unique_not_cached():
    obj = _toy_objective()
    idx = int(np.argmin(np.nan_to_num(obj.times, nan=np.inf)))
    run = TuningRun(obj, budget=10)
    v1 = run.evaluate(idx)
    v2 = run.evaluate(idx)      # cached, no budget consumed
    assert v1 == v2 and math.isfinite(v1)
    assert run.unique_evals == 1


@pytest.mark.parametrize("name", ["ei", "simulated_annealing"])
def test_resume_replays_journal(tmp_path, name):
    obj = _toy_objective()
    ck = str(tmp_path / "tuner.json")
    r1 = run_strategy(_port(name), obj, budget=40, seed=0,
                      checkpoint_path=ck)
    r2 = run_strategy(_port(name), obj, budget=60, seed=0,
                      checkpoint_path=ck, resume=True)
    assert r2.unique_evals <= 60
    assert len(r2.journal) >= len(r1.journal)
    assert [o.key for o in r2.journal[:len(r1.journal)]] == \
        [o.key for o in r1.journal]
    assert r2.best_value <= r1.best_value


def test_framework_bo_wastes_budget_on_infeasible():
    space = SearchSpace([Param("a", (1, 2, 4, 8)), Param("b", (1, 2, 4, 8))],
                        [lambda c: c["a"] * c["b"] <= 8], name="constrained")
    obj = SimulatedObjective(space, np.linspace(1, 2, space.size))
    res = run_strategy(_port("bayesopt_ucb"), obj, budget=30, seed=0)
    assert any(o.idx is None for o in res.journal)


def test_make_strategy_builds_every_reference_name():
    from repro.core import strategies as JS
    assert (ALL_BO, ALL_BASELINES, ALL_FRAMEWORKS) == \
        (JS.ALL_BO, JS.ALL_BASELINES, JS.ALL_FRAMEWORKS)
    for name in ALL_BO + ALL_BASELINES + ALL_FRAMEWORKS:
        assert type(_port(name)).__name__ == \
            type(j_make_strategy(name)).__name__
        assert _port(name).name == j_make_strategy(name).name
    with pytest.raises(KeyError):
        make_strategy("nope")


# -- frameworks and engine="jax": tie-tolerant against a live run ------------

def _host(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.array(a, np.float64)


def _post64(gp, cand):
    """The float64 posterior of a GP's observations at ``cand``, from
    ``posterior64`` (numpy and scipy, no code of either package)."""
    mu, sd, _, y_std, _ = posterior64(
        _host(gp.X), _host(gp.y), _host(gp.mask).astype(bool), cand,
        kernel=gp.kernel, ell=gp.ell, noise=gp.noise)
    return mu, sd, y_std


def _framework_scores(name, A, mu, sigma, f_best, y_std):
    """(argmin|argmax, scores) of each decision the framework's _propose
    makes from one posterior, in the reference's arithmetic order."""
    if name == "bayesopt_ucb":
        return [("min", mu - 2.576 * sigma)]
    return [("max", A.ei_scores(mu, sigma, f_best, 0.01, y_std)),
            ("max", A.poi_scores(mu, sigma, f_best, 0.01, y_std)),
            ("min", mu - 1.96 * sigma)]


def _record_framework(monkeypatch, cls, name, A):
    """Every _propose call: its posterior ("post", fp32, float64), the
    scores of each decision (kind, fp32, float64) and the chosen box
    index ("bidx")."""
    log = []
    orig = cls._propose

    def wrapped(self, gp, box, evaluated, f_best, rng, it):
        seen = []
        pred = gp.predict

        def predict(x):
            out = pred(x)
            if not seen:                 # the 2048-candidate posterior
                seen.append((np.array(x, np.float64),
                             _host(out[0]).astype(np.float32),
                             _host(out[1]).astype(np.float32)))
            return out

        gp.predict = predict
        try:
            bidx = orig(self, gp, box, evaluated, f_best, rng, it)
        finally:
            del gp.predict
        cand, mu, sigma = seen[0]
        mu64, sd64, ys64 = _post64(gp, cand)
        log.append(("post", (mu, sigma), (mu64, sd64)))
        for (kind, s), (_, s64) in zip(
                _framework_scores(name, A, mu, sigma, f_best,
                                  float(gp.state.y_std)),
                _framework_scores(name, A, mu64, sd64, f_best, ys64)):
            log.append((kind, np.asarray(s, np.float64), s64))
        log.append(("bidx", bidx, None))
        return bidx

    monkeypatch.setattr(cls, "_propose", wrapped)
    return log


def _record_bo(monkeypatch, bo_mod, A):
    """Every posterior over the space (engine="jax") and every acquisition
    scoring of it, each beside the same from the float64 posterior of the
    GP's observations."""
    log = []
    last = {}
    orig_predict = bo_mod._EngineAdapter.predict_all
    orig_scores = A.af_scores

    def predict_all(self):
        mu, sigma = orig_predict(self)
        mu64, sd64, _ = last["post64"] = _post64(self.gp, self.X_cand)
        log.append(("post", (_host(mu), _host(sigma)), (mu64, sd64)))
        return mu, sigma

    def af_scores(name, mu, sigma, f_best, explore, y_std):
        s = orig_scores(name, mu, sigma, f_best, explore, y_std)
        mu64, sd64, ys64 = last["post64"]
        s64 = orig_scores(name, mu64, sd64, f_best, explore, ys64)
        log.append(("max", np.asarray(s, np.float64), s64))
        return s

    monkeypatch.setattr(bo_mod._EngineAdapter, "predict_all", predict_all)
    monkeypatch.setattr(A, "af_scores", af_scores)
    return log


def _assert_tie_tolerant(ref_log, port_log, ref, res, n_init):
    """Up to the first decision the two runs take differently, both GPs
    hold the same observations. At each posterior and scoring until then,
    the port must be as accurate as the reference against the float64
    yardstick (``_assert_parity``). At that decision the two picks must be
    a tie for the reference: its own fp32 scores of them differ by no more
    than its fp32 scoring's largest error against float64 over the panel.
    (A bound from the errors at the two picks alone would hold by
    construction: each run's pick maximizes its own scores.)"""
    ref_keys = [o.key for o in ref.journal]
    got_keys = [o.key for o in res.journal]
    assert got_keys[:n_init] == ref_keys[:n_init], \
        "the initial sample (pure numpy) diverged"
    for (kind, a_r, a64), (kind_p, a_p, _) in zip(ref_log, port_log):
        assert kind == kind_p
        if kind == "bidx":
            assert a_r == a_p, ("every decision agreed but the snapped "
                                "proposal differs")
            continue
        if kind == "post":
            for what, r, p, x in zip(("mean", "std"), a_r, a_p, a64):
                _assert_parity(p, r, x, f"posterior {what}")
            continue
        ok = np.isfinite(a64) & np.isfinite(a_r) & np.isfinite(a_p)
        _assert_parity(a_p[ok], a_r[ok], a64[ok], "scores")
        arg = np.argmin if kind == "min" else np.argmax
        i, j = int(arg(a_r)), int(arg(a_p))
        if i == j:
            continue
        err_r = float(np.abs(a_r - a64)[ok].max())
        gap = abs(float(a_r[i]) - float(a_r[j]))
        assert gap <= err_r, (
            f"first divergent pick {i} vs {j} is no tie: the reference "
            f"scores them {gap:.3e} apart, over its own fp32 error "
            f"{err_r:.3e}")
        return "tie"
    assert got_keys == ref_keys, "journals differ with every decision equal"
    return "equal"


@pytest.mark.parametrize("name", ALL_FRAMEWORKS)
@pytest.mark.parametrize("seed", [0, 1])
def test_frameworks_tie_tolerant_against_live_reference(monkeypatch, name,
                                                        seed):
    cls = {"bayesopt_ucb": "UCBSnapBO", "skopt_gphedge": "GPHedgeSnapBO"}
    ref_log = _record_framework(monkeypatch, getattr(JF, cls[name]), name,
                                JA)
    port_log = _record_framework(monkeypatch, getattr(TF, cls[name]), name,
                                 TA)
    ref = j_run_strategy(j_make_strategy(name), j_toy_objective(),
                         budget=30, seed=seed)
    res = run_strategy(_port(name), _toy_objective(), budget=30, seed=seed)
    assert res.unique_evals == ref.unique_evals == 30
    assert ref_log and port_log
    _assert_tie_tolerant(ref_log, port_log, ref, res,
                         n_init=TF.UCBSnapBO.n_init)


@pytest.mark.parametrize("acq", ["ei", "advanced_multi"])
@pytest.mark.parametrize("seed", [0, 1])
def test_jax_engine_bo_tie_tolerant_against_live_reference(monkeypatch, acq,
                                                           seed):
    ref_log = _record_bo(monkeypatch, JBO, JA)
    port_log = _record_bo(monkeypatch, TBO, TA)
    ref = j_run_strategy(j_make_strategy(acq, engine="jax"),
                         j_toy_objective(), budget=30, seed=seed)
    res = run_strategy(_port(acq, engine="jax"), _toy_objective(),
                       budget=30, seed=seed)
    assert len(port_log) == len(ref_log) > 0
    _assert_tie_tolerant(ref_log, port_log, ref, res, n_init=20)
    assert res.unique_evals == ref.unique_evals == 30


def test_jax_engine_bo_pool_mode_matches_reference():
    """Candidate-pool mode on the padded GP: predict_chunked over pools
    that vary in size, the last chunk zero-padded."""
    obj = _toy_objective()
    res = run_strategy(_port("ei", engine="jax", pool_mode="pool",
                             pool_size=64, predict_chunk=100),
                       obj, budget=30, seed=2)
    ref = j_run_strategy(j_make_strategy("ei", engine="jax",
                                         pool_mode="pool", pool_size=64,
                                         predict_chunk=100),
                         j_toy_objective(), budget=30, seed=2)
    keys = [o.key for o in res.journal]
    assert res.unique_evals == 30 and len(keys) == len(set(keys))
    assert keys[:20] == [o.key for o in ref.journal][:20]


# -- metrics ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_reference_on_random_traces(seed):
    rng = np.random.default_rng(seed)
    opt = float(rng.uniform(1, 5))
    traces = [np.minimum.accumulate(opt + rng.exponential(2.0, size=n))
              for n in (220, 150, 30, 0)]
    traces[1][5] = math.nan
    for t in traces:
        a, b = TM.mae(t, opt), JM.mae(t, opt)
        assert (a == b) or (math.isnan(a) and math.isnan(b))
        for target in (opt + 0.5, opt + 3.0, opt - 1.0):
            assert TM.evals_to_match(t, target, 220) == \
                JM.evals_to_match(t, target, 220)
    assert TM.mean_mae(traces[:3], opt) == JM.mean_mae(traces[:3], opt)
    per_kernel = {f"k{k}": {f"s{s}": float(rng.uniform(0.1, 10))
                            for s in range(5)} for k in range(3)}
    per_kernel["k1"]["s2"] = math.nan
    # json: NaN entries compare equal as text
    assert json.dumps(TM.mdf_table(per_kernel)) == \
        json.dumps(JM.mdf_table(per_kernel))
    d = {"a": 1.0, "b": 0.0, "c": math.inf}
    assert TM.deviation_factors(d) == JM.deviation_factors(d)


# -- the comparison matrix and the kernel cells -----------------------------

def test_compare_matrix_equals_reference_run_matrix():
    """launch/compare.run_matrix on the CPU is the reference's
    benchmarks/common.run_matrix: the baselines' and the numpy BO's MAEs
    bit for bit, on a cut matrix (one kernel, budget 60)."""
    from benchmarks import common
    strategies = ("ei", "random", "mls", "genetic_algorithm")
    got = compare.run_matrix(("pnpoly",), "gtx_titan_x", strategies, 2,
                             budget=60, random_repeats=3, device="cpu")
    want = common.run_matrix(("pnpoly",), "gtx_titan_x", strategies, 2,
                             budget=60, random_repeats=3, workers=1,
                             batch_size=1, store=None)
    for s in strategies:
        g, w = got["pnpoly"][s], want["pnpoly"][s]
        assert g["traces"] == w["traces"], s
        assert (g["mean_mae"], g["best_final"]) == \
            (w["mean_mae"], w["best_final"])
        assert g["tuner_ms_per_eval"] >= 0
    assert compare.mdf_from_matrix(got) == common.mdf_from_matrix(want)


def test_compare_cli_on_cpu_prints_reference_rows(capsys, monkeypatch):
    monkeypatch.setattr(compare, "KERNELS", ("pnpoly",))
    monkeypatch.setitem(compare.FIGURES, 5,
                        ("rtx_2070_super", ("random", "skopt_gphedge"), 1))
    out = compare.main(["--figure", "5", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "fig5/pnpoly/random," in text and "mae=" in text
    assert "fig5/mdf/skopt_gphedge,0.0,mdf=" in text
    assert out["device"] == "cpu" and set(out["mdf"]) == {"random",
                                                         "skopt_gphedge"}


def test_strategy_kwargs_put_surrogates_on_the_device():
    assert compare.strategy_kwargs("ei", "cuda") == {
        "gp_backend": "cuda", "gp_device": "cuda"}
    assert compare.strategy_kwargs("skopt_gphedge", "cuda") == {
        "device": "cuda"}
    assert compare.strategy_kwargs("mls", "cuda") == {}
    assert compare.strategy_kwargs("ei", "cpu") == {"gp_device": "cpu"}


@pytest.mark.parametrize("smoke", [True, False])
def test_default_cells_have_the_reference_shapes(smoke):
    got = [(c.kernel, c.shape_sig, c.default.keys())
           for c in default_cells(smoke, device="cpu")]
    want = [(c.kernel, c.shape_sig, c.default.keys())
            for c in j_default_cells(smoke)]
    assert got == want
