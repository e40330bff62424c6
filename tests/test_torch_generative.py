"""The port's ``GenerativeSpace`` against the reference's, on the CPU.

The generative backend is host-only numpy, so the port must agree with the
reference exactly: every validity verdict, every neighbour set, every
``sample_feasible``/``stratified_feasible`` draw byte for byte for a seed
(the sampler's short-circuit order, its EWMA state and its dead-end memo
all feed the RNG stream), ``nearest_index(es)``, ``axis_exchange`` and the
store fingerprint. That includes the wide MoE sharding spaces, which the
port could not build before (their cartesian products are 9.0e7 and
1.1e9). Pool-mode BO on a generative space with the numpy backend is pure
numpy too, so its journal equals the reference's.
"""
import itertools
import math

import numpy as np
import pytest

from repro.core import searchspace as JS
from repro.core.objectives import CallableObjective as JCallableObjective
from repro.core.runner import run_strategy as j_run_strategy
from repro.core.strategies import make_strategy as j_make_strategy
from repro.core.tuning_targets import sharding_space as j_sharding_space
from repro.store.records import SpaceFingerprint as JFingerprint

from repro_torch.core import searchspace as TS
from repro_torch.core.objectives import CallableObjective
from repro_torch.core.runner import run_strategy
from repro_torch.core.strategies import make_strategy
from repro_torch.core.tuning_targets import sharding_space
from repro_torch.store.records import SpaceFingerprint, TuningRecordStore

from tests.test_searchspace import random_constrained_case

MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")


def _twins(params, cons, name="twin", cls="GenerativeSpace", **kw):
    """The same problem as a port space and as a reference space. Vector
    constraints are rebuilt with each package's own class."""
    out = []
    for mod in (TS, JS):
        ps = [mod.Param(p.name, tuple(p.values)) for p in params]
        cs = [mod.VectorConstraint(c.fn, c.name)
              if isinstance(c, (TS.VectorConstraint, JS.VectorConstraint))
              else c for c in cons]
        out.append(getattr(mod, cls)(ps, cs, name=name, **kw))
    return tuple(out)


def _tight():
    params = [JS.Param(f"p{j}", tuple(range(8))) for j in range(4)]
    return params, [JS.VectorConstraint(
        lambda c: (c["p0"] * c["p1"]) % 11 == 1)]


def _huge():
    """6 params of 32 values: cartesian 1.07e9, half of it feasible."""
    params = [JS.Param(f"p{j}", tuple(range(32))) for j in range(6)]
    return params, [JS.VectorConstraint(
        lambda c: (c["p0"] + c["p1"]) % 2 == 0)]


def _needle():
    """A 1e9 grid with a feasible fraction near 7e-9: rejection raises,
    the routed sampler propagates."""
    params = [JS.Param(f"p{k}", tuple(range(1, 33))) for k in range(6)]
    cons = [JS.VectorConstraint(
                lambda c: (c["p0"] * 33 + c["p1"]) % 1024 < 2, "t01"),
            JS.VectorConstraint(
                lambda c: (c["p2"] * 33 + c["p3"]) % 1024 < 2, "t23"),
            JS.VectorConstraint(
                lambda c: (c["p4"] * 33 + c["p5"]) % 1024 < 2, "t45")]
    return params, cons


def _force_propagation(*spaces):
    for s in spaces:
        s._accept_ewma = 0.0


# -- construction -----------------------------------------------------------

def test_search_space_redirects_above_max_enumeration():
    params = [TS.Param(f"p{j}", tuple(range(10))) for j in range(4)]
    s = TS.SearchSpace(params, max_enumeration=1000)
    assert isinstance(s, TS.GenerativeSpace)
    assert s.generative and s.size == s.cartesian_size == 10_000
    small = TS.SearchSpace(params[:2])
    assert type(small) is TS.SearchSpace and not small.generative
    with pytest.raises(ValueError, match="overflows int64"):
        TS.GenerativeSpace([TS.Param(f"p{j}", tuple(range(256)))
                            for j in range(8)])


def test_unsupported_dense_surface_raises():
    gen = TS.GenerativeSpace([TS.Param("a", (1, 2)),
                              TS.Param("b", (1, 2, 3))])
    with pytest.raises(AttributeError):
        gen.value_indices
    with pytest.raises(NotImplementedError):
        gen.take(np.array([0]))
    with pytest.raises(TypeError):
        gen.X_norm[0:5]
    assert gen.x_norm_lazy and len(gen.X_norm) == gen.cartesian_size


# -- small spaces: verdicts, neighbours, coordinates -------------------------

@pytest.mark.parametrize("seed", range(8))
def test_verdicts_neighbours_and_rows_equal_reference(seed):
    params, cons = random_constrained_case(seed)
    gen, ref = _twins(params, cons, name=f"par{seed}")
    codes = np.arange(gen.cartesian_size, dtype=np.int64)
    np.testing.assert_array_equal(gen._feasible_mask(codes),
                                  ref._feasible_mask(codes))
    np.testing.assert_array_equal(gen.X_norm[codes], ref.X_norm[codes])
    for g, ords in enumerate(itertools.product(
            *[range(len(p.values)) for p in params])):
        cfg = {p.name: p.values[o] for p, o in zip(params, ords)}
        assert gen.index_of(cfg) == ref.index_of(cfg)
        assert gen._find_code(g) == ref._find_code(g)
        if ref._find_code(g) is not None:
            assert gen.config(g) == ref.config(g)
            assert gen.hamming_neighbors(g) == ref.hamming_neighbors(g)
            assert gen.adjacent_neighbors(g) == ref.adjacent_neighbors(g)
            for j in range(gen.dim):
                assert gen.axis_exchange(g, j) == ref.axis_exchange(g, j)


@pytest.mark.parametrize("seed", range(4))
def test_enumerated_port_agrees_with_generative_port(seed):
    """The port's two backends agree on the feasible set (through codes)."""
    params, cons = random_constrained_case(seed)
    enum, _ = _twins(params, cons, name=f"en{seed}", cls="SearchSpace")
    gen, _ = _twins(params, cons, name=f"en{seed}")
    codes = enum.value_indices.astype(np.int64) @ enum._strides
    mask = gen._feasible_mask(np.arange(gen.cartesian_size, dtype=np.int64))
    np.testing.assert_array_equal(np.flatnonzero(mask), codes)


# -- draws: byte for byte -----------------------------------------------------

@pytest.mark.parametrize("which", ["tight", "huge", "random3", "random5"])
@pytest.mark.parametrize("propagate", [False, True])
def test_draws_byte_identical_to_reference(which, propagate):
    if which.startswith("random"):
        params, cons = random_constrained_case(int(which[-1]))
    else:
        params, cons = {"tight": _tight, "huge": _huge}[which]()
    gen, ref = _twins(params, cons, name=which)
    if propagate:
        _force_propagation(gen, ref)
    for seed in (0, 7):
        for fn, m in (("sample_feasible", 97), ("stratified_feasible", 33)):
            got = getattr(gen, fn)(np.random.default_rng(seed), m)
            want = getattr(ref, fn)(np.random.default_rng(seed), m)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{fn} {seed}")
        rg, rr = np.random.default_rng(seed), np.random.default_rng(seed)
        assert [gen.random_index(rg) for _ in range(5)] == \
            [ref.random_index(rr) for _ in range(5)]
    # the sampler's state after the same calls: EWMA, counters, memo
    assert gen._accept_ewma == ref._accept_ewma
    assert (gen._accept_draws, gen._accept_hits, gen._prop_draws) == \
        (ref._accept_draws, ref._accept_hits, ref._prop_draws)
    assert list(gen._dead_prefixes) == list(ref._dead_prefixes)
    assert gen.feasible_fraction_interval() == ref.feasible_fraction_interval()
    assert gen.describe() == ref.describe()


def test_needle_space_propagates_like_the_reference():
    """At a feasible fraction near 7e-9 pure rejection raises in both, and
    the routed sampler's propagated draws are the reference's, code for
    code (the verdict of the reference's timing test, without its clock)."""
    params, cons = _needle()
    gen, ref = _twins(params, cons, name="needle")
    assert gen.feasible_fraction_interval() == ref.feasible_fraction_interval()
    got = gen.sample_feasible(np.random.default_rng(0), 4)
    want = ref.sample_feasible(np.random.default_rng(0), 4)
    np.testing.assert_array_equal(got, want)
    assert gen._feasible_mask(got).all() and gen._prop_draws >= 4
    legacy, _ = _twins(params, cons, name="needle-legacy")
    legacy.PROPAGATE_BELOW = -1.0          # pin pure rejection
    with pytest.raises(ValueError, match="feasible"):
        legacy.sample_feasible(np.random.default_rng(0), 4)


def test_failed_sample_restores_accept_ewma_like_reference():
    params = [JS.Param("a", (1, 2, 3)), JS.Param("b", (1, 2, 3))]
    gen, ref = _twins(params, [lambda c: c["a"] > 100], name="sticky")
    for s in (gen, ref):
        with pytest.raises(ValueError, match="feasible"):
            s.sample_feasible(np.random.default_rng(0), 4)
    assert gen._accept_ewma == ref._accept_ewma == 1.0
    assert gen._accept_draws == ref._accept_draws


# -- nearest points ------------------------------------------------------------

@pytest.mark.parametrize("which", ["tight", "huge"])
def test_nearest_equal_reference(which):
    params, cons = {"tight": _tight, "huge": _huge}[which]()
    gen, ref = _twins(params, cons, name=which)
    pts = np.random.default_rng(5).random((40, gen.dim), dtype=np.float32)
    np.testing.assert_array_equal(gen.nearest_indices(pts, chunk=7),
                                  ref.nearest_indices(pts, chunk=7))
    for row in pts[:12]:
        assert gen.nearest_index(row) == ref.nearest_index(row)
    code = int(gen.sample_feasible(np.random.default_rng(1), 1)[0])
    x = gen.X_norm[code]
    assert gen.nearest_index(x) == ref.nearest_index(x) == code
    assert gen.nearest_index(x, exclude={code}) == \
        ref.nearest_index(x, exclude={code})
    np.testing.assert_array_equal(gen._anchors()[0], ref._anchors()[0])


# -- fingerprints and the wide MoE sharding spaces -----------------------------

def test_fingerprint_equals_reference():
    params, cons = _tight()
    gen, ref = _twins(params, cons, name="fp")
    assert SpaceFingerprint.of(gen, objective="obj").digest == \
        JFingerprint.of(ref, objective="obj").digest
    enum, jenum = _twins(params, cons, name="fp", cls="SearchSpace")
    fe = SpaceFingerprint.of(enum, objective="obj")
    fg = SpaceFingerprint.of(gen, objective="obj")
    assert fe.digest == JFingerprint.of(jenum, objective="obj").digest
    assert fg.compatible(fe) and fe.compatible(fg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_wide_moe_sharding_space_builds_with_reference_digest(arch, shape):
    s = sharding_space(arch, shape, wide=True)
    r = j_sharding_space(arch, shape, wide=True)
    assert isinstance(s, TS.GenerativeSpace)
    assert s.cartesian_size == r.cartesian_size > 20_000_000
    assert s.name == r.name and s.dim == r.dim
    oid = f"dryrun[{arch}×{shape}×single]"
    assert SpaceFingerprint.of(s, objective=oid).digest == \
        JFingerprint.of(r, objective=oid).digest
    got = s.stratified_feasible(np.random.default_rng(0), 16)
    np.testing.assert_array_equal(
        got, r.stratified_feasible(np.random.default_rng(0), 16))
    assert s._feasible_mask(got).all()
    cfg = s.config(int(got[0]))
    assert cfg == r.config(int(got[0])) and s.index_of(cfg) == int(got[0])


def test_hard_sharding_space_stays_cut():
    """The hard grid is ported (it was cut before the dry-run tooling):
    deepseek-v3's train_4k cell builds under the reference's name and
    fingerprint."""
    from repro.core.tuning_targets import sharding_space as jax_sharding_space
    from repro.store.records import SpaceFingerprint as JaxSpaceFingerprint
    from repro_torch.store.records import SpaceFingerprint
    mine = sharding_space("deepseek-v3-671b", "train_4k", hard=True)
    theirs = jax_sharding_space("deepseek-v3-671b", "train_4k", hard=True)
    assert mine.name == theirs.name == "sharding_hard[deepseek-v3-671b×train_4k]"
    oid = "dryrun[deepseek-v3-671b×train_4k×single]"
    assert SpaceFingerprint.of(mine, objective=oid).digest == \
        JaxSpaceFingerprint.of(theirs, objective=oid).digest


# -- pool BO end to end -------------------------------------------------------

def _bowl(cfg):
    vals = np.array([cfg[f"p{j}"] for j in range(6)], np.float64)
    return float(0.01 + np.sum((vals / 31.0 - 0.4) ** 2))


def test_pool_bo_on_generative_space_equals_reference(tmp_path):
    """The reference's pool-mode BO run on a 1e9 grid, numpy backend: the
    same journal, journaled under the same fingerprint."""
    params, cons = _huge()
    space, jspace = _twins(params, cons, name="e2e", cls="SearchSpace")
    assert isinstance(space, TS.GenerativeSpace)
    obj = CallableObjective(space, _bowl, name="gen_e2e")
    jobj = JCallableObjective(jspace, _bowl, name="gen_e2e")
    store = TuningRecordStore(str(tmp_path / "store"))
    res = run_strategy(make_strategy("ei"), obj, budget=30, seed=0,
                       store=store, run_id="gen-run")
    ref = j_run_strategy(j_make_strategy("ei"), jobj, budget=30, seed=0)
    assert [(o.key, o.value, o.af) for o in res.journal] == \
        [(o.key, o.value, o.af) for o in ref.journal]
    assert res.unique_evals == 30
    assert space._feasible_mask(np.array([o.idx for o in res.journal])).all()
    fp = SpaceFingerprint.of(space, objective=obj.name)
    assert fp.digest == JFingerprint.of(jspace, objective=obj.name).digest
    assert len(store.records(fp=fp.digest)) == 30
    best_cfg, best_val = store.best_config(fp)
    assert math.isclose(best_val, res.best_value, rel_tol=1e-12)


def test_pool_bo_kernel_backend_on_generative_space():
    """gp_backend="cuda" (its plain version on the CPU) scores pools of
    varying size through the kernel wrapper: every suggestion feasible, no
    revisit, the initial sample the numpy backend's."""
    params, cons = _huge()
    space, _ = _twins(params, cons, name="e2e-k", cls="SearchSpace")
    obj = CallableObjective(space, _bowl, name="gen_k")
    res = run_strategy(make_strategy("ei", gp_backend="cuda",
                                     gp_block_n=128, gp_device="cpu"),
                       obj, budget=26, seed=0)
    base = run_strategy(make_strategy("ei"), obj, budget=26, seed=0)
    keys = [o.key for o in res.journal]
    assert res.unique_evals == 26 and len(keys) == len(set(keys))
    assert space._feasible_mask(np.array([o.idx for o in res.journal])).all()
    assert keys[:20] == [o.key for o in base.journal][:20]
