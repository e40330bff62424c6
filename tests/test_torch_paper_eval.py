"""The rest of the paper's evaluation on the port (``launch/compare.py``:
Fig. 4, Figs. 6-7, Table I and the store's cross-size warm start) against
the JAX package's benchmark scripts, and a decode record written by the
JAX package served by the port.

Repeats and budgets are cut, never the spaces. On the CPU the port's BO
runs the reference's numpy GP line for line, so every trace, MAE and
evaluation count must equal the reference's bit for bit.
"""
import dataclasses
import math
import os
import shutil

import numpy as np
import pytest
import torch

from repro.kernels import tuning as jt
from repro.store import TuningRecordStore as JStore
from repro.store.records import SpaceFingerprint as JFingerprint
from repro.store.records import TuningRecord as JRecord

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import compare, serve
from repro_torch.parallel.sharding import ParallelConfig

# the decode cell of the smoke server below: batch, prompt, decode steps
B, PROMPT, STEPS = 2, 128, 4


# -- a decode record written by the reference ---------------------------------

def _reference_decode_record(store: str, H: int, KV: int, hd: int) -> dict:
    """The reference's decode cell at the server's cache, its default
    blocks (``"combine": "jax"``) timed by the reference's objective and
    journaled as the reference's engine journals an observation."""
    cell = jt.decode_cell(B, PROMPT + STEPS, H, KV, hd, interpret=True)
    idx = cell.space.index_of(cell.default)
    value = jt.KernelObjective(cell, reps=1, device="cpu")(idx)
    assert math.isfinite(value)
    fp = JFingerprint.of(cell.space, objective=cell.objective_id("cpu"))
    st = JStore(store)
    st.append(JRecord(fp="", run="jax-decode", seq=0, key=str(idx), idx=idx,
                      value=value, config=dict(cell.default)),
              fingerprint=fp)
    st.close()
    return cell.default


def test_reference_decode_record_serves_on_the_port(tmp_path, capsys):
    """The reference names its tensor-op decode combine "jax", the port
    "torch": a record the reference journaled reaches the port's server,
    which reads it as its own name and completes its decode steps. The
    smoke config's head dim (16) is one the card's decode kernel lacks, so
    the resolver refuses every decode record for it: the server here is the
    smoke config at head dim 64 in fp32, resolved through ``serve``'s
    --kernels --store path (``serving_kernel_config``) and held to its
    plain path."""
    store = str(tmp_path / "store")
    cfg = smoke_config("gemma-2b").replace(head_dim=64, dtype="float32")
    default = _reference_decode_record(store, cfg.num_heads,
                                       cfg.num_kv_heads, 64)
    assert default["combine"] == "jax"
    kc = serve.serving_kernel_config(
        cfg, device=torch.device("cpu"), prompt_len=PROMPT,
        cache_cap=PROMPT + STEPS, batch=B, store=store)
    assert "tuned decode blocks from store" in capsys.readouterr().out
    assert (kc.use_decode, kc.decode_block_kv, kc.decode_num_splits,
            kc.decode_combine) == (True, 512, 1, "torch")
    runs = {}
    for name, pcfg in (("plain", ParallelConfig()),
                       ("record", ParallelConfig(kernel=kc))):
        srv = serve.DecodeServer(cfg, pcfg, batch=B, prompt_len=PROMPT,
                                 decode_steps=STEPS, device="cpu",
                                 keep_logits=STEPS)
        srv.prefill_batch(srv.input_batch())
        for _ in range(STEPS):
            srv.decode_step()
        runs[name] = srv
    assert runs["record"].pos == PROMPT + STEPS
    assert "+ tensor-op combine" in runs["record"].decode_dispatch
    for a, b in zip(runs["plain"].kept, runs["record"].kept):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    # the CLI at --smoke serves from the same store
    out = serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                      "--batch", str(B), "--prompt-len", str(PROMPT),
                      "--decode-steps", str(STEPS), "--kernels", "--store",
                      store])
    assert len(out["step_s"]) == STEPS
    assert out["server"].pos == PROMPT + STEPS


def test_hot_reload_reads_the_reference_combine_name():
    from repro_torch.store.resolve import apply_kernel_config
    from repro_torch.kernels import flash_decode as kfd
    pcfg = apply_kernel_config(ParallelConfig(), {
        "block_kv": 256, "num_splits": 2, "combine": "jax"})
    assert pcfg.kernel.decode_combine == "torch"
    for name in kfd.COMBINE_STRATEGIES:
        assert apply_kernel_config(ParallelConfig(), {
            "block_kv": 256, "num_splits": 2,
            "combine": name}).kernel.decode_combine == name
    # any other unknown name still reaches the kernel's refusal
    bad = apply_kernel_config(ParallelConfig(), {"num_splits": 1,
                                                 "combine": "pallas"})
    q = torch.zeros(1, 1, 64)
    kv = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="combine must be one of"):
        kfd.flash_decode(q, kv, kv, torch.zeros(1, 8),
                         combine=bad.kernel.decode_combine)


# -- Fig. 4 -------------------------------------------------------------------

def test_fig4_equals_the_reference_bit_for_bit():
    """EI's target at budget 60 and every baseline's evaluations to match it
    (cap 200) over 2 seeds: the reference's ``fig4_extended.py`` computed
    from the reference's own functions."""
    from benchmarks import fig4_extended as ref
    from repro.core.metrics import evals_to_match
    from repro.core.runner import run_strategy
    from repro.core.spaces import make_objective
    from repro.core.strategies import make_strategy
    assert (compare.FIG4_OTHERS, compare.FIG4_CAP) == (ref.OTHERS, ref.CAP)
    budget, cap, repeats = 60, 200, 2
    got = compare.fig4(repeats, budget=budget, cap=cap, device="cpu")
    obj = make_objective("gemm", "gtx_titan_x")
    target = float(np.mean([run_strategy(make_strategy("ei"), obj,
                                         budget=budget, seed=s).best_value
                            for s in range(repeats)]))
    assert got["target"] == target
    for strat in ref.OTHERS:
        evals = [evals_to_match(run_strategy(make_strategy(strat), obj,
                                             budget=cap, seed=s).trace,
                                target, cap) for s in range(repeats)]
        mine = got["others"][strat]
        assert mine["evals"] == evals, strat
        assert mine["mean_evals"] == float(np.mean(evals))
        assert mine["frac_matched"] == float(np.mean([e <= cap
                                                      for e in evals]))


# -- Figs. 6-7 ----------------------------------------------------------------

def test_unseen_kernels_matrix_equals_the_reference():
    """Figs. 6-7's matrix (ExpDist and Adding on the A100 spaces, the seven
    strategies) at budget 60 and 1 repeat against the reference's
    ``benchmarks.common.run_matrix``: traces and MAEs bit for bit."""
    from benchmarks import common
    from benchmarks import fig6_7_unseen as ref
    gpu, strategies, _ = compare.FIGURES[6]
    kernels = compare.FIGURE_KERNELS[6]
    assert (gpu, strategies, kernels) == ("a100", ref.STRATEGIES,
                                          ref.KERNELS)
    got = compare.run_matrix(kernels, gpu, strategies, 1, budget=60,
                             device="cpu")
    want = common.run_matrix(kernels, gpu, strategies, 1, budget=60,
                             workers=1, batch_size=1, store=None)
    for k in kernels:
        for s in strategies:
            g, w = got[k][s], want[k][s]
            assert g["traces"] == w["traces"], (k, s)
            assert (g["mean_mae"], g["best_final"]) == (w["mean_mae"],
                                                        w["best_final"])
    assert compare.mdf_from_matrix(got) == common.mdf_from_matrix(want)


# -- Table I ------------------------------------------------------------------

def _reference_config(cfg):
    """The reference's ``BOConfig`` built from a port variant's fields."""
    from repro.core.strategies.bo import BOConfig
    names = {f.name for f in dataclasses.fields(BOConfig)}
    return BOConfig(**{f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(cfg) if f.name in names})


def test_table1_variants_are_the_reference_s():
    from benchmarks import table1_hyperparams as ref
    assert list(compare.VARIANTS) == list(ref.VARIANTS)
    for name, cfg in compare.VARIANTS.items():
        assert _reference_config(cfg) == ref.VARIANTS[name], name
    assert (compare.TABLE1_KERNELS, compare.TABLE1_REPEATS) == (
        ref.KERNELS, 5)


def test_table1_equals_the_reference_bit_for_bit():
    """All ten variants on pnpoly at budget 60, seed 0: MAEs bit for bit
    against the reference's BO built from each variant's fields, then the
    same MDF table and ranking."""
    from repro.core.metrics import mae, mdf_table
    from repro.core.runner import run_strategy
    from repro.core.spaces import make_objective
    from repro.core.strategies.bo import BOStrategy
    got = compare.table1(1, budget=60, kernels=("pnpoly",), device="cpu")
    obj = make_objective("pnpoly", "gtx_titan_x")
    want = {"pnpoly": {}}
    for name, cfg in compare.VARIANTS.items():
        res = run_strategy(BOStrategy(_reference_config(cfg), name=name),
                           obj, budget=60, seed=0)
        want["pnpoly"][name] = float(mae(res.trace, obj.optimum))
    assert got["per_kernel"] == want
    mdf = mdf_table(want)
    assert got["mdf"] == mdf
    assert got["ranked"] == [n for n, _ in sorted(mdf.items(),
                                                  key=lambda kv: kv[1]["mdf"])]


# -- the cross-size warm start --------------------------------------------------

WARM_BUDGET = 40


@pytest.fixture(scope="module")
def reference_source(tmp_path_factory):
    """One reference source run (budget 40, seed 100) on ExpDist at sequence
    512, journaled into a store."""
    from repro.core.runner import run_strategy
    from repro.core.spaces import make_scenario_objective
    from repro.core.strategies import make_strategy
    store = str(tmp_path_factory.mktemp("warm") / "source")
    src = make_scenario_objective("expdist", "a100", "seq512")
    res = run_strategy(make_strategy("advanced_multi"), src,
                       budget=WARM_BUDGET, seed=100, store=store)
    return store, res


def test_warm_matches_equal_the_reference(reference_source):
    from repro.core.spaces import make_scenario_objective as j_scenario
    from repro.store.transfer import warm_matches as j_warm_matches
    from repro_torch.core.spaces import make_scenario_objective
    from repro_torch.store.records import SpaceFingerprint, TuningRecordStore
    from repro_torch.store.transfer import warm_matches
    store, _ = reference_source
    tgt = make_scenario_objective("expdist", "a100", "seq4096")
    jtgt = j_scenario("expdist", "a100", "seq4096")
    assert tgt.space.size == jtgt.space.size == 14221
    fp = SpaceFingerprint.of(tgt.space, objective=tgt.name)
    jfp = JFingerprint.of(jtgt.space, objective=jtgt.name)
    assert fp.digest == jfp.digest
    got = warm_matches(TuningRecordStore(store), fp, tgt.space)
    want = j_warm_matches(JStore(store), jfp, jtgt.space)
    assert len(got) == len(want) > 0
    assert not any(w.exact for w in got)        # cross-size only
    for g, w in zip(got, want):
        assert (g.idx, g.exact, g.value) == (w.idx, w.exact, w.value)
        assert g.noise == pytest.approx(w.noise, abs=1e-12, rel=0)
        assert np.array_equal(g.x, np.asarray(w.x, np.float64))


def test_warm_start_equals_the_reference_bit_for_bit(reference_source,
                                                     monkeypatch, capsys):
    """``compare.warm_start`` at a cut (1 source run and 1 seed at budget
    40): its source journal, cold trace and warm journal (on a fresh copy
    of the source store) are the reference's, and so are its scores."""
    from benchmarks.warm_start import evals_to_reach
    from repro.core.runner import run_strategy
    from repro.core.spaces import make_scenario_objective
    from repro.core.strategies import make_strategy
    store, src_res = reference_source
    tgt = make_scenario_objective("expdist", "a100", "seq4096")
    cold = run_strategy(make_strategy("advanced_multi"), tgt,
                        budget=WARM_BUDGET, seed=0)
    copy = os.path.join(os.path.dirname(store), "reference_seed0")
    shutil.copytree(store, copy)
    warm = run_strategy(make_strategy("advanced_multi"), tgt,
                        budget=WARM_BUDGET, seed=0, store=copy)

    runs = {}
    monkeypatch.setattr(compare, "WARM_SMOKE", (1, WARM_BUDGET, 1))
    out = compare.warm_start(5, smoke=True, device="cpu",
                             on_run=lambda run:
                             runs.setdefault(run.label, run.result))
    assert list(runs) == ["warm_start/source/seed100",
                          "warm_start/cold/seed0", "warm_start/warm/seed0"]
    for label, ref in (("source/seed100", src_res), ("cold/seed0", cold),
                       ("warm/seed0", warm)):
        mine = runs[f"warm_start/{label}"]
        assert [o.key for o in mine.journal] == [o.key for o in ref.journal]
        assert np.array_equal([o.value for o in mine.journal],
                              [o.value for o in ref.journal],
                              equal_nan=True), label
    c = evals_to_reach(cold.trace, cold.best_value)
    w = evals_to_reach(warm.trace, cold.best_value)
    row, = out["rows"]
    assert (row["cold_evals_to_best"], row["warm_evals_to_cold_best"]) == (
        c, w)
    assert out["reduction"] == 1.0 - (WARM_BUDGET if w is None else w) / c
    text = capsys.readouterr().out
    for name in ("warm_start/source_run_0,", "warm_start/seed0,0.0,cold=",
                 "warm_start/reduction,0.0,"):
        assert name in text


def test_warm_run_on_the_kernel_path_pads_t(reference_source, monkeypatch,
                                             tmp_path):
    """The same warm run with ``gp_backend="cuda"`` on the CPU (the
    kernel's plain version): the GP rebuilt for budget + priors, every
    packaging padded to the next power of two (at least 128), the full
    budget taken and no config evaluated twice. The packaging pads the
    warm start's 476 observations on the card (220 + 256 priors) to 512."""
    from repro_torch.core.gp_fast import IncrementalGP
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.spaces import make_scenario_objective
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import ops
    from repro_torch.store.records import SpaceFingerprint, TuningRecordStore
    from repro_torch.store.transfer import warm_matches
    store, _ = reference_source
    copy = str(tmp_path / "store")
    shutil.copytree(store, copy)
    tgt = make_scenario_objective("expdist", "a100", "seq4096")
    n_warm = len(warm_matches(TuningRecordStore(copy),
                              SpaceFingerprint.of(tgt.space,
                                                  objective=tgt.name),
                              tgt.space))
    seen = []
    plain = ops.gp_posterior

    def recorded(x_cand, x_obs, vinv, w, mask, **kw):
        seen.append((x_obs.shape[0], int(mask.sum())))
        return plain(x_cand, x_obs, vinv, w, mask, **kw)

    monkeypatch.setattr(ops, "gp_posterior", recorded)
    strat = make_strategy("advanced_multi", gp_backend="cuda",
                          gp_device="cpu")
    res = run_strategy(strat, tgt, budget=WARM_BUDGET, seed=0, store=copy)
    keys = [o.key for o in res.journal]
    assert res.unique_evals == WARM_BUDGET and len(set(keys)) == len(keys)
    gp = strat.gp.gp
    assert (gp.backend, gp.max_obs) == ("cuda", WARM_BUDGET + n_warm)
    assert seen and all(T == max(128, 1 << (t - 1).bit_length())
                        for T, t in seen)
    assert max(t for _, t in seen) > n_warm
    rng = np.random.default_rng(0)
    X = tgt.space.X_norm[rng.choice(tgt.space.size, 476, replace=False)]
    gp = IncrementalGP(X[:64], max_obs=476, backend="cuda", device="cpu")
    for t, x in enumerate(X, 1):
        gp.add(x, float(rng.random()), extra_noise=0.05 if t <= 256 else 0.0)
        if t in (128, 129, 256, 257, 476):
            x_obs, vinv, w, mask, _, _ = ops.gp_inputs_from_incremental(gp)
            T = {128: 128, 129: 256, 256: 256, 257: 512, 476: 512}[t]
            assert x_obs.shape[0] == vinv.shape[0] == w.shape[0] == T
            assert mask.sum() == t and not vinv[t:].any()


# -- the CLI ------------------------------------------------------------------

def test_compare_cli_prints_the_reference_rows(monkeypatch, capsys):
    monkeypatch.setattr(compare, "FIG4_BUDGET", 30)
    monkeypatch.setattr(compare, "FIG4_CAP", 40)
    out = compare.main(["--figure", "4", "--repeats", "1", "--device",
                        "cpu"])
    text = capsys.readouterr().out
    assert "fig4/ei_target,0.0,best_at_30=" in text
    for strat in compare.FIG4_OTHERS:
        assert f"fig4/{strat},0.0,evals_to_match=" in text
        assert "matched=" in text
    assert out["device"] == "cpu" and set(out["others"]) == set(
        compare.FIG4_OTHERS)

    monkeypatch.setitem(compare.FIGURE_KERNELS, 6, ("adding",))
    monkeypatch.setitem(compare.FIGURES, 6, ("a100", ("random", "mls"), 1))
    compare.main(["--figure", "6", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "fig6_7/adding/mls," in text and "mae=" in text
    assert "fig6_7/mdf/random,0.0,mdf=" in text

    monkeypatch.setattr(compare, "TABLE1_KERNELS", ("pnpoly",))
    monkeypatch.setattr(compare, "TABLE1_BUDGET", 30)
    monkeypatch.setattr(compare, "VARIANTS", {
        k: compare.VARIANTS[k] for k in ("m52_l0.5_cv_advmulti",
                                         "rbf_l1.0_cv_advmulti")})
    out = compare.main(["--table", "1", "--repeats", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "table1/m52_l0.5_cv_advmulti,0.0,mdf=" in text
    assert "table1/rbf_l1.0_cv_advmulti,0.0,mdf=" in text
    assert len(out["ranked"]) == 2

    monkeypatch.setattr(compare, "WARM_SMOKE", (1, 30, 2))
    out = compare.main(["--warm-start", "--smoke", "--repeats", "1",
                        "--device", "cpu"])
    text = capsys.readouterr().out
    for name in ("warm_start/source_run_0,", "warm_start/seed0,0.0,cold=",
                 "warm_start/reduction,0.0,"):
        assert name in text
    assert out["scenario"]["budget"] == 30 and len(out["rows"]) == 1
    for bad in (["--figure", "4", "--smoke"], ["--table", "1", "--kernel",
                                                "gemm"]):
        with pytest.raises(SystemExit):
            compare.main(bad)
