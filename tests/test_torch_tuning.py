"""The port's kernel-tuning cells, resource model and record store.

The Hopper resource model decides which block configs are the paper's
invalid configurations; the store is shared with the JAX package (a store
written by either is read by the other); entry points left at their default
device raise where there is no card.
"""
import math

import numpy as np
import pytest

import torch

from repro.core.objectives import SimulatedObjective as JaxSimulated
from repro.core.runner import run_strategy as jax_run_strategy
from repro.core.searchspace import Param as JaxParam
from repro.core.searchspace import SearchSpace as JaxSpace
from repro.core.strategies import make_strategy as jax_make_strategy
from repro.store.records import TuningRecordStore as JaxStore

from repro_torch.core.engine import ParallelTuningEngine
from repro_torch.core.objectives import SimulatedObjective
from repro_torch.core.runner import run_strategy
from repro_torch.core.searchspace import Param, SearchSpace
from repro_torch.core.strategies import make_strategy
from repro_torch.kernels import ops, tuning
from repro_torch.launch.roofline import CARD, bound_ms
from repro_torch.store.records import SpaceFingerprint, TuningRecordStore


def _toy(space_cls, param_cls, obj_cls, seed=0):
    rng = np.random.default_rng(seed)
    space = space_cls([param_cls("a", tuple(range(12))),
                       param_cls("b", tuple(range(12)))], name="toy")
    x = space.X_norm
    times = (1.0 + 4 * ((x[:, 0] - 0.3) ** 2 + (x[:, 1] - 0.6) ** 2)
             ).astype(np.float64)
    times[rng.choice(space.size, 20, replace=False)] = math.nan
    return obj_cls(space, times, name="toy")


# -- the Hopper resource model -------------------------------------------------

def test_gemm_resource_model():
    f32 = torch.empty((), dtype=torch.float32).element_size()
    bf16 = torch.empty((), dtype=torch.bfloat16).element_size()
    default = tuning.gemm_cell(256, 256, 256, device="cpu").default
    assert default == {"block_m": 128, "block_n": 128, "block_k": 64}
    assert ops.gemm_valid(default, f32) and ops.gemm_valid(default, bf16)
    big = {"block_m": 1024, "block_n": 1024, "block_k": 64}     # 16K threads
    assert not ops.gemm_valid(big, f32) and not ops.gemm_valid(big, bf16)
    cube = {"block_m": 256, "block_n": 256, "block_k": 256}     # 512 KiB tiles
    assert not ops.gemm_valid(cube, f32)
    tiny = {"block_m": 64, "block_n": 16, "block_k": 64}        # 16 threads
    assert not ops.gemm_valid(tiny, f32)
    # registers: 512 threads x 128 fit the SM's 65,536, 1,024 threads do not
    assert ops.gemm_valid({"block_m": 256, "block_n": 128, "block_k": 64}, f32)
    assert not ops.gemm_valid({"block_m": 256, "block_n": 256, "block_k": 32},
                              f32)


def test_gp_resource_model_and_tuned_block_n(tmp_path):
    for T in (128, 256, 512):
        assert ops.gp_valid({"block_n": 512}, T, 15)
    assert not ops.gp_valid({"block_n": 512}, 2048, 15)      # smem over 227 KB
    assert not ops.gp_valid({"block_n": 512}, 200, 15)       # T not 64-aligned
    assert not ops.gp_valid({"block_n": 48}, 256, 15)        # partial sub-tile
    store = str(tmp_path / "cold")
    assert tuning.tuned_gp_block_n(store, N=4096, T=512, d=15) == 512
    with pytest.raises(ValueError, match="T=2048"):
        tuning.tuned_gp_block_n(store, N=4096, T=2048, d=15)


def test_kernel_objective_static_invalid_is_nan_without_running():
    calls = []
    cell = tuning.gemm_cell(256, 256, 256, device="cpu")
    run = cell.run
    cell.run = lambda cfg: calls.append(cfg) or run(cfg)
    obj = tuning.KernelObjective(cell, reps=2, device="cpu")
    bad = cell.space.index_of({"block_m": 256, "block_n": 256,
                               "block_k": 256})
    assert math.isnan(obj(bad)) and calls == []
    good = cell.space.index_of(cell.default)
    v = obj(good)
    assert math.isfinite(v) and v > 0 and len(calls) == 3   # warmup + reps


def test_run_kernel_tuning_journals_and_resolves_on_cpu(tmp_path):
    store = str(tmp_path / "store")
    cell = tuning.gp_cell(N=1024, T=128, d=6, t_obs=13, device="cpu")
    res = tuning.run_kernel_tuning(cell, store, budget=4, init=2, reps=1,
                                   device="cpu", gp_backend="cuda",
                                   gp_block_n=128)
    assert res.unique_evals == 4 and math.isfinite(res.best_value)
    assert res.objective == "kernel[gp×N1024_T128_d6×cpu]"
    best = tuning.best_kernel_config(store, "gp", device="cpu")
    assert best is not None and best[1] == res.best_value
    assert best[0] == cell.space.config(res.best_idx)
    assert (tuning.tuned_gp_block_n(store, N=1024, T=128, d=6,
                                    device="cpu") == best[0]["block_n"])
    # a CPU record never resolves for a card
    assert tuning.best_kernel_config(
        store, "gp", device="cuda-NVIDIA_H100_80GB_HBM3") is None


def test_refused_launch_codes_map_to_launch_refused():
    from repro_torch.kernels import _build
    _build.check(0, "ok")
    for code in (701, 9):     # out of resources, invalid configuration
        with pytest.raises(_build.LaunchRefused):
            _build.check(code, "launch")
    with pytest.raises(_build.CudaError) as e:
        _build.check(700, "launch")   # illegal address: raised, not NaN
    assert not isinstance(e.value, _build.LaunchRefused)


def test_card_objective_refuses_process_backend_and_workers():
    class CardObjective(SimulatedObjective):
        in_process_only = True
    toy = _toy(SearchSpace, Param, SimulatedObjective)
    obj = CardObjective(toy.space, toy.times, name="card")
    for kw in ({"backend": "process"}, {"workers": 2}):
        with pytest.raises(ValueError, match="in-process"):
            ParallelTuningEngine(obj, 10, **kw)
    ParallelTuningEngine(obj, 10)                     # workers=1, thread


def test_bound_is_the_larger_of_operations_and_bytes():
    ms, by = bound_ms(2.0 * 4096 ** 3, 4.0 * 3 * 4096 ** 2, CARD)
    assert by == "operations" and ms == pytest.approx(2.0513, abs=1e-4)
    ms, by = bound_ms(1e6, 3.35e9, CARD)
    assert by == "bytes" and ms == pytest.approx(1.0)
    with pytest.raises(ValueError, match="no published peaks"):
        bound_ms(1.0, 1.0, "NVIDIA A100-SXM4-80GB")


# -- the store, shared with the JAX package --------------------------------------

def test_store_written_by_either_package_is_read_by_the_other(tmp_path):
    store = str(tmp_path / "shared")
    jobj = _toy(JaxSpace, JaxParam, JaxSimulated)
    jres = jax_run_strategy(jax_make_strategy("ei"), jobj, budget=12, seed=0,
                            store=store, run_id="jax-run")
    mine = TuningRecordStore(store)
    obj = _toy(SearchSpace, Param, SimulatedObjective)
    fp = SpaceFingerprint.of(obj.space, objective=obj.name)
    assert fp.digest in mine.fingerprints()
    recs = mine.records(fp=fp.digest, run="jax-run")
    assert [r.key for r in recs] == [o.key for o in jres.journal]
    assert mine.best_config(fp.digest)[1] == jres.best_value
    # the port journals into the same store, warm-started from the JAX run
    res = run_strategy(make_strategy("ei"), obj, budget=12, seed=1,
                       store=store, run_id="torch-run")
    theirs = JaxStore(store)
    back = theirs.records(fp=fp.digest, run="torch-run")
    assert [r.key for r in back] == [o.key for o in res.journal]
    assert [r.value for r in back] == pytest.approx(
        [o.value for o in res.journal], nan_ok=True)
    assert set(theirs.fingerprints()) == set(
        TuningRecordStore(store).fingerprints())


# -- device keys and the default device ------------------------------------------

def test_device_kind_keys_are_colon_free():
    assert tuning.device_kind("cpu") == "cpu"
    kind = tuning.device_kind()
    assert kind == ("cpu" if not torch.cuda.is_available() else kind)
    for bad in (":", "×", "]", " "):
        assert bad not in kind
    key = tuning.kernel_cell_objective("gemm", "64x64x64", kind)
    assert key.count("×") == 2 and ":" not in key


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.gemm_cell(128, 128, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.gp_cell(N=256, T=128, d=4, t_obs=3)
    cell = tuning.gemm_cell(128, 128, 128, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.KernelObjective(cell)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.run_kernel_tuning(cell, budget=2, init=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tuning.gemm_cell(128, 128, 128, device="cuda")
