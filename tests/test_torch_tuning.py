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
from repro_torch.kernels import gemm as kgemm
from repro_torch.kernels import ops, tuning
from repro_torch.launch.roofline import CARD, SMEM_PER_BLOCK, bound_ms
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

def test_gemm_resource_model(monkeypatch):
    f32 = torch.empty((), dtype=torch.float32).element_size()
    bf16 = torch.empty((), dtype=torch.bfloat16).element_size()
    default = tuning.gemm_cell(256, 256, 256, device="cpu").default
    assert default == {"block_m": 128, "block_n": 128, "block_k": 64}
    assert ops.gemm_valid(default, f32) and ops.gemm_valid(default, bf16)
    # a warp per 64x32 tile of C: the default runs 8 warps
    assert kgemm.gemm_threads(128, 128) == 256
    # the ring: padded A (rows + 4 floats / 8 bf16) and B (rows + 8) tiles,
    # as many stages as fit 227 KB, at most 4
    assert kgemm.gemm_stage_bytes(128, 128, 64, f32) == 4 * (128 * 68
                                                            + 64 * 136)
    assert kgemm.gemm_stages(128, 128, 64, f32) == 3
    assert kgemm.gemm_stages(128, 128, 64, bf16) == 4
    assert kgemm.gemm_smem_bytes(128, 128, 64, f32) == 3 * 69632
    big = {"block_m": 1024, "block_n": 1024, "block_k": 64}     # 16K threads
    assert not ops.gemm_valid(big, f32) and not ops.gemm_valid(big, bf16)
    # room for fewer than 2 stages: a static invalid, in fp32 where bf16's
    # half-size tiles still fit a ring
    for bm, bn, bk in ((128, 128, 128), (128, 64, 256), (256, 256, 256)):
        cfg = {"block_m": bm, "block_n": bn, "block_k": bk}
        assert kgemm.gemm_stages(bm, bn, bk, f32) < 2
        assert kgemm.gemm_smem_bytes(bm, bn, bk, f32) > SMEM_PER_BLOCK
        assert not ops.gemm_valid(cfg, f32)
    assert ops.gemm_valid({"block_m": 128, "block_n": 128, "block_k": 128},
                          bf16)
    tiny = {"block_m": 64, "block_n": 16, "block_k": 64}        # no warp
    assert not ops.gemm_valid(tiny, f32)
    # 32 warps: the ring fits in bf16, but the kernel is built for at most
    # 512 threads a block (256 in fp32)
    assert kgemm.gemm_threads(256, 256) == 1024
    assert kgemm.gemm_stages(256, 256, 64, bf16) == 3
    assert not ops.gemm_valid({"block_m": 256, "block_n": 256,
                               "block_k": 64}, bf16)
    assert kgemm.MAX_THREADS == {f32: 256, bf16: 512}
    wide = {"block_m": 256, "block_n": 128, "block_k": 64}     # 512 threads
    assert kgemm.gemm_stages(256, 128, 64, f32) == 2
    # registers: 512 threads of 224 (fp32) exceed the SM's 65,536, and the
    # fp32 launch bound refuses them; 512 of 128 (bf16) just fit
    assert ops.GEMM_REGS_PER_THREAD == {f32: 224, bf16: 128}
    assert not ops.gemm_valid(wide, f32) and ops.gemm_valid(wide, bf16)
    # the card allocates registers 8 a thread: 121 counts as 128 and 129
    # as 136, which 512 threads cannot have
    assert ops.allocated_regs(121) == 128 and ops.allocated_regs(129) == 136
    monkeypatch.setitem(ops.GEMM_REGS_PER_THREAD, bf16, 121)
    assert ops.gemm_valid(wide, bf16)
    monkeypatch.setitem(ops.GEMM_REGS_PER_THREAD, bf16, 129)
    assert not ops.gemm_valid(wide, bf16)
    monkeypatch.undo()
    # the reference's 125-config space, unchanged; 9 of it run in fp32 at
    # 4096^3 (the ring's shared memory refuses most block_k >= 128, the
    # registers blocks over 8 warps) and 21 in bf16
    space = ops.gemm_config_space(4096, 4096, 4096)
    assert space.size == 125
    n_ok = {db: sum(ops.gemm_valid(space.config(i), db)
                    for i in range(space.size)) for db in (f32, bf16)}
    assert n_ok == {f32: 9, bf16: 21}


def test_gp_resource_model_and_tuned_block_n(tmp_path):
    for T in (128, 256, 512, 1024):
        assert ops.gp_valid({"block_n": 512}, T, 15)
        assert ops.gp_valid({"block_n": 512}, T, 16)
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
    # 3xTF32: three TF32 products each on the 495 TFLOP/s tensor cores
    ms, by = bound_ms(2.0 * 4096 ** 3, 4.0 * 3 * 4096 ** 2, CARD, "tf32x3")
    assert by == "operations" and ms == pytest.approx(0.8330, abs=1e-4)
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
