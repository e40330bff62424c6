"""The dry-run tooling for one card against the JAX package, on the CPU.

The cell shapes on meta tensors (``launch/specs.input_specs``) against the
reference's ``input_specs(..., mesh=None)`` for every (arch × shape) cell
that ``shape_applicable`` admits; ``model_flops_for`` against the
reference's; the traced FLOPs of the train step (3x the forward of the
loss at ``remat`` "none" and "dots", between 3x and 4x at "full") and of
a prefill (a count from the shapes); the scaled scans against a whole
trace; ``resolve_spec`` on the reference's own cases; the hard sharding
grids' fingerprints; ``DryRunObjective`` and the retune daemon's
servicing of a card's key; the CLI with no card.
"""
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.configs.arch import SHAPES as JAX_SHAPES
from repro.configs.arch import shape_applicable as jax_shape_applicable
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_arch as jax_get_arch
from repro.core.tuning_targets import sharding_space as jax_sharding_space
from repro.launch.roofline import model_flops_for as jax_model_flops_for
from repro.launch.specs import input_specs as jax_input_specs
from repro.optim import optimizers as JO
from repro.parallel.sharding import DEFAULT_ACT_RULES as J_ACT_RULES
from repro.parallel.sharding import DEFAULT_PARAM_RULES as J_PARAM_RULES
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import resolve_spec as jax_resolve_spec
from repro.store.records import SpaceFingerprint as JaxSpaceFingerprint

from repro_torch.configs.arch import SHAPES, SHAPES_BY_NAME, ShapeConfig
from repro_torch.configs.arch import shape_applicable
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.core.tuning_targets import DryRunObjective, sharding_space
from repro_torch.launch import dryrun as D
from repro_torch.launch import retune
from repro_torch.launch.roofline import (CARD, Roofline, card_memory,
                                         model_flops_for)
from repro_torch.launch.specs import input_specs
from repro_torch.models import params as P
from repro_torch.models.stepfn import loss_fn
from repro_torch.optim.optimizers import Adafactor, AdamW, constant_lr
from repro_torch.parallel.sharding import (DEFAULT_ACT_RULES,
                                           DEFAULT_PARAM_RULES, KernelConfig,
                                           ParallelConfig, resolve_spec)
from repro_torch.store.records import SpaceFingerprint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_KEY = "cuda-NVIDIA_H100_80GB_HBM3"
#: the reference's index leaves (token ids, labels, cache positions, the
#: decode position) are int32; the port's entry points feed int64
INDEX = {"int32": "int64"}


def _cells(name):
    cfg = get_arch(name)
    return [s for s in SHAPES if shape_applicable(cfg, s)[0]]


def _ref_layout(tree, cfg, prefix=("layers",), index=False):
    """{port path: (shape, dtype name)} of a reference tree of structs:
    each segment unstacked layer by layer in ``params_from_jax``'s order
    (``prefix`` + layer index), other entries as they are; int32 read as
    the port's int64 where ``index``."""
    out = {}
    layer = 0
    for si, (n_rep, cycle) in enumerate(cfg.pattern_layers()):
        seg = tree["segments"][si]
        for _ in range(n_rep):
            for j, kind in enumerate(cycle):
                for path, s in P.leaves(seg[f"{j}:{kind}"]):
                    out[prefix + (layer,) + path] = (tuple(s.shape[1:]),
                                                     _dt(s, index))
                layer += 1
    for name, sub in tree.items():
        if name != "segments":
            for path, s in P.leaves(sub):
                out[(name,) + path] = (tuple(s.shape), _dt(s, index))
    return out


def _dt(s, index):
    name = np.dtype(s.dtype).name
    return INDEX.get(name, name) if index else name


def _port_layout(tree):
    return {path: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for path, t in P.leaves(tree)}


def _bytes(layout):
    return sum(int(np.prod(shape, dtype=np.int64)) * np.dtype(
        {"bfloat16": "float16"}.get(dt, dt)).itemsize
        for shape, dt in layout.values())


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_cell_shapes_match_the_reference(name):
    """Params, AdamW state, cache and batch as meta tensors: every leaf's
    shape and dtype as the reference's ``input_specs(..., mesh=None)``
    after ``params_from_jax``'s layout map (int32 index leaves as int64),
    and the total bytes equal; Adafactor's state as the reference's
    ``abstract_state`` over the same per-layer tree. The train step's
    ``step`` is a Python int in the port (no device bytes)."""
    cfg, ref = get_arch(name), jax_get_arch(name)
    for shape in _cells(name):
        jshape = next(s for s in JAX_SHAPES if s.name == shape.name)
        assert jax_shape_applicable(ref, jshape)[0]
        jopt = JO.AdamW(schedule=JO.constant_lr(1e-4))
        opt = AdamW(schedule=constant_lr(1e-4))
        want = jax_input_specs(ref, jshape, None, JaxParallelConfig(),
                               optimizer=jopt if shape.kind == "train"
                               else None)
        got = input_specs(cfg, shape, None, ParallelConfig(),
                          optimizer=opt if shape.kind == "train" else None)
        for t in D._tensors(got):
            assert t.device.type == "meta"
        w = {("params",) + k: v for k, v in
             _ref_layout(want["params"], cfg).items()}
        w.update({("batch", k): (tuple(s.shape), _dt(s, True))
                  for k, s in want["batch"].items()})
        if shape.kind == "train":
            for m in ("mu", "nu"):
                w.update({("opt_state", m) + k: v for k, v in
                          _ref_layout(want["opt_state"][m], cfg).items()})
            w[("opt_state", "count")] = ((), "int32")
            assert got["step"] == 0
            got = {k: v for k, v in got.items() if k != "step"}
        if shape.kind == "decode":
            w.update({("cache",) + k: v for k, v in _ref_layout(
                want["cache"], cfg, prefix=(), index=True).items()})
            w[("pos",)] = ((), "int64")
        g = _port_layout(got)
        assert g == w, (name, shape.name, sorted(set(g) ^ set(w))[:6])
        assert D.storage_bytes(got) == _bytes(w)
    # Adafactor: the reference's rule over the port's per-layer tree
    params = input_specs(cfg, SHAPES[1], None, ParallelConfig())["params"]
    structs = P.map_tree(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.dtype(str(t.dtype).split(".")[-1])), params)
    want = JO.Adafactor(schedule=JO.constant_lr(1e-3)).abstract_state(structs)
    got = Adafactor(schedule=constant_lr(1e-3)).abstract_state(params)
    assert _port_layout(got) == {k: (tuple(s.shape), _dt(s, False))
                                 for k, s in P.leaves(want)}


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_model_flops_for_matches_the_reference(name):
    cfg, ref = get_arch(name), jax_get_arch(name)
    for shape, jshape in zip(SHAPES, JAX_SHAPES):
        assert model_flops_for(cfg, shape) == jax_model_flops_for(ref, jshape)


def test_roofline_is_the_reference_terms_on_one_card():
    r = Roofline(flops=989e12, hbm_bytes=6.7e12, model_flops=494.5e12)
    d = r.to_dict()
    from repro.launch.roofline import Roofline as JaxRoofline
    assert set(d) == set(JaxRoofline(1, 1, 0, 0, 1).to_dict())
    assert d["t_compute"] == pytest.approx(1.0)
    assert d["t_memory"] == pytest.approx(2.0)
    assert d["dominant"] == "memory" and d["step_time"] == d["t_memory"]
    assert d["useful_flops_ratio"] == pytest.approx(0.5)
    assert d["t_collective"] == 0 and d["chips"] == 1
    with pytest.raises(ValueError):
        Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes=1.0)
    assert card_memory(CARD) == 85_017_493_504
    with pytest.raises(ValueError):
        card_memory("TPU v5e")


# -- traced FLOPs at smoke widths -------------------------------------------

SMOKE_TRAIN = ShapeConfig("smoke_train", 32, 2, "train")


def _forward_flops(cfg, pcfg):
    """FLOPs of the loss's forward alone on the train cell's meta inputs."""
    specs = input_specs(cfg, SMOKE_TRAIN, None, pcfg,
                        optimizer=AdamW(schedule=constant_lr(1e-4)))
    fc = D.FlopCounterMode(display=False)
    with D.TraceCounter(fc, D._tensors(specs)):
        loss_fn(P.trainable(specs["params"]), specs["batch"], cfg=cfg,
                pcfg=pcfg)
    return fc.get_total_flops()


@pytest.mark.parametrize("name,remat", [
    ("gemma-2b", "none"), ("gemma-2b", "dots"), ("gemma-2b", "full"),
    ("qwen3-moe-30b-a3b", "none")])
def test_train_step_flops_are_three_forwards(name, remat):
    """Every product's backward is two products of its size (each operand
    of each product here requires grad), so the train step (the AdamW
    update adds no FLOPs) is 3x the loss's forward exactly at remat "none"
    and "dots" (which saves every product's output), and between 3x and 4x
    at "full" (the layers' forward again, the head's not)."""
    cfg = smoke_config(name)
    pcfg = ParallelConfig(remat=remat, logits_chunk=0)
    fwd = _forward_flops(cfg, pcfg)
    step = D.trace_step(cfg, SMOKE_TRAIN, pcfg)["flops"]
    assert fwd > 0
    if remat == "full":
        assert 3 * fwd < step < 4 * fwd
    else:
        assert step == 3 * fwd


def test_prefill_flops_are_the_count_from_the_shapes():
    """gemma-2b's smoke prefill (direct attention at S 32): per layer the
    q/k/v/o projections, QK^T and PV over all S x S pairs, the three MLP
    products; then the tied head of the last token only."""
    cfg = smoke_config("gemma-2b")
    B, S = 2, 32
    T = B * S
    d, H, KV, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.d_ff)
    layer = (2 * T * d * H * hd * 2 + 2 * T * d * KV * hd * 2
             + 2 * 2 * B * H * S * S * hd + 3 * 2 * T * d * ff)
    want = cfg.num_layers * layer + 2 * B * d * cfg.vocab_size
    got = D.trace_step(cfg, ShapeConfig("p", S, B, "prefill"),
                       ParallelConfig())
    assert got["flops"] == want
    # bf16 weights, the fp32 norm scales (two a layer and the final one)
    # at 4 bytes, int64 token ids
    norms = (2 * cfg.num_layers + 1) * d
    assert got["args"] == P.count_params(cfg) * 2 + norms * 2 + B * S * 8


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_scaled_scans_equal_a_whole_trace(kind):
    """xLSTM's per-step scans (an mLSTM and an sLSTM layer of the smoke
    widths) traced at 2 and 4 steps and carried to S 24 give the whole
    trace's FLOPs and bytes exactly (each step runs the same ops) and its
    temps' peak within 10%."""
    cfg = smoke_config("xlstm-1.3b").replace(num_layers=2,
                                             block_pattern=("mlstm", "slstm"))
    shape = ShapeConfig("s", 24, 2, kind)
    pcfg = ParallelConfig(logits_chunk=0)
    scaled = D.measure(cfg, shape, pcfg)
    whole = D.trace_step(cfg, shape, pcfg)
    assert scaled["scaled"] and not whole["cut"]
    assert {s["block"] for s in scaled["scaled"]} == {"mlstm", "slstm"}
    assert scaled["flops"] == whole["flops"]
    assert scaled["bytes"] == whole["bytes"]
    assert abs(scaled["temp"] - whole["temp"]) <= 0.1 * whole["temp"]


@pytest.mark.parametrize("name,kind,layers", [
    ("gemma-2b", "train", 5), ("gemma-2b", "prefill", 5),
    ("gemma-2b", "decode", 5), ("qwen3-moe-30b-a3b", "train", 4),
    ("xlstm-1.3b", "train", 6)])
def test_depth_cut_equals_a_whole_trace(name, kind, layers):
    """A config traced at 1 and 2 repeats of its most repeated segment
    and carried to its depth gives the whole trace's FLOPs and bytes
    exactly and its temps' peak within 10%; xLSTM (an mLSTM and an sLSTM
    a repeat) cuts its scans at the same time."""
    cfg = smoke_config(name).replace(num_layers=layers)
    if name == "xlstm-1.3b":
        cfg = cfg.replace(block_pattern=("mlstm", "slstm"))
    shape = ShapeConfig("s", 16, 2, kind)
    pcfg = ParallelConfig(logits_chunk=0)
    cut = D.measure(cfg, shape, pcfg)
    whole = D.trace_step(cfg, shape, pcfg)
    assert cut["scaled"][0]["block"] == "layers"
    assert cut["scaled"][0]["repeats"] == D._depth_plan(cfg)[1] > 2
    assert cut["flops"] == whole["flops"] and cut["bytes"] == whole["bytes"]
    assert cut["args"] == whole["args"]
    assert abs(cut["temp"] - whole["temp"]) <= 0.1 * whole["temp"]


def test_a_kernel_config_raises_on_meta_tensors():
    with pytest.raises(ValueError, match="kernel=None"):
        D.run_cell("gemma-2b", "prefill_32k", CARD, ParallelConfig(
            kernel=KernelConfig(use_flash=True)))
    cfg = smoke_config("gemma-2b")
    pcfg = ParallelConfig(kernel=KernelConfig(use_decode=True))
    with pytest.raises(ValueError, match="meta"):
        D.trace_step(cfg, ShapeConfig("d", 32, 2, "decode"), pcfg)


def test_a_cell_record_has_the_reference_parts():
    """A decode cell at full size, traced on meta tensors: the record's
    status, memory against the card, roofline keys, the skip of
    long_500k for a full-attention arch; mesh rules change no shape."""
    rec = D.run_cell("gemma-2b", "decode_32k", CARD)
    assert rec["status"] == "ok" and rec["mesh"] == CARD_KEY
    mem = rec["memory"]
    assert mem["card_bytes"] == card_memory(CARD)
    assert mem["peak_live_bytes"] == (mem["argument_size_in_bytes"]
                                      + mem["temp_size_in_bytes"])
    assert rec["roofline"]["model_flops"] == model_flops_for(
        get_arch("gemma-2b"), SHAPES_BY_NAME["decode_32k"])
    assert rec["by_formula"] == []
    assert rec["scaled"] == [{"block": "layers", "segment": ["attn"],
                              "repeats": 18, "traced": [1, 2],
                              "counts": rec["scaled"][0]["counts"]}]
    assert D.run_cell("gemma-2b", "long_500k", CARD)["status"] == "skip"
    ruled = D.run_cell("gemma-2b", "decode_32k", CARD, ParallelConfig(
        param_rules={**DEFAULT_PARAM_RULES, "embed": None}))
    assert ruled["one_card_noop"] == ["param_rules"]
    assert ruled["memory"] == mem and ruled["roofline"] == rec["roofline"]


# -- the sharding rules -----------------------------------------------------

class FakeMesh:
    """Duck-typed mesh: resolve_spec only needs axis_names + devices.shape."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(tuple(axes.values()))


@pytest.mark.parametrize("shape,logical,rules,axes", [
    ((1024, 1, 128), ("embed", "kv_heads", "head_dim"), "param",
     dict(data=16, model=16)),
    ((256, 4096), ("vocab", "mlp"), {"vocab": "model", "mlp": "model"},
     dict(data=16, model=16)),
    ((256, 128), ("act_batch", None), "act", dict(pod=2, data=16, model=16)),
    ((8, 128), ("act_batch", None), "act", dict(pod=2, data=16, model=16)),
    ((256, 128), ("act_batch", None), "act", dict(data=4, model=2)),
    ((64, 2048, 8, 256), ("act_batch", "act_seq", "act_kv_heads", None),
     "act", dict(data=16, model=16)),
], ids=["drops-indivisible", "no-axis-reuse", "tuple-axes", "tuple-partial",
        "missing-axis", "kv-cache"])
def test_resolve_spec_matches_the_reference(shape, logical, rules, axes):
    """The reference's cases (tests/test_sharding.py) and a KV cache's."""
    mesh = FakeMesh(**axes)
    mine = {"param": DEFAULT_PARAM_RULES, "act": DEFAULT_ACT_RULES}.get(
        rules, rules) if isinstance(rules, str) else rules
    theirs = {"param": J_PARAM_RULES, "act": J_ACT_RULES}.get(
        rules, rules) if isinstance(rules, str) else rules
    assert mine == theirs
    assert resolve_spec(shape, logical, mine, mesh) == tuple(
        jax_resolve_spec(shape, logical, theirs, mesh))
    assert ParallelConfig().param_rules == JaxParallelConfig().param_rules


@pytest.mark.parametrize("arch,shape", [
    ("gemma-2b", "train_4k"), ("gemma-2b", "prefill_32k"),
    ("qwen3-moe-30b-a3b", "decode_32k"), ("xlstm-1.3b", "long_500k")])
def test_hard_sharding_fingerprints_match_the_reference(arch, shape):
    objective = f"dryrun[{arch}×{shape}×{CARD_KEY}]"
    mine = sharding_space(arch, shape, hard=True)
    theirs = jax_sharding_space(arch, shape, hard=True)
    assert mine.name == theirs.name == f"sharding_hard[{arch}×{shape}]"
    assert SpaceFingerprint.of(mine, objective=objective).digest == \
        JaxSpaceFingerprint.of(theirs, objective=objective).digest


def test_parallel_config_has_the_reference_fields_and_defaults():
    import dataclasses
    mine = {f.name for f in dataclasses.fields(ParallelConfig)}
    theirs = {f.name for f in dataclasses.fields(JaxParallelConfig)}
    assert theirs - mine == {"scan_layers"} and mine <= theirs
    for f in mine - {"kernel"}:
        assert getattr(ParallelConfig(), f) == getattr(JaxParallelConfig(), f)


# -- the objective ----------------------------------------------------------

def test_dryrun_objective_on_a_smoke_config(tmp_path):
    """gemma-2b's smoke config at the prefill_32k cell (B 32 x S 32,768)
    for the named card: the direct attention's scores (B x H x S^2 fp32,
    550 GB) do not fit, so flash=0 is NaN; the blockwise attention over
    KV blocks of 512 fits and gives the roofline step time; a second call is a cache hit; the
    key names the card; the daemon services that key and raises for the
    reference's pod mesh."""
    obj = DryRunObjective("gemma-2b", "prefill_32k", card=CARD,
                          cache_dir=str(tmp_path / "cache"), verbose=False,
                          arch_cfg=smoke_config("gemma-2b"))
    assert obj.name == f"dryrun[gemma-2b×prefill_32k×{CARD_KEY}]"
    assert obj.space.size == 324
    idx = {}
    for i in range(obj.space.size):
        c = obj.space.config(i)
        if (c["attn_q_chunks"], c["attn_block_kv"], c["flash"]) in (
                (1, 2048, 0), (1, 512, 1)):
            idx.setdefault(c["flash"], i)
    bad, good = obj(idx[0]), obj(idx[1])
    assert math.isnan(bad)
    rec = obj.record_for(obj.space.config(idx[0]))
    assert rec["status"] == "ok"
    assert rec["memory"]["peak_live_bytes"] > card_memory(CARD)
    assert good > 0 and obj.traced == 2
    assert obj(idx[1]) == good and obj.traced == 2      # the cache
    assert len(os.listdir(tmp_path / "cache")) == 2
    with pytest.raises(ValueError, match="pod"):
        retune.dryrun_objective_for(
            "dryrun[gemma-2b×prefill_32k×single]", card=CARD)
    with pytest.raises(ValueError, match="keyed for"):
        retune.dryrun_objective_for(
            "dryrun[gemma-2b×prefill_32k×cuda-Other_card]", card=CARD)
    with pytest.raises(ValueError, match="CPU"):
        retune.dryrun_objective_for(obj.name, device="cpu")
    served = retune.dryrun_objective_for(
        obj.name, card=CARD, cache_dir=str(tmp_path / "cache"))
    assert served.name == obj.name and served.mesh == CARD_KEY


def test_the_cli_with_no_card_names_it(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gemma-2b", "--shape", "decode_32k",
                        "--out", str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert "no CUDA card present" in r.stderr and "--card" in r.stderr
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gemma-2b", "--shape", "decode_32k",
                        "--card", CARD, "--out", str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert os.listdir(tmp_path) == [
        f"baseline__gemma-2b__decode_32k__{CARD_KEY}.json"]
