"""The dry-run on a mesh of cards against the JAX package, on the CPU.

The port's sharded step is traced on meta DTensors as rank 0 of a fake
world (``launch/mesh.fake_mesh``), in a subprocess for each test
(``tests/torch_dryrun_mesh_jobs.py``: a process holds one default group,
and a test worker holds none). The reference compiles its sharded step on
8 forced host devices in another subprocess. Held here, at smoke widths:

  * per-device argument bytes on (data 2, model 4) equal the reference's
    ``compiled.memory_analysis()``, but for the token ids (int64 in the
    port, int32 in the reference) and the reference's int32 ``step``
    scalar (a Python int in the port); the two packages' collectives by
    kind are printed side by side, not gated (GSPMD and DTensor choose
    different ones);
  * on (data N, model 1) a rank's FLOPs x N equal one card's, and with
    the weights replicated (``embed`` rule None) the collective bytes are
    the gradients' bytes and a few fp32 scalars, none across nodes at
    N <= 8 and all of them at N 16;
  * the depth cut (``measure``) equals a whole trace on a mesh;
  * the ``embed`` rule moves per-device arguments as ``resolve_spec`` says;
  * a 1 x 1 mesh equals the one-card record;
  * the scans carried from 4 and 8 steps equal a whole trace under every
    remat policy and in a prefill (the peak site by site);
  * the production meshes, the roofline's collective term, the objective
    keyed by mesh and card, and the CLI on gemma-2b's ``train_4k`` at full
    width on both meshes.
"""
import json
import math
import os
import socket
import subprocess
import sys
import textwrap

import pytest

import torch

from repro_torch.configs.arch import ShapeConfig
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.core.tuning_targets import DryRunObjective
from repro_torch.launch import dryrun as D
from repro_torch.launch import retune
from repro_torch.launch.roofline import (CARD, IB_BW, NODE_CARDS, NVLINK_BW,
                                         Roofline, links_for)
from repro_torch.models.params import DTYPES, leaves, model_specs
from repro_torch.parallel.sharding import (DEFAULT_PARAM_RULES,
                                           ParallelConfig, resolve_spec)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, "tests", "torch_dryrun_mesh_jobs.py")
KIND = "cuda-NVIDIA_H100_80GB_HBM3"


def _jobs(*specs):
    """Run the port's jobs in one subprocess; their results in order."""
    r = subprocess.run([sys.executable, JOBS, json.dumps(list(specs))],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=os.path.join(ROOT,
                                                                    "src")))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _leaf_bytes(spec, cfg) -> int:
    return math.prod(spec.shape) * torch.empty(
        (), dtype=DTYPES[spec.dtype or cfg.dtype]).element_size()


# -- the roofline and the meshes -------------------------------------------

def test_roofline_on_a_mesh_has_the_two_tier_collective_term():
    """The reference's terms: each count the sum over the cards; the
    collective bytes within a node at NVLink's rate, those across nodes at
    InfiniBand's, each over the cards; one card unchanged."""
    chips, coll, dcn = 256, 9e12, 1e12
    r = Roofline(flops=989e12 * chips, hbm_bytes=3.35e12 * chips,
                 coll_bytes=coll, dcn_bytes=dcn, chips=chips)
    assert links_for(CARD) == (NVLINK_BW, IB_BW) == (450e9, 50e9)
    assert NODE_CARDS == 8
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    want = (coll - dcn) / (chips * NVLINK_BW) + dcn / (chips * IB_BW)
    assert r.t_collective == pytest.approx(want)
    assert r.to_dict()["t_collective"] == r.t_collective
    one = Roofline(flops=989e12, hbm_bytes=6.7e12)
    assert one.t_collective == 0 and one.step_time == pytest.approx(2.0)
    for bad in (dict(coll_bytes=1.0, dcn_bytes=2.0, chips=8),
                dict(coll_bytes=1.0), dict(chips=0)):
        with pytest.raises(ValueError):
            Roofline(flops=1.0, hbm_bytes=1.0, **bad)
    with pytest.raises(ValueError):
        links_for("TPU v5e")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_the_production_meshes_of_the_card():
    """single: (data 32, model 8), 256 ranks; multi: (pod 2, data 32,
    model 8), 512; model groups inside a node of 8, data and pod groups
    across nodes; each fake world closed after, and refused beside a
    process group."""
    (out,) = _jobs({"job": "meshes", "port": _free_port()})
    single, multi = out["single"], out["multi"]
    assert single["shape"] == [32, 8] and single["axes"] == ["data", "model"]
    assert multi["shape"] == [2, 32, 8]
    assert multi["axes"] == ["pod", "data", "model"]
    assert single["device"] == multi["device"] == "cuda"
    assert single["groups"]["model"] == list(range(8))
    assert single["groups"]["data"] == list(range(0, 256, 8))
    assert multi["groups"]["pod"] == [0, 256]
    assert single["closed"] and multi["closed"]
    assert "beside a process group" in out["refused"]


# -- per-device arguments against the reference ------------------------------

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    import jax
    from repro.configs.arch import ShapeConfig
    from repro.configs.registry import smoke_config
    from repro.launch import hlo_cost
    from repro.launch.mesh import make_host_mesh
    from repro.launch.specs import input_specs
    from repro.models.stepfn import make_decode_step, make_train_step
    from repro.optim.optimizers import AdamW, constant_lr
    from repro.parallel.sharding import (DEFAULT_ACT_RULES, ParallelConfig,
                                         ShardCtx)
    out = []
    for cell in json.loads(sys.argv[1]):
        cfg = smoke_config(cell["arch"])
        mesh = make_host_mesh(data=2, model=4)
        pcfg = ParallelConfig(logits_chunk=0, act_rules={
            **DEFAULT_ACT_RULES, **cell["rules"]})
        px = ShardCtx(mesh, pcfg)
        opt = AdamW(schedule=constant_lr(1e-4))
        specs = input_specs(cfg, ShapeConfig("s", 16, 8, cell["kind"]), mesh,
                            pcfg, optimizer=opt)
        if cell["kind"] == "train":
            step = jax.jit(make_train_step(cfg, px, opt),
                           donate_argnums=(0, 1))
            args = (specs["params"], specs["opt_state"], specs["batch"],
                    specs["step"])
        else:
            step = jax.jit(make_decode_step(cfg, px), donate_argnums=(1,))
            args = (specs["params"], specs["cache"], specs["batch"],
                    specs["pos"])
        comp = step.lower(*args).compile()
        out.append({
            "args": int(comp.memory_analysis().argument_size_in_bytes),
            "coll_by_kind": hlo_cost.analyze(comp.as_text())["coll_by_kind"]})
    print(json.dumps(out))
""")

#: (arch, step kind, act_rules overrides): a dense and a MoE train cell
#: under the default rules, then the sequence rules: the train cell's
#: batch split along its sequence (act_seq), and decode cells whose KV or
#: latent cache is split along its slots (act_cache_seq)
ARG_CELLS = [pytest.param("gemma-2b", "train", {}, id="gemma-2b"),
             pytest.param("qwen3-moe-30b-a3b", "train", {},
                          id="qwen3-moe-30b-a3b"),
             pytest.param("gemma-2b", "train", {"act_seq": "model"},
                          id="gemma-2b-act_seq"),
             pytest.param("gemma-2b", "decode", {"act_cache_seq": "model"},
                          id="gemma-2b-decode-act_cache_seq"),
             pytest.param("deepseek-v3-671b", "decode",
                          {"act_cache_seq": "model"},
                          id="deepseek-v3-671b-decode-act_cache_seq")]


@pytest.fixture(scope="module")
def arguments_on_2x4():
    cells = [{"arch": c.values[0], "kind": c.values[1], "rules": c.values[2]}
             for c in ARG_CELLS]
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, json.dumps(cells)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    mine = _jobs(*({"job": "trace", "arch": c["arch"], "kind": c["kind"],
                    "rules": c["rules"], "dims": [2, 4]} for c in cells))
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    theirs = json.loads(out.strip().splitlines()[-1])
    return {c.id: (m, t) for c, m, t in zip(ARG_CELLS, mine, theirs)}


@pytest.mark.parametrize("arch,kind,rules", ARG_CELLS)
def test_argument_bytes_per_device_match_the_reference(
        request, arch, kind, rules, arguments_on_2x4):
    """Train and decode cells on (data 2, model 4): parameters, AdamW
    state or cache, and batch, each device's shards, under the default
    rules and the sequence rules. The token ids are int64 here (4 more
    bytes each of a device's B 8 / 2 x S 16, a quarter of them under
    ``act_seq``, one each in decode), and so are the cache's positions
    (4 more bytes each of a device's block); the reference's int32
    ``step`` is a Python int here (4 bytes fewer), and its int32 decode
    position is int64 (4 more)."""
    mine, theirs = arguments_on_2x4[request.node.callspec.id]
    cfg = smoke_config(arch)
    rows = 8 // 2
    if kind == "train":
        tokens = rows * 16 // (4 if rules.get("act_seq") else 1)
        extra = 4 * tokens - 4
    else:
        # a layer's positions: rows x 16 slots, split over model's 4
        slots = 16 // (4 if rules.get("act_cache_seq") else 1)
        extra = 4 * rows + 4 * rows * slots * cfg.num_layers + 4
    assert mine["args"] == theirs["args"] + extra
    print(f"{request.node.callspec.id} collectives a device, port: "
          f"{mine['coll_by_kind']}; reference: {theirs['coll_by_kind']}")
    assert mine["coll"] > 0 and mine["dcn"] == 0


def test_the_sequence_rules_on_the_single_mesh():
    """gemma-2b at full width on ``single`` (data 32, model 8), its one KV
    head split by no head rule: ``decode_32k`` under
    ``act_cache_seq=model`` holds an eighth of the default record's cache
    a card (each rank its block of the 32,768 slots) and gathers the
    partials; under ``act_seq=model`` its one-token step keeps the
    default's cache a card (the cache follows ``act_cache_seq`` only);
    ``prefill_32k`` traces under ``act_seq=model``."""
    (base, cache, seq), (pre,) = _jobs(
        {"job": "rules", "arch": "gemma-2b", "shape": "decode_32k",
         "mesh": "single", "rules": [{}, {"act_cache_seq": "model"},
                                     {"act_seq": "model"}]},
        {"job": "rules", "arch": "gemma-2b", "shape": "prefill_32k",
         "mesh": "single", "rules": [{"act_seq": "model"}]})
    for rec in (base, cache, seq, pre):
        assert rec["status"] == "ok", rec["error"]
    want = base["memory"]["cache_size_in_bytes"]
    assert want > 2 * 10 ** 9
    assert cache["memory"]["cache_size_in_bytes"] * 8 == want
    assert seq["memory"]["cache_size_in_bytes"] == want
    assert (cache["coll_by_kind"]["all-gather"]
            > base["coll_by_kind"]["all-gather"])
    assert pre["memory"]["cache_size_in_bytes"] == 0


# -- data parallel ----------------------------------------------------------

DP_CELLS = [("gemma-2b", "train"), ("qwen3-moe-30b-a3b", "train"),
            ("gemma-2b", "prefill"), ("musicgen-large", "train")]


@pytest.fixture(scope="module")
def data_parallel():
    specs = []
    for arch, kind in DP_CELLS:
        base = {"job": "trace", "arch": arch, "kind": kind, "batch": 16}
        specs += [base, {**base, "dims": [4, 1]}]
    for arch in ("qwen3-moe-30b-a3b", "xlstm-1.3b"):
        for n in (4, 16):
            specs.append({"job": "trace", "arch": arch, "dims": [n, 1],
                          "batch": 16, "embed_rule": "none"})
    out = _jobs(*specs)
    flops = {c: (out[2 * i], out[2 * i + 1]) for i, c in enumerate(DP_CELLS)}
    coll = {(s["arch"], s["dims"][0]): o
            for s, o in zip(specs[2 * len(DP_CELLS):],
                            out[2 * len(DP_CELLS):])}
    return flops, coll


@pytest.mark.parametrize("arch,kind", DP_CELLS)
def test_data_parallel_flops_times_n_equal_one_card(arch, kind,
                                                    data_parallel):
    """On (data 4, model 1) each rank's FLOPs are its rows' share: x 4
    they are the one-card count exactly, the ZeRO-3 weights gathered."""
    one, rank = data_parallel[0][(arch, kind)]
    assert rank["flops"] * 4 == one["flops"] > 0


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-1.3b"])
@pytest.mark.parametrize("n", [4, 16])
def test_data_parallel_collectives_are_the_gradient_bytes(arch, n,
                                                          data_parallel):
    """Weights replicated (``embed`` None) and rows split over data: the
    step's collectives are one all-reduce of each gradient (its bytes in
    the weight's dtype) and of a few fp32 scalars (the loss's sum and
    token count, the MoE aux, each a 4-byte operand). A node holds 8
    cards: at N 4 none crosses nodes, at N 16 every one does."""
    rank = data_parallel[1][(arch, n)]
    cfg = smoke_config(arch)
    grads = sum(_leaf_bytes(s, cfg) for _, s in leaves(model_specs(cfg)))
    scalars = rank["coll"] - grads
    assert set(rank["coll_by_kind"]) == {"all-reduce"}
    assert 0 < scalars <= 32 and scalars % 4 == 0
    assert rank["dcn"] == (rank["coll"] if n > NODE_CARDS else 0)


# -- the cuts, the rules, one rank ------------------------------------------

@pytest.mark.parametrize("arch,kind,layers", [
    ("gemma-2b", "train", 5), ("qwen3-moe-30b-a3b", "train", 4),
    ("gemma-2b", "decode", 5), ("recurrentgemma-9b", "prefill", 9)])
def test_depth_cut_equals_a_whole_trace_on_a_mesh(arch, kind, layers):
    """On (data 2, model 2): FLOPs, bytes, arguments and collective bytes
    (total, across nodes, by kind) carried from 1 and 2 repeats equal a
    whole trace's; the temps' peak within 10%, as on one card."""
    (out,) = _jobs({"job": "cut", "arch": arch, "kind": kind,
                    "layers": layers, "dims": [2, 2]})
    cut, whole = out["cut"], out["whole"]
    assert out["scaled"][0]["block"] == "layers"
    for k in ("flops", "bytes", "args", "coll", "dcn", "coll_by_kind"):
        assert cut[k] == whole[k], k
    assert whole["coll"] > 0
    assert abs(cut["temp"] - whole["temp"]) <= 0.1 * whole["temp"]


def test_the_embed_rule_moves_arguments_as_the_rules_say():
    """gemma-2b's smoke train cell on (data 2, model 2) with ZeRO-3 (the
    ``embed`` rule on ``data``) and without: each weight and both AdamW
    moments hold the shard ``resolve_spec`` gives, the batch the same
    rows either way."""
    cfg = smoke_config("gemma-2b")
    zero3, whole = _jobs(
        {"job": "trace", "arch": "gemma-2b", "dims": [2, 2]},
        {"job": "trace", "arch": "gemma-2b", "dims": [2, 2],
         "embed_rule": "none"})

    class Mesh:
        axis_names = ("data", "model")

        class devices:
            shape = (2, 2)
    sizes = dict(zip(Mesh.axis_names, Mesh.devices.shape))

    def state_bytes(rules):
        out = 0
        for _, s in leaves(model_specs(cfg)):
            spec = resolve_spec(s.shape, s.logical, rules, Mesh)
            split = math.prod(sizes[a] for ax in spec if ax is not None
                              for a in ((ax,) if isinstance(ax, str)
                                        else ax))
            w = _leaf_bytes(s, cfg) // split
            out += w + 2 * w * 4 // torch.empty(
                (), dtype=DTYPES[s.dtype or cfg.dtype]).element_size()
        return out
    none = {**DEFAULT_PARAM_RULES, "embed": None}
    assert whole["args"] - zero3["args"] == (state_bytes(none)
                                             - state_bytes(
                                                 DEFAULT_PARAM_RULES))
    assert whole["args"] > zero3["args"]


def test_a_one_rank_mesh_equals_the_one_card_record():
    """gemma-2b's smoke config at the ``train_1k_b4`` cell (phase 14's B 4
    x S 1,024 on the card) on a 1 x 1 mesh: every placement is
    ``Replicate``, so arguments, temps, FLOPs and bytes equal the one-card
    record's and no collective runs."""
    (out,) = _jobs({"job": "record", "arch": "gemma-2b",
                    "shape": "train_1k_b4", "mesh": [1, 1]})
    mesh, card = out["mesh"], out["card"]
    assert mesh["status"] == card["status"] == "ok"
    assert mesh["mesh"] == "data1-model1" and mesh["chips"] == 1
    assert mesh["memory"] == card["memory"]
    for k in ("flops", "hbm_bytes", "t_compute", "t_memory"):
        assert mesh["roofline"][k] == card["roofline"][k]
    assert mesh["roofline"]["coll_bytes"] == 0
    assert mesh["coll_by_kind"] == {}
    assert card["one_card_noop"] == [] and mesh["mesh_noop"] == []


@pytest.mark.parametrize("kind,remat,chunk", [
    ("train", "none", 32), ("train", "full", 32), ("prefill", "none", 0)])
def test_scans_carried_from_a_few_steps_equal_a_whole_trace(kind, remat,
                                                            chunk):
    """xlstm-1.3b's repeat of 7 mLSTM and an sLSTM layer at smoke widths,
    B 2 x S 64, the per-step scans traced at 4 and 8 steps: FLOPs, bytes
    and the temps' peak equal a whole trace's with and without remat and
    in a prefill. Carried as one peak (the method before) the peak under
    remat missed the whole trace's: the recompute of the steps outgrows,
    at S, a peak that a few steps leave elsewhere; and a site carried
    without its layer lets its repeats in other layers hide its
    growth."""
    pattern = get_arch("xlstm-1.3b").pattern_layers()[0][1]
    cfg = smoke_config("xlstm-1.3b").replace(num_layers=len(pattern),
                                             block_pattern=pattern)
    shape = ShapeConfig("s", 64, 2, kind)
    pcfg = ParallelConfig(logits_chunk=0, flash_threshold=1 << 30,
                          remat=remat, mlstm_chunk=chunk)
    cut = D.measure(cfg, shape, pcfg)
    whole = D.trace_step(cfg, shape, pcfg)
    assert cut["scaled"] and not whole["cut"]
    assert {tuple(s["traced"]) for s in cut["scaled"]} == {(4, 8)}
    assert cut["flops"] == whole["flops"]
    assert cut["bytes"] == whole["bytes"]
    assert cut["temp"] == whole["temp"]


# -- the objective and the CLI ----------------------------------------------

def test_the_objective_on_a_mesh_names_it_and_prices_zero3(tmp_path):
    """gemma-2b's ``train_4k`` on the ``single`` mesh of the card, each
    config traced in a child process: the id names the mesh and the card
    (so a TPU pod's ``single`` record never resolves for it, nor does a
    one-card record), and ZeRO-3 on and off give different step times;
    the retune daemon services the key."""
    obj = DryRunObjective("gemma-2b", "train_4k", mesh="single", card=CARD,
                          cache_dir=str(tmp_path / "cache"), verbose=False)
    assert obj.name == f"dryrun[gemma-2b×train_4k×single-{KIND}]"
    assert DryRunObjective("gemma-2b", "train_4k", card=CARD,
                           cache_dir=str(tmp_path / "c1"),
                           verbose=False).name == \
        f"dryrun[gemma-2b×train_4k×{KIND}]"
    idx = {}
    for i in range(obj.space.size):
        c = obj.space.config(i)
        if (c["remat"], c["attn_q_chunks"], c["logits_chunk"],
                c["attn_block_kv"], c["flash"], c["opt_moment_dtype"],
                c["microbatches"]) == ("full", 1, 2048, 1024, 1,
                                       "float32", 1):
            idx[c["embed_rule"]] = i
    values = {rule: obj(i) for rule, i in idx.items()}
    assert obj.traced == 2
    recs = {rule: obj.record_for(obj.space.config(i))
            for rule, i in idx.items()}
    for rec in recs.values():
        assert rec["status"] == "ok" and rec["chips"] == 256
        assert rec["mesh"] == "single" and rec["card"] == CARD
    assert (recs["none"]["memory"]["argument_size_in_bytes"]
            > recs["data"]["memory"]["argument_size_in_bytes"])
    fits = {rule: rec["fits"] for rule, rec in recs.items()}
    assert fits["data"] and not math.isnan(values["data"])
    assert values["data"] != values["none"]
    print(f"step s: {values}, fits: {fits}")
    served = retune.dryrun_objective_for(
        obj.name, card=CARD, cache_dir=str(tmp_path / "cache"))
    assert served.name == obj.name and served.mesh_name == "single"
    with pytest.raises(ValueError, match="pod"):
        retune.dryrun_objective_for("dryrun[gemma-2b×train_4k×single]",
                                    card=CARD)
    with pytest.raises(ValueError, match="keyed for"):
        retune.dryrun_objective_for(
            "dryrun[gemma-2b×train_4k×single-cuda-Other_card]", card=CARD)
    with pytest.raises(ValueError, match="mesh"):
        DryRunObjective("gemma-2b", "train_4k", mesh="pod", card=CARD)


def test_the_cli_on_both_production_meshes(tmp_path):
    """``--mesh both`` on gemma-2b's ``train_4k`` at full width: a record
    a mesh, ``chips`` 256 and 512, a card's memory, collectives by kind,
    collective bytes, and a roofline whose collective term takes NVLink
    within a node and InfiniBand across."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma-2b", "--shape", "train_4k", "--mesh", "both", "--card", CARD,
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=600, env=dict(os.environ,
                              PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stderr[-4000:]
    for mesh, chips in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / (f"baseline__gemma-2b__train_4k__"
                                      f"{mesh}-{KIND}.json")).read_text())
        assert rec["status"] == "ok" and rec["chips"] == chips
        assert rec["mesh"] == mesh and rec["card"] == CARD
        mem = rec["memory"]
        assert mem["peak_live_bytes"] == (mem["argument_size_in_bytes"]
                                          + mem["temp_size_in_bytes"])
        roof, links = rec["roofline"], rec["links"]
        assert roof["chips"] == chips and roof["coll_bytes"] > 0
        assert sum(rec["coll_by_kind"].values()) * chips == \
            roof["coll_bytes"]
        assert links["ib_bytes"] * chips == roof["dcn_bytes"] > 0
        assert roof["t_collective"] == pytest.approx(
            (roof["coll_bytes"] - roof["dcn_bytes"]) / (chips * NVLINK_BW)
            + roof["dcn_bytes"] / (chips * IB_BW))
        assert rec["mesh_noop"] == [] and "one_card_noop" not in rec
