"""Training on a device mesh (``launch/mesh.py``, ``parallel/sharding.py``,
DTensor placements) on the CPU, over gloo: the placements the reference's
rules give, ``block_local``'s split of a block's names, qwen3-moe's
sharded steps against the reference's own sharded steps on 8 devices (its
dispatch groups included), gemma-2b's sharded step against the port's
unsharded one, the elastic restore onto another mesh and onto none, and
every family's step on a one-rank mesh. The ranks' bodies are in
``torch_mesh_ranks.py``; the other families against the reference are in
``test_torch_mesh_families.py`` and ``test_torch_mesh_recurrent.py``.
"""
import jax
import numpy as np
import pytest

import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import params as jax_params
from repro.parallel import sharding as JS

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.stepfn import make_train_step
from repro_torch.optim.optimizers import AdamW, constant_lr
from repro_torch.parallel.sharding import (DEFAULT_ACT_RULES,
                                           DEFAULT_PARAM_RULES,
                                           ParallelConfig, ShardCtx,
                                           block_split, param_shardings,
                                           placements, resolve_spec)

import torch_mesh_parity as MP
import torch_mesh_ranks as R
from torch_train_parity import (LOSS_RTOL, assert_grads_close,
                                assert_updates_close)


class FakeMesh:
    """Both meshes' views of one shape: a JAX mesh's ``axis_names`` and
    ``devices.shape``, a DeviceMesh's ``mesh_dim_names`` and ``shape``."""

    def __init__(self, **axes):
        self.axis_names = self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self.devices = np.empty(self.shape)


# -- placements (no process group) ---------------------------------------------


@pytest.mark.parametrize("shape,logical,rules,axes,want", [
    # one axis; kv_heads 1 cannot split over model 16
    ((1024, 1, 128), ("embed", "kv_heads", "head_dim"), DEFAULT_PARAM_RULES,
     dict(data=16, model=16), (Shard(0), Replicate())),
    # both dims want model: only the first gets it
    ((256, 4096), ("vocab", "mlp"), {"vocab": "model", "mlp": "model"},
     dict(data=16, model=16), (Replicate(), Shard(0))),
    # a tuple of axes shards one dim over both, in mesh order
    ((256, 128), ("act_batch", None), DEFAULT_ACT_RULES,
     dict(pod=2, data=16, model=16), (Shard(0), Shard(0), Replicate())),
    # batch 8 splits over pod but not over pod x data
    ((8, 128), ("act_batch", None), DEFAULT_ACT_RULES,
     dict(pod=2, data=16, model=16), (Shard(0), Replicate(), Replicate())),
    # no pod axis: the tuple falls back to data
    ((256, 128), ("act_batch", None), DEFAULT_ACT_RULES,
     dict(data=4, model=2), (Shard(0), Replicate())),
    # a mesh dim of size 1 replicates
    ((8, 64, 16), ("act_batch", "act_seq", "act_heads"), DEFAULT_ACT_RULES,
     dict(data=1, model=2), (Replicate(), Shard(2))),
], ids=["one-axis", "no-reuse", "tuple", "tuple-drops", "no-pod", "size-1"])
def test_placements_of_resolved_specs(shape, logical, rules, axes, want):
    """The spec is the reference's ``resolve_spec``'s, and its placements
    are one a mesh dim (``tests/test_sharding.py``'s cases)."""
    mesh = FakeMesh(**axes)
    spec = resolve_spec(shape, logical, rules, mesh)
    assert spec == tuple(JS.resolve_spec(shape, logical, rules, mesh))
    assert placements(spec, mesh) == want


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_param_shardings_are_the_references(name):
    """Every leaf of the full config over the reference's (pod 2, data 16,
    model 16) mesh: the port's per-layer spec resolves as the reference's
    stacked one after its ``layers`` axis (rule None), leaf name by leaf
    name, and ``param_shardings`` places it so."""
    mesh = FakeMesh(pod=2, data=16, model=16)
    pcfg = ParallelConfig()
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            jax_params.model_specs(jax_get_arch(name)),
            is_leaf=jax_params.is_spec)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        spec = tuple(JS.resolve_spec(s.shape, s.logical,
                                     JS.DEFAULT_PARAM_RULES, mesh))
        if keys[0] == "segments":       # (segments, i, "j:kind", ...)
            assert spec[:1] in ((), (None,))
            keys, spec = keys[3:], spec[1:]
        want.setdefault(keys, set()).add(spec)
    specs = P.model_specs(get_arch(name))
    placed = dict(P.leaves(param_shardings(specs, mesh, pcfg)))
    got = {}
    for path, s in P.leaves(specs):
        spec = resolve_spec(s.shape, s.logical, pcfg.param_rules, mesh)
        assert placed[path] == (mesh, placements(spec, mesh))
        got.setdefault(path[2:] if path[0] == "layers" else path,
                       set()).add(spec)
    assert got == want


def test_make_host_mesh_needs_its_ranks(monkeypatch):
    """No process group, or a world that is not the mesh's product,
    raises; the card is the default device."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(data=2, device="cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    with pytest.raises(RuntimeError, match="need 8 ranks, have 4"):
        make_host_mesh(data=4, model=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(data=2, model=2)


@pytest.mark.parametrize("dims,axes,want", [
    # channels and the gates' blocks share a name: 8 blocks divide over
    # model 2, so both split; 3 blocks do not, so the channels are whole
    ({"act_batch": [8], "act_mlp": [64, 8]}, dict(data=2, model=2),
     {"act_batch": ("data",), "act_mlp": ("model",)}),
    ({"act_batch": [8], "act_mlp": [64, 3]}, dict(data=2, model=2),
     {"act_batch": ("data",), "act_mlp": ()}),
    # a mesh axis splits one name: heads take model, the KV heads none
    ({"act_heads": [4], "act_kv_heads": [4]}, dict(data=2, model=2),
     {"act_heads": ("model",), "act_kv_heads": ()}),
    # rows over pod x data where they divide, else over pod alone
    ({"act_batch": [8, 8]}, dict(pod=2, data=2, model=2),
     {"act_batch": ("pod", "data")}),
    ({"act_batch": [8, 6]}, dict(pod=2, data=2, model=2),
     {"act_batch": ("pod",)}),
], ids=["channels-blocks", "blocks-do-not-divide", "one-name-an-axis",
        "rows-pod-data", "rows-pod"])
def test_block_split_of_logical_names(dims, axes, want):
    """``block_local``'s split of a block's logical names over a mesh."""
    assert block_split(dims, DEFAULT_ACT_RULES, FakeMesh(**axes)) == want


ONE_RANK = [("deepseek-v3-671b", {}), ("recurrentgemma-9b", {}),
            ("xlstm-1.3b", {}), ("musicgen-large", {}),
            ("qwen3-moe-30b-a3b", {"microbatches": 2})]


@pytest.mark.parametrize("name,pkw", ONE_RANK,
                         ids=[R.tag(*r) for r in ONE_RANK])
def test_families_train_on_a_one_rank_mesh(tmp_path, name, pkw):
    """The four families the port once refused on a mesh, and microbatches
    on one, take a train step on a one-rank gloo mesh (every weight,
    moment and batch leaf a DTensor): its loss and updates are those of
    the step off the mesh (a 1 x 1 mesh replicates every placement)."""
    import torch.distributed as dist
    from repro_torch.models.stepfn import place_batch
    cfg = smoke_config(name).replace(dtype="float32")
    pcfg = ParallelConfig(flash_threshold=1 << 30, logits_chunk=0, **pkw)
    batch = R.batch_torch(R.batch_np(cfg, 4, 32))
    before = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = {}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        px = ShardCtx(make_host_mesh(device="cpu"), pcfg)
        for side, ctx in (("off", None), ("on", px)):
            params = P.map_tree(torch.clone, before)
            b = batch
            if ctx is not None:
                params = P.shard_params(params, P.model_specs(cfg),
                                        px.mesh, pcfg)
                b = place_batch(batch, px)
            opt = AdamW(schedule=constant_lr(1e-3))
            step = make_train_step(cfg, pcfg, opt, px=ctx)
            params, _, m = step(params, opt.init(params), b, 0)
            got[side] = (float(m["loss"]), R._whole(params))
    finally:
        dist.destroy_process_group()
    (on, p_on), (off, p_off) = got["on"], got["off"]
    assert abs(on - off) <= LOSS_RTOL * abs(off), (on, off)
    assert_updates_close({p: t.numpy() for p, t in P.leaves(before)}, p_on,
                         {p: t.numpy() for p, t in p_off.items()})


def test_moe_groups_are_data_times_pod():
    """The reference's G = data x pod dispatch groups, 1 where the tokens
    are not a whole number of them, and 1 off a mesh."""
    pcfg = ParallelConfig()
    px = ShardCtx(FakeMesh(pod=2, data=4, model=2), pcfg)
    assert L.moe_groups(64, px) == 8 and L.moe_groups(60, px) == 1
    assert L.moe_groups(64, ShardCtx(FakeMesh(data=2, model=4), pcfg)) == 2
    assert L.moe_groups(64, ShardCtx(None, pcfg)) == 1
    assert L.moe_groups(64, None) == 1


# -- gemma-2b (and a dense config of 4 KV heads), sharded against unsharded ---


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    """One group of 4 ranks: the sharded and unsharded steps of gemma-2b
    and internlm2-1.8b, then gemma-2b's elastic restore."""
    tmp = tmp_path_factory.mktemp("dense")
    out = str(tmp / "out")
    R.spawn(R.dense_job, 4, tmp, ["gemma-2b", "internlm2-1.8b"],
            str(tmp / "ckpt"), out)
    return torch.load(out + ".steps"), torch.load(out + ".restore")


@pytest.mark.parametrize("name", ["gemma-2b", "internlm2-1.8b"])
def test_sharded_step_equals_the_unsharded_step(dense_runs, name):
    """data 2 x model 2 over 4 ranks: the loss within LOSS_RTOL, every
    gradient leaf within the train tests' rule, each weight's AdamW update
    and first moment within 1e-3 of their norms."""
    got = dense_runs[0][name]
    s, u = got["sharded"], got["unsharded"]
    assert abs(s["loss"] - u["loss"]) <= LOSS_RTOL * abs(u["loss"])
    assert_grads_close(s["grads"], {p: g.numpy() for p, g in
                                    u["grads"].items()})
    cfg = smoke_config(name).replace(dtype="float32")
    before = {p: t.numpy() for p, t in P.leaves(P.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))}
    assert_updates_close(before, s["params"], {p: t.numpy() for p, t in
                                               u["params"].items()})
    zeros = {p: np.zeros(t.shape) for p, t in u["moments"].items()}
    assert_updates_close(zeros, s["moments"], {p: t.numpy() for p, t in
                                               u["moments"].items()})


def test_sharded_adafactor_equals_the_unsharded(dense_runs):
    """gemma-2b, one Adafactor step (the reference's layer stacks) after
    the AdamW step, on DTensor weights: the weights' updates and every
    state leaf (rows, columns, stacked) within 1e-3 of their norms of the
    unsharded step's."""
    s, u = (dense_runs[0]["gemma-2b"][k]["adafactor"]
            for k in ("sharded", "unsharded"))
    before = dense_runs[0]["gemma-2b"]["unsharded"]["params"]
    assert_updates_close({p: t.numpy() for p, t in before.items()},
                         s["params"], {p: t.numpy() for p, t in
                                       u["params"].items()})
    assert sorted(s["state"]) == sorted(u["state"])
    assert_updates_close({p: np.zeros(t.shape) for p, t in
                          u["state"].items()}, s["state"],
                         {p: t.numpy() for p, t in u["state"].items()})


def test_elastic_restore_onto_another_mesh_and_none(dense_runs):
    """A TrainLoop saved on (data 2, model 2) restores onto (data 4,
    model 1) and onto no mesh: every leaf, weights and moments and count,
    bit for bit, at the saved step; on each mesh the leaves are sharded."""
    res = dense_runs[1]
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["equal"] == {"data=4,model=1": (2, True, True),
                            "no mesh": (2, True, True)}
    assert "(Shard(dim=0), Replicate())" in res["placements"][
        "data=4,model=1"]
    assert res["placements"]["no mesh"] == []


# -- qwen3-moe against the reference's sharded steps ---------------------------

MOE = "qwen3-moe-30b-a3b"


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The reference's two sharded steps (8 forced host devices, one
    subprocess) and the port's on 8 gloo ranks, started together, from
    the reference's weights on the same tokens
    (``torch_mesh_parity.run_both``)."""
    return MP.run_both(tmp_path_factory.mktemp("moe"), 4, 2,
                       [(MOE, {})])[MOE]


def test_moe_sharded_losses_match_the_references(moe_runs):
    """data 4 x model 2: both steps' losses within LOSS_RTOL of the
    reference's on its 8-device mesh (dispatch in 4 groups on both)."""
    MP.assert_losses_match(moe_runs, 8)


def test_moe_sharded_updates_match_the_references(moe_runs):
    MP.assert_updates_match(moe_runs)


def test_dispatch_groups_drop_what_one_group_keeps(moe_runs):
    """The first MoE layer's input on the run's tokens, routed in the mesh
    run's 4 groups and in 1: some (token, k) copy 4 groups drop is kept by
    one group, so the groups decide which copies drop."""
    cfg = smoke_config(MOE).replace(dtype="float32")
    params = P.map_tree_paths(P.model_specs(cfg), {
        p: torch.from_numpy(a) for p, a in moe_runs["before"].items()})
    lp = params["layers"][0]
    tk = torch.from_numpy(R.batch_np(cfg, 8, 32)["tokens"]).long()
    B, S = tk.shape
    pos = torch.arange(S)[None, :].expand(B, S)
    pcfg = ParallelConfig(flash_threshold=1 << 30)
    x = params["embed"]["table"][tk]
    h = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
    a, _ = L.gqa_attention(lp["attn"], h, cfg=cfg, pcfg=pcfg, mode="train",
                           cache=None, positions=pos)
    h2 = L.rms_norm(x + a, lp["ln2"]["scale"], cfg.norm_eps)
    dropped = {}
    for G in (1, 4):
        Tg = B * S // G
        C = L.moe_capacity(Tg, cfg, pcfg)
        _, _, _, keep, _, _ = L.moe_route(lp["moe"], h2.reshape(G, Tg, -1),
                                          cfg=cfg, C=C)
        dropped[G] = {(g * Tg * cfg.moe.top_k + int(i)) for g, row in
                      enumerate(~keep) for i in torch.nonzero(row)[:, 0]}
    assert dropped[4] - dropped[1], dropped
