"""The model families this slice ports, against the JAX package, on the CPU.

Configs, smoke configs and parameter counts of the five configs
(qwen3-moe-30b-a3b, internlm2-1.8b, stablelm-3b, mistral-large-123b,
chameleon-34b) against the reference's; the reference's parameter tree
carried across by ``params_from_jax``; prefill + decode logits of each
smoke model against a live run of the reference, kernels off and on (the
reference's Pallas kernels in interpret mode, the port's plain versions);
and the kernels' plain versions at the shapes the new configs bring (head
dim 80, 12 and 16 query rows per KV head) against the Pallas kernels.
Tolerances: logits as ``test_torch_model.py`` (fp32 1e-4, bf16 5e-3 of
max|logits|), kernels at the reference's fp32 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.kernels import flash_decode as jax_fd
from repro.kernels import ops as jax_ops
from repro.models import params as jax_params
from repro.models.stepfn import make_decode_step as jax_decode_step
from repro.models.stepfn import make_prefill_step as jax_prefill_step
from repro.parallel.sharding import KernelConfig as JaxKernelConfig
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.models.stepfn import make_decode_step, make_prefill_step
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig

NEW = ("qwen3-moe-30b-a3b", "internlm2-1.8b", "stablelm-3b",
       "mistral-large-123b", "chameleon-34b")
DENSE = NEW[1:]
B, S, STEPS = 2, 8, 6
KERNELS = dict(use_flash=True, flash_block_q=8, flash_block_kv=8,
               use_decode=True, decode_block_kv=8, decode_num_splits=2,
               decode_combine="kernel")
TOL = dict(rtol=2e-4, atol=2e-4)


# -- configs and parameters ----------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_config_smoke_config_and_counts_match_the_reference(name):
    cfg, ref = get_arch(name), jax_get_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    small, ref_small = smoke_config(name), jax_smoke_config(name)
    assert dataclasses.asdict(small) == dataclasses.asdict(ref_small)
    for c, r in ((cfg, ref), (small, ref_small)):
        for active in (False, True):
            assert P.count_params(c, active_only=active) == \
                jax_params.count_params(r, active_only=active)
    if cfg.moe is not None:
        assert P.count_params(cfg, active_only=True) < P.count_params(cfg)


def test_the_moe_config_counts_as_its_name_says():
    cfg = get_arch("qwen3-moe-30b-a3b")
    assert P.count_params(cfg) == 30_532_122_624
    assert P.count_params(cfg, active_only=True) == 3_353_032_704
    assert cfg.resolved_head_dim == 128
    assert get_arch("stablelm-3b").resolved_head_dim == 80
    m = get_arch("mistral-large-123b")
    assert m.num_heads // m.num_kv_heads == 12


@pytest.mark.parametrize("dense_first", [0, 1], ids=["moe", "dense_first"])
def test_params_from_jax_carries_every_moe_leaf(dense_first):
    """qwen3's smoke tree, and a variant whose first layer is dense
    (``moe_dense_first``: two segments, ``0:attn_dense`` then ``0:attn``)."""
    ref_cfg = jax_smoke_config("qwen3-moe-30b-a3b")
    cfg = smoke_config("qwen3-moe-30b-a3b")
    if dense_first:
        kw = dict(moe_dense_first=1, num_layers=3, dense_d_ff=80)
        ref_cfg, cfg = ref_cfg.replace(**kw), cfg.replace(**kw)
    tree = jax.tree.map(np.asarray,
                        jax_params.init_params(ref_cfg, jax.random.PRNGKey(0)))
    assert len(tree["segments"]) == 1 + dense_first
    mine = P.params_from_jax(tree, cfg)
    flat = dict(P.leaves(mine))
    assert set(flat) == set(dict(P.leaves(P.model_specs(cfg))))
    n_ref = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(tree))
    assert sum(t.numel() for t in flat.values()) == n_ref == \
        P.count_params(cfg)
    kinds = P.layer_kinds(cfg)
    assert kinds == ["attn_dense"] * dense_first + ["attn"] * (
        cfg.num_layers - dense_first)
    i = 0
    for si, (n_rep, cycle) in enumerate(cfg.pattern_layers()):
        seg = tree["segments"][si][f"0:{cycle[0]}"]
        for r in range(n_rep):
            layer = mine["layers"][i]
            block = "moe" if cycle[0] == "attn" else "mlp"
            assert block in layer and set(layer) == {"ln1", "attn", "ln2",
                                                     block}
            for key, want in seg[block].items():
                np.testing.assert_array_equal(
                    layer[block][key].float().numpy(),
                    want[r].astype(np.float32))
            i += 1
    assert mine["layers"][0]["attn"]["q_norm"]["scale"].dtype == torch.float32
    if dense_first:
        assert mine["layers"][0]["mlp"]["wg"].shape == (64, 80)
    moe = mine["layers"][-1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["wg"].shape) == (8, 64, 96)


# -- end to end against the reference ------------------------------------------

def _prompt(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))


def _jax_run(cfg, tree, kernel):
    px = ShardCtx(None, JaxParallelConfig(flash_threshold=1 << 30,
                                          logits_chunk=0, kernel=kernel))
    params = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(jax_prefill_step(cfg, px, cache_cap=S + STEPS))
    decode = jax.jit(jax_decode_step(cfg, px))
    logits, cache = prefill(params, {"tokens": jnp.asarray(_prompt(cfg))})
    out, toks = [np.asarray(logits, np.float32)], [np.asarray(
        jnp.argmax(logits, -1))]
    for i in range(STEPS):
        logits, cache = decode(params, cache,
                               {"tokens": jnp.asarray(toks[-1])[:, None]},
                               jnp.asarray(S + i, jnp.int32))
        out.append(np.asarray(logits, np.float32))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    return out, toks


def _torch_run(cfg, params, kernel, toks):
    pcfg = ParallelConfig(kernel=kernel)
    prefill = make_prefill_step(cfg, pcfg, cache_cap=S + STEPS)
    decode = make_decode_step(cfg, pcfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(_prompt(cfg))})
    out = [logits.float().numpy()]
    for i in range(STEPS):
        logits, cache = decode(params, cache,
                               {"tokens": torch.tensor(toks[i])[:, None]},
                               S + i)
        out.append(logits.float().numpy())
    return out


def smoke_models_match_jax(name, dtype, kernels, bf16_tol=5e-3):
    """Prefill + STEPS greedy decode steps of the smoke model in both
    packages on the reference's weights, the port teacher-forced on the
    reference's tokens; fp32 within 1e-4 and the same greedy tokens, bf16
    within ``bf16_tol`` of max|logits|."""
    ref_cfg = jax_smoke_config(name).replace(dtype=dtype)
    cfg = smoke_config(name).replace(dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        jax_params.init_params(ref_cfg, jax.random.PRNGKey(0)))
    want, toks = _jax_run(ref_cfg, tree,
                          JaxKernelConfig(**KERNELS) if kernels else None)
    kfa.launches = kfd.split_launches = 0
    got = _torch_run(cfg, P.params_from_jax(tree, cfg),
                     KernelConfig(**KERNELS) if kernels else None, toks)
    assert kfa.launches == kfd.split_launches == 0   # plain versions
    denom = max(float(np.abs(want[0]).max()), 1e-6)
    for step, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        if dtype == "float32":
            assert err <= 1e-4 * denom, (step, err)
            np.testing.assert_array_equal(np.argmax(g, -1), toks[step])
        else:
            assert err <= bf16_tol * denom, (step, err)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", DENSE)
def test_dense_smoke_prefill_and_decode_match_jax(name, kernels):
    smoke_models_match_jax(name, "float32", kernels)


# -- the kernels' plain versions at the new shapes -------------------------------

@pytest.mark.parametrize("B_,S_,H,KV,hd,bq,bkv", [
    (2, 64, 4, 4, 80, 32, 16),         # stablelm's head dim, MHA
    (1, 64, 12, 1, 80, 16, 32),        # hd 80 at G 12
    (1, 64, 16, 1, 32, 32, 32),        # G 16
])
def test_flash_plain_version_at_new_shapes_matches_pallas(B_, S_, H, KV, hd,
                                                          bq, bkv):
    rng = np.random.default_rng(B_ * S_ + H + KV + hd)
    q = rng.normal(size=(B_, S_, H, hd)).astype(np.float32)
    k = rng.normal(size=(B_, S_, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B_, S_, KV, hd)).astype(np.float32)
    G = H // KV
    for causal in (True, False):
        want = np.asarray(jax_ops.flash_attention(
            jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=2)),
            jnp.asarray(np.repeat(v, G, axis=2)), block_q=bq, block_kv=bkv,
            causal=causal, interpret=True))
        got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), block_q=bq,
                                  block_kv=bkv, causal=causal)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("H,KV,hd", [(12, 1, 80), (24, 2, 128), (16, 1, 64),
                                     (32, 2, 80)])
@pytest.mark.parametrize("combine", ["torch", "kernel"])
def test_decode_plain_version_at_new_shapes_matches_pallas(H, KV, hd,
                                                           combine):
    """G 12 and 16 and hd 80, on a cache that is mostly empty, in two
    splits, a head group with no valid slot among them (exact zeros)."""
    rng = np.random.default_rng(H + KV + hd)
    Bd, Sd, ns, bkv = 2, 64, 2, 16
    q = rng.normal(size=(Bd, H, hd)).astype(np.float32)
    k = rng.normal(size=(Bd, Sd, KV, hd)).astype(np.float32)
    v = rng.normal(size=(Bd, Sd, KV, hd)).astype(np.float32)
    bias = np.full((Bd, Sd), -np.inf, np.float32)
    bias[0, :21] = 0.0                 # row 1: no valid slot
    want = np.asarray(jax_fd.flash_decode(
        *(jnp.asarray(x) for x in (q, k, v, bias)), block_kv=bkv,
        num_splits=ns, combine="jax" if combine == "torch" else combine,
        interpret=True))
    got = kfd.flash_decode(*(torch.from_numpy(x) for x in (q, k, v, bias)),
                           block_kv=bkv, num_splits=ns, combine=combine)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[1] == 0.0) and np.all(want[1] == 0.0)


def test_resource_models_take_the_new_shapes():
    bf16, f32 = torch.bfloat16, torch.float32
    for dt in (bf16, f32):
        for blocks in ((128, 128), (256, 128), (64, 64)):
            cfg = dict(zip(("block_q", "block_kv"), blocks))
            assert ops.flash_valid(cfg, 80, dt)
    # hd 80 is staged as two 64-column panels: hd 128's shared memory
    assert kfa.flash_smem_bytes(128, 128, 80, bf16) == \
        kfa.flash_smem_bytes(128, 128, 128, bf16)
    assert kfa.flash_smem_bytes(128, 128, 80, f32) < \
        kfa.flash_smem_bytes(128, 128, 128, f32)
    assert not ops.flash_valid({"block_q": 128, "block_kv": 128}, 96, bf16)
    for G in (1, 8, 9, 12, 16):
        for hd in (64, 80, 128, 256):
            assert ops.decode_valid({"block_kv": 512}, G, hd)
    assert not ops.decode_valid({"block_kv": 512}, 17, 128)
    assert not ops.decode_valid({"block_kv": 512}, 12, 96)
    # rows staged an odd number of 16-byte chunks apart: hd 80 as 176
    # (bf16), 336 (fp32)
    assert kfd.row_bytes(80, 2) == 176 and kfd.row_bytes(80, 4) == 336
    assert kfd.row_bytes(256, 2) == 528
    assert kfd.group_rows(8) == 8 and kfd.group_rows(12) == 16
    # the 16-row instance's two score tiles and per-row state, at G 12, and
    # the stages of its ring (5 at hd 128 in bf16, as at G 8 on one block)
    assert kfd.decode_stages(12, 128, 2) == kfd.decode_stages(8, 128, 2) == 5
    assert (kfd.decode_smem_bytes(12, 128, 2) - kfd.decode_smem_bytes(8, 128, 2)
            == 4 * (4 * 128 + 2 * 8 * 64 + 3 * 8 + 4 * 4 * 128))
    assert max(kfd.decode_smem_bytes(G, hd, b) for G in range(1, 17)
               for hd in kfd.HEAD_DIMS for b in (2, 4)) == 230736


def test_a_server_resolves_its_own_cells_before_the_best_over_cells(tmp_path):
    """Two models' cells in one store: a server reads the record of its own
    flash and decode cells where the store has them, and the best over
    every cell (the reference's relaxation) where it has not."""
    from repro_torch.kernels import tuning
    from repro_torch.launch import serve
    from repro_torch.store import SpaceFingerprint, TuningRecord
    from repro_torch.store import TuningRecordStore
    store = TuningRecordStore(str(tmp_path / "store"))
    picks = {}
    for seq, (cell, cfg, value) in enumerate((
            (tuning.decode_cell(4, 1088, 8, 1, 64, device="cpu"),
             {"block_kv": 256, "num_splits": 1, "combine": "kernel"}, 1e-5),
            (tuning.decode_cell(4, 1088, 32, 4, 64, device="cpu"),
             {"block_kv": 512, "num_splits": 2, "combine": "kernel"}, 3e-5),
            (tuning.flash_cell(4, 1024, 8, 64, KV=1, device="cpu"),
             {"block_q": 256, "block_kv": 128}, 1e-4),
            (tuning.flash_cell(4, 1024, 32, 64, KV=4, device="cpu"),
             {"block_q": 1024, "block_kv": 256}, 3e-4))):
        fp = SpaceFingerprint.of(cell.space, objective=cell.objective_id())
        idx = cell.space.index_of(cfg)
        store.append(TuningRecord(fp=fp.digest, run="t", seq=seq,
                                  key=str(idx), idx=idx, value=value,
                                  config=cfg), fingerprint=fp)
        picks[cell.shape_sig] = cfg
    store.close()
    path = str(tmp_path / "store")
    cfg = smoke_config("qwen3-moe-30b-a3b").replace(
        num_heads=32, num_kv_heads=4, head_dim=64)
    quiet = dict(device=torch.device("cpu"), prompt_len=1024, cache_cap=1088,
                 store=path, log=lambda *a: None)
    own = serve.serving_kernel_config(cfg, batch=4, **quiet)
    assert (own.flash_block_q, own.flash_block_kv) == (1024, 256)
    assert (own.decode_block_kv, own.decode_num_splits) == (512, 2)
    other = serve.serving_kernel_config(cfg, batch=2, **quiet)   # no own cell
    assert (other.decode_block_kv, other.decode_num_splits) == (256, 1)
    assert tuning.flash_shape_sig(4, 1024, 32, 64, 4) in picks
    assert tuning.decode_shape_sig(4, 1088, 32, 4, 64) in picks


@pytest.mark.parametrize("key,hd,G", [
    ("kernel[decode×B4_S1088_H96_KV8_hd128×cpu]", 128, 12),   # mistral
    ("kernel[decode×B2_S160_H32_KV32_hd80×cpu]", 80, 1),      # stablelm
    ("kernel[decode×B2_S160_H16_KV1_hd64×cpu]", 64, 16),
    ("kernel[flash×B1_S128_H32_hd80×cpu]", 80, 1),
    ("kernel[flash×B4_S1024_H32_hd128_KV4×cpu]", 128, 8),      # qwen3-moe
])
def test_retune_keys_of_the_new_shapes_become_cells_the_model_takes(key, hd,
                                                                    G):
    """The retune daemon maps a stale job's key back to its cell at the new
    shapes; the card's resource model takes the cell's default blocks."""
    from repro_torch.launch.retune import kernel_objective_for
    cell = kernel_objective_for(key, device="cpu").cell
    assert cell.objective_id() == key
    assert cell.meta["hd"] == hd and cell.meta["H"] // cell.meta["KV"] == G
    assert cell.valid(cell.default)
