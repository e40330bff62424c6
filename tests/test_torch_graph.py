"""The port's decode-step pieces that the CUDA graph needs, its compiled
kernel cache, its resolution of stored configs and the flash kernel's
full-attention mode, against a live run of the JAX package on the CPU.

On the card ``DecodeServer`` replays one captured graph of its decode step
per kernel config (``tests/test_torch_cuda.py`` checks that there); here
the same server runs its step functions eagerly, and the pieces that make
the graph possible are held against the reference: the position as a
device tensor, the embedding scale without a host-to-device copy, the
server's own cache buffers across prefills, and the cache keyed as the
reference keys its jitted step functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core.strategies import ALL_BO as JAX_ALL_BO
from repro.core.tuning_targets import sharding_space as j_sharding_space
from repro.kernels import ops as jax_ops
from repro.kernels.cache import CompiledKernelCache as JaxCache
from repro.kernels.cache import config_key as jax_config_key
from repro.models import params as jax_params
from repro.models.stepfn import make_decode_step as jax_decode_step
from repro.models.stepfn import make_prefill_step as jax_prefill_step
from repro.parallel.sharding import KernelConfig as JaxKernelConfig
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx
from repro.store import apply_kernel_config as jax_apply_kernel_config
from repro.store import best_sharding_config as jax_best_sharding_config

from repro_torch.configs.registry import smoke_config
from repro_torch.core.strategies import ALL_BO, make_strategy
from repro_torch.core.tuning_targets import sharding_space
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, tuning
from repro_torch.kernels.cache import CompiledKernelCache, config_key
from repro_torch.launch import serve
from repro_torch.models import params as P
from repro_torch.models.stepfn import make_decode_step, make_prefill_step
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
from repro_torch.store import (SpaceFingerprint, TuningRecord,
                               TuningRecordStore, apply_kernel_config,
                               apply_sharding_config, best_sharding_config,
                               cell_objective)

B, S, STEPS = 2, 8, 4
KC_A = dict(use_flash=True, flash_block_q=8, flash_block_kv=8,
            use_decode=True, decode_block_kv=8, decode_num_splits=2,
            decode_combine="kernel")


def _prompt(cfg, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


# -- the decode step's position as a device tensor --------------------------------

def test_decode_with_a_position_tensor_matches_int_and_the_reference():
    """The smoke config's decode steps with ``pos`` an int64 tensor: the
    same logits as with a Python int, bit for bit, and as the reference's
    jitted decode with its traced position."""
    cfg = jax_smoke_config("gemma-2b").replace(dtype="float32")
    tree = jax.tree.map(np.asarray,
                        jax_params.init_params(cfg, jax.random.PRNGKey(0)))
    mine = smoke_config("gemma-2b").replace(dtype="float32")
    params = P.params_from_jax(tree, mine)
    prompt = _prompt(cfg)

    px = ShardCtx(None, JaxParallelConfig(flash_threshold=1 << 30,
                                          logits_chunk=0))
    jprefill = jax.jit(jax_prefill_step(cfg, px, cache_cap=S + STEPS))
    jdecode = jax.jit(jax_decode_step(cfg, px))
    jparams = jax.tree.map(jnp.asarray, tree)
    logits, jcache = jprefill(jparams, {"tokens": jnp.asarray(prompt)})
    toks, ref = [np.asarray(jnp.argmax(logits, -1))], []
    for i in range(STEPS):
        logits, jcache = jdecode(jparams, jcache,
                                 {"tokens": jnp.asarray(toks[-1])[:, None]},
                                 jnp.asarray(S + i, jnp.int32))
        ref.append(np.asarray(logits, np.float32))
        toks.append(np.asarray(jnp.argmax(logits, -1)))

    pcfg = ParallelConfig()
    prefill = make_prefill_step(mine, pcfg, cache_cap=S + STEPS)
    decode = make_decode_step(mine, pcfg)
    runs = {}
    for how in ("tensor", "int"):
        _, cache = prefill(params, {"tokens": torch.from_numpy(prompt)})
        out = []
        for i in range(STEPS):
            pos = torch.tensor(S + i) if how == "tensor" else S + i
            logits, cache = decode(params, cache, {"tokens": torch.tensor(
                toks[i])[:, None]}, pos)
            out.append(logits)
        runs[how] = out
    for a, b, want in zip(runs["tensor"], runs["int"], ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), want, rtol=2e-4, atol=2e-4)


def test_embedding_scale_rounds_to_the_model_dtype():
    """sqrt(d_model) is rounded to the model dtype first, as the reference
    does, and the product equals the product with a tensor of that dtype."""
    from repro_torch.models.model import _embed_scale
    assert _embed_scale(2048, torch.bfloat16) == 45.25
    x = torch.randn(64, 2048).bfloat16()
    assert torch.equal(x * _embed_scale(2048, torch.bfloat16),
                       x * torch.tensor(2048 ** 0.5, dtype=torch.bfloat16))


# -- the compiled-kernel cache -----------------------------------------------------

def test_compiled_kernel_caches_count_alike():
    keys = ["a", "b", "a", "c", "d", "b", "e", "a", "a", "c"]
    caches = (CompiledKernelCache(max_entries=3), JaxCache(max_entries=3))
    built = ([], [])
    for k in keys:
        for c, log in zip(caches, built):
            assert c.get(k, lambda k=k, log=log: log.append(k) or k) == k
    assert built[0] == built[1]
    assert caches[0].stats() == caches[1].stats()
    assert caches[0].stats()["evictions"] > 0 and caches[0].hits > 0
    dropped = [c.invalidate(lambda k: k in ("a", "e")) for c in caches]
    assert dropped[0] == dropped[1] and len(caches[0]) == len(caches[1])
    for cfg in (None, {"b": 1, "a": (2, 3)}):
        assert config_key(cfg) == jax_config_key(cfg)


# -- the server: its cache buffers, swaps and step-function cache -------------------

def _server(kc=KC_A, **kw):
    cfg = smoke_config("gemma-2b").replace(dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return serve.DecodeServer(cfg, ParallelConfig(kernel=KernelConfig(**kc)),
                              batch=B, prompt_len=16, decode_steps=STEPS,
                              device="cpu", params=params, **kw)


def test_server_swap_back_is_a_cache_hit_as_in_the_reference():
    """A -> B -> A: the step functions are derived twice and re-used on the
    return, as the reference's jitted step functions are (on the card each
    carries its captured decode graph)."""
    srv = _server()
    srv.prefill_batch(srv.input_batch())
    srv.decode_step()
    first = srv.decode
    srv.apply_kernel_config({"block_kv": 16, "num_splits": 1,
                             "combine": "torch"})
    srv.decode_step()
    assert srv.pcfg.kernel.decode_combine == "torch" and srv.decode_kernel
    srv.apply_kernel_config({"block_kv": 8, "num_splits": 2,
                             "combine": "kernel"})
    srv.decode_step()
    assert srv.decode is first and srv.kernel_swaps == 2
    assert srv.kernel_cache.stats() == {"hits": 1, "misses": 2,
                                        "evictions": 0, "entries": 2}
    assert srv.captures == 0 and "CUDA graph" not in srv.decode_dispatch
    plain = _server(kc={})
    assert not plain.decode_kernel


def test_server_keeps_its_cache_buffers_across_prefills():
    """A prefill copies its cache into the server's own buffers (the ones
    a captured graph reads): same storage, and a sequence after a second
    prefill decodes as on a fresh server."""
    srv = _server(keep_logits=STEPS)
    ptrs = [t.data_ptr() for layer in srv.cache for t in layer.values()]
    gen = torch.Generator().manual_seed(5)
    other = {"tokens": torch.randint(0, srv.cfg.vocab_size, (B, 16),
                                     generator=gen)}
    srv.prefill_batch(srv.input_batch())
    for _ in range(STEPS):
        srv.decode_step()
    srv.prefill_batch(other)
    for _ in range(STEPS):
        srv.decode_step()
    assert [t.data_ptr() for layer in srv.cache
            for t in layer.values()] == ptrs
    fresh = _server(keep_logits=STEPS)
    fresh.prefill_batch(other)
    for _ in range(STEPS):
        fresh.decode_step()
    for a, b in zip(srv.kept, fresh.kept):
        assert torch.equal(a, b)
    assert [t.tolist() for t in srv.out] == [t.tolist() for t in fresh.out]


def test_apply_kernel_config_overlays_compose_as_in_the_reference():
    seq = [{"block_kv": 256, "num_splits": 2, "combine": "kernel"},
           {"block_q": 128, "block_kv": 64},
           {"block_m": 64, "block_n": 64, "block_k": 64},   # a gemm cell's
           {"block_kv": 512, "num_splits": 1, "combine": "torch"}]
    base = dict(flash_block_q=512, flash_block_kv=512, decode_block_kv=512,
                decode_num_splits=1)
    mine = ParallelConfig(kernel=KernelConfig(**base))
    ref = JaxParallelConfig(kernel=JaxKernelConfig(**base))
    fields = ("use_flash", "flash_block_q", "flash_block_kv", "use_decode",
              "decode_block_kv", "decode_num_splits")
    for cfg in seq:
        mine, ref = apply_kernel_config(mine, cfg), jax_apply_kernel_config(
            ref, dict(cfg, combine={"torch": "jax"}.get(cfg.get("combine"),
                                                        cfg.get("combine")))
            if "combine" in cfg else cfg)
        assert [getattr(mine.kernel, f) for f in fields] == \
            [getattr(ref.kernel, f) for f in fields]
    assert mine.kernel.decode_combine == "torch"
    assert ref.kernel.decode_combine == "jax"


def test_sharding_configs_resolve_alike_and_log_on_one_card(tmp_path):
    """The sharding cell's records resolve to the same config in both
    packages; on one card the fields the port's ParallelConfig owns apply
    as the reference applies them (the MoE capacity factor, which sets
    which routed copies drop; the blockwise attention's knobs; the training
    knobs), and each other field is logged."""
    from repro.store.resolve import \
        apply_sharding_config as jax_apply_sharding_config
    arch, shape = "internlm2-1.8b", "decode_32k"
    space = sharding_space(arch, shape)
    fp = SpaceFingerprint.of(space, objective=cell_objective(arch, shape))
    wide = sharding_space(arch, shape, wide=True)
    wfp = SpaceFingerprint.of(wide, objective=cell_objective(arch, shape))
    store = TuningRecordStore(str(tmp_path / "store"))
    for seq, (sp, f, i, v) in enumerate(((space, fp, 3, 1.25),
                                         (space, fp, 17, 0.75),
                                         (wide, wfp, 40, 0.5))):
        store.append(TuningRecord(fp=f.digest, run="t", seq=seq, key=str(i),
                                  idx=i, value=v, config=sp.config(i)),
                     fingerprint=f)
    store.close()
    path = str(tmp_path / "store")
    assert best_sharding_config(path, arch, shape) == \
        jax_best_sharding_config(path, arch, shape) == (space.config(17),
                                                         0.75)
    assert best_sharding_config(str(tmp_path / "none"), arch, shape) is None
    assert sharding_space(arch, shape).size == j_sharding_space(arch,
                                                                shape).size
    logged = []
    pcfg = ParallelConfig(kernel=KernelConfig(**KC_A))
    rec17 = space.config(17)
    out = apply_sharding_config(pcfg, rec17, log=logged.append)
    # the blockwise attention's and the training knobs apply as the
    # reference applies them (flash as flash_threshold); the mesh knobs are
    # logged
    ref17 = jax_apply_sharding_config(JaxParallelConfig(), rec17)
    assert out == pcfg.replace(**{f: getattr(ref17, f) for f in (
        "attn_q_chunks", "attn_block_kv", "flash_threshold", "remat",
        "logits_chunk")})
    assert len(logged) == 1
    assert "embed_rule" in logged[0] and "one card" in logged[0]
    assert "remat" not in logged[0] and "logits_chunk" not in logged[0]
    assert "flash" not in logged[0] and "attn_block_kv" not in logged[0]
    srv = _server()
    srv.apply_config(space.config(17))
    assert srv.swaps == 1 and srv.pcfg.kernel == KernelConfig(**KC_A)
    # an MoE cell's record carries capacity_factor: applied, not logged
    moe = sharding_space("qwen3-moe-30b-a3b", shape)
    rec = next(moe.config(i) for i in range(moe.size)
               if moe.config(i)["capacity_factor"] != 1.25)
    logged = []
    out = apply_sharding_config(pcfg, rec, log=logged.append)
    want = jax_apply_sharding_config(JaxParallelConfig(), rec)
    assert out.capacity_factor == want.capacity_factor == \
        rec["capacity_factor"]
    assert out.kernel == pcfg.kernel and len(logged) == 1
    assert "capacity_factor" not in logged[0] and "one card" in logged[0]
    srv.apply_config(rec)
    assert srv.pcfg.capacity_factor == rec["capacity_factor"]
    assert srv._stepfn_key()[0] == rec["capacity_factor"]


def test_serve_online_cli_on_cpu(tmp_path, capsys):
    """``serve --online --kernels`` on the CPU: prod records journaled, one
    durable stale job for each kernel cell the store has never tuned."""
    store = str(tmp_path / "store")
    out = serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                      "--batch", "1", "--prompt-len", "128",
                      "--decode-steps", "4", "--kernels", "--online",
                      "--store", store, "--poll-every", "2"])
    stats = out["stats"]
    assert stats.steps == 4 and stats.decode_steps_kernel == 4
    assert out["recorder"].count == 1 + 4 - 1     # prefill + steps - warm-up
    keys = sorted(tk.key for tk in out["queue"].open_tickets())
    assert keys == ["kernel[decode×B1_S132_H4_KV1_hd16×cpu]",
                    "kernel[flash×B1_S128_H4_hd16_KV1×cpu]"]
    assert stats.kernel_retunes_requested == 2
    text = capsys.readouterr().out
    assert "stale retune request" in text and "--device cpu" in text


# -- the flash kernel's full attention; the BO strategies ---------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_full_attention_plain_version_matches_the_reference(dtype, tol):
    """causal=False against the reference's Pallas kernel in interpret
    mode, at the reference's tolerances (tests/test_kernels.py:55, :78)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(1, 128, 2, 64)) for _ in range(3))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_ops.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                   block_q=64, block_kv=64, causal=False,
                                   interpret=True)
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    kfa.launches = 0
    got = kfa.flash_attention(*t, block_q=64, block_kv=64, causal=False)
    assert kfa.launches == 0                      # the plain version
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    causal = ops.flash_attention(*t, block_q=64, block_kv=64)
    assert not torch.allclose(causal, got)
    cell = tuning.flash_cell(1, 128, 2, 64, causal=False, device="cpu")
    assert cell.meta["causal"] is False
    out = cell.run({"block_q": 128, "block_kv": 128})
    q32, k32, v32 = cell.meta["inputs"]
    assert torch.allclose(out, kfa.flash_attention(q32, k32, v32,
                                                   causal=False))


def test_all_bo_is_the_references():
    assert ALL_BO == JAX_ALL_BO == ("ei", "multi", "advanced_multi")
    for name in ("poi", "lcb"):
        assert make_strategy(name).cfg.acquisition == name
    # the baselines are ported now: "random" builds, an unknown name raises
    assert make_strategy("random").name == "random"
    with pytest.raises(KeyError):
        make_strategy("nope")
