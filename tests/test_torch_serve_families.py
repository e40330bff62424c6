"""The four recurrent, latent-attention and audio families against the JAX
package, on the CPU: recurrentgemma-9b (RG-LRU + windowed attention),
deepseek-v3-671b (MLA + MoE), xlstm-1.3b (mLSTM/sLSTM) and musicgen-large
(cross-attention, the embeddings frontend).

Configs, smoke configs and parameter counts of all ten configs against the
reference's; the reference's parameter tree carried across by
``params_from_jax`` for every new leaf; each kind's cache against the
reference's specs; and the serve path's dispatch for these families (the
gate, the kernel config by layer kind, the decode cell at a windowed
layer's capacity, the dispatch report). Each family's blocks and its
smoke model's prefill + decode are held against the reference in
``test_torch_{hybrid,mla,xlstm,musicgen}.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest

import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import params as jax_params

from repro_torch.configs.registry import ARCHS, get_arch, smoke_config
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig

from torch_family_parity import B, KERNELS, S

NEW = ("recurrentgemma-9b", "deepseek-v3-671b", "xlstm-1.3b",
       "musicgen-large")


# -- configs and parameters ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_every_config_smoke_config_and_count_match_the_reference(name):
    cfg, ref = get_arch(name), jax_get_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    small, ref_small = smoke_config(name), jax_smoke_config(name)
    assert dataclasses.asdict(small) == dataclasses.asdict(ref_small)
    for c, r in ((cfg, ref), (small, ref_small)):
        for active in (False, True):
            assert P.count_params(c, active_only=active) == \
                jax_params.count_params(r, active_only=active)
    assert set(ARCHS) == set(JAX_ARCHS)


def test_the_new_configs_count_as_their_names_say():
    assert P.count_params(get_arch("recurrentgemma-9b")) == 8_578_519_040
    assert P.count_params(get_arch("xlstm-1.3b")) == 2_901_346_640
    assert P.count_params(get_arch("musicgen-large")) == 4_031_023_104
    ds = get_arch("deepseek-v3-671b")
    assert P.count_params(ds.replace(num_layers=5)) == 26_618_387_968
    assert 6.5e11 < P.count_params(ds) < 7e11
    # the reference has no multi-token-prediction head: mtp=True builds the
    # same tree, as the reference's does
    assert P.model_specs(ds.replace(mtp=True)) == P.model_specs(ds)
    assert P.count_params(ds.replace(mtp=True)) == P.count_params(ds)


def test_an_mtp_config_runs_and_gives_its_twins_logits():
    """deepseek-v3's smoke config with mtp=True builds its weights and
    cache and serves a prefill and a decode step, with the logits of its
    mtp=False twin bit for bit (the reference reads the flag nowhere)."""
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    base = smoke_config("deepseek-v3-671b")
    assert not base.mtp
    outs = []
    for cfg in (base, base.replace(mtp=True)):
        params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 8),
                             generator=torch.Generator().manual_seed(1))
        logits, cache = make_prefill_step(cfg, ParallelConfig(), 12)(
            params, {"tokens": toks})
        step, _ = make_decode_step(cfg, ParallelConfig())(
            params, cache, {"tokens": toks[:, -1:]}, 8)
        outs.append((logits, step))
    for a, b in zip(*outs):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("name", NEW)
def test_params_from_jax_carries_every_leaf_of_the_new_kinds(name):
    """Mixed segments in the reference's order (recurrentgemma's
    (rglru, rglru, attn) cycle then its (rglru, rglru) remainder, xLSTM's
    7 mLSTM + sLSTM then one mLSTM), every leaf carried bit for bit."""
    ref_cfg, cfg = jax_smoke_config(name), smoke_config(name)
    tree = jax.tree.map(np.asarray,
                        jax_params.init_params(ref_cfg, jax.random.PRNGKey(0)))
    mine = P.params_from_jax(tree, cfg)
    flat = dict(P.leaves(mine))
    assert set(flat) == set(dict(P.leaves(P.model_specs(cfg))))
    n_ref = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(tree))
    assert sum(t.numel() for t in flat.values()) == n_ref == \
        P.count_params(cfg)
    i = 0
    for si, (n_rep, cycle) in enumerate(cfg.pattern_layers()):
        for r in range(n_rep):
            for j, kind in enumerate(cycle):
                want = dict(P.leaves(jax.tree.map(
                    lambda a: a[r], tree["segments"][si][f"{j}:{kind}"])))
                got = dict(P.leaves(mine["layers"][i]))
                assert set(got) == set(want)
                for path, w in want.items():
                    assert P.DTYPES[str(w.dtype)] == got[path].dtype
                    np.testing.assert_array_equal(
                        got[path].float().numpy(), w.astype(np.float32))
                i += 1
    assert P.layer_kinds(cfg) == [k for n, c in cfg.pattern_layers()
                                  for _ in range(n) for k in c]
    assert ("embed" in mine) == (cfg.frontend is None)


def test_init_params_draws_the_lru_init_and_the_forget_bias():
    cfg = smoke_config("recurrentgemma-9b")
    p = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a = p["layers"][0]["rec"]["a_param"]
    u = torch.sigmoid(a)
    assert a.dtype == torch.float32 and bool(((u > 0.9) & (u < 0.999)).all())
    assert float(u.std()) > 0.01
    x = P.init_params(smoke_config("xlstm-1.3b"),
                      torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(x["layers"][0]["mlstm"]["b_fgate"], torch.ones(2))


def test_caches_of_every_kind_match_the_reference_specs():
    """Shapes, dtypes and inits of each kind's cache against the
    reference's ``init_cache`` (positions int64 against int32)."""
    from repro.models.model import init_cache as jax_init_cache
    for name in NEW:
        ref_cfg, cfg = jax_smoke_config(name), smoke_config(name)
        want = jax_init_cache(ref_cfg, B, 40)
        got = M.init_cache(cfg, B, 40)
        i = 0
        for si, (n_rep, cycle) in enumerate(cfg.pattern_layers()):
            for r in range(n_rep):
                for j, kind in enumerate(cycle):
                    ref = want["segments"][si][f"{j}:{kind}"]
                    mine = got[i]
                    assert set(mine) == set(ref), (name, kind)
                    for key, w in ref.items():
                        w = np.asarray(w[r])
                        t = mine[key]
                        assert tuple(t.shape) == w.shape, (name, key)
                        want_dt = (torch.long if w.dtype == np.int32
                                   else P.DTYPES[str(w.dtype)])
                        assert t.dtype == want_dt, (name, key)
                        np.testing.assert_array_equal(t.float().numpy(),
                                                      w.astype(np.float32))
                    i += 1
    # the windowed layers hold min(cap, window) slots, the sLSTM n starts at 1
    rg = M.init_cache(smoke_config("recurrentgemma-9b"), B, 40)
    assert rg[2]["k"].shape[1] == 16 == M.attention_cache_cap(
        smoke_config("recurrentgemma-9b"), 40)
    xl = M.init_cache(smoke_config("xlstm-1.3b"), B, 40)
    assert torch.equal(xl[7]["n"], torch.ones_like(xl[7]["n"]))


# -- the serve path's dispatch ---------------------------------------------------

def test_windowed_and_mla_prefill_take_the_reference_path_on_both_devices():
    """A window or unequal q/k and v head dims close the flash gate on the
    card too (the reference's ``_pallas_flash_ok``): prefill runs the
    blockwise or the materialized attention by ``flash_threshold``; the
    raise stays for blocks that do not tile a kernel shape."""
    kc = KernelConfig(**KERNELS)
    for dev in ("cpu", "cuda"):
        assert not L._flash_kernel_ok(16, 16, 16, 8, kc, dev)
        assert not L._flash_kernel_ok(16, 24, 16, None, kc, dev)
    with pytest.raises(ValueError, match="do not tile"):
        L._flash_kernel_ok(12, 16, 16, None, kc, "cuda")

    calls = []
    orig = {n: getattr(L, n) for n in ("_direct_attention",
                                       "_flash_attention",
                                       "_kernel_flash_attention")}

    def spy(n):
        def f(*a, **kw):
            calls.append(n)
            return orig[n](*a, **kw)
        return f

    try:
        for n in orig:
            setattr(L, n, spy(n))
        for name, threshold, want in (
                ("recurrentgemma-9b", 1 << 30, "_direct_attention"),
                ("recurrentgemma-9b", 16, "_flash_attention"),
                ("deepseek-v3-671b", 1 << 30, "_direct_attention"),
                ("deepseek-v3-671b", 16, "_flash_attention"),
                ("musicgen-large", 1 << 30, "_kernel_flash_attention")):
            cfg = smoke_config(name)
            params = P.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            srv = serve.DecodeServer(
                cfg, ParallelConfig(kernel=kc, flash_threshold=threshold,
                                    attn_block_kv=8),
                batch=B, prompt_len=S, decode_steps=2, device="cpu",
                params=params)
            calls.clear()
            srv.prefill_batch(srv.input_batch())
            n_attn = sum(1 for k in P.layer_kinds(cfg) if k.startswith("attn"))
            assert calls == [want] * n_attn, (name, calls)
            text = srv.prefill_dispatch
            if want == "_kernel_flash_attention":
                assert text == ("flash-attention kernel plain version (cpu)"
                                "; cross-attention: plain")
            else:
                blockwise = "blockwise" if threshold < S else "direct"
                assert f"plain {blockwise} attention, as the reference" in text
    finally:
        for n, f in orig.items():
            setattr(L, n, f)


def test_dispatch_report_names_each_layer_kind():
    kc = KernelConfig(**KERNELS)

    def srv(name, **pkw):
        cfg = smoke_config(name)
        return serve.DecodeServer(
            cfg, ParallelConfig(kernel=kc, **pkw), batch=1, prompt_len=S,
            decode_steps=2, device="cpu",
            params=P.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu"))

    rg = srv("recurrentgemma-9b")
    assert rg.prefill_dispatch == (
        "windowed: plain direct attention, as the reference; RG-LRU: "
        "doubling scan")
    assert rg.decode_dispatch.startswith(
        "windowed: flash-decode split kernel with the combine fused in "
        "plain version (cpu); RG-LRU: one recurrence step")
    assert rg.decode_kernel
    ds = srv("deepseek-v3-671b")
    assert ds.prefill_dispatch == ("MLA: plain direct attention, as the "
                                   "reference")
    assert ds.decode_dispatch == ("MLA: plain absorbed latent decode, as the "
                                  "reference")
    assert not ds.decode_kernel
    xl = srv("xlstm-1.3b", mlstm_chunk=8)
    assert xl.prefill_dispatch == ("mLSTM: chunkwise scan (chunk 8); sLSTM: "
                                   "step scan")
    assert xl.decode_dispatch == "mLSTM: one step; sLSTM: one step"
    assert not xl.decode_kernel
    assert "mLSTM: step scan" in srv("xlstm-1.3b").prefill_dispatch
    mg = srv("musicgen-large")
    assert mg.prefill_dispatch == ("flash-attention kernel plain version "
                                   "(cpu); cross-attention: plain")
    assert mg.decode_dispatch.startswith("flash-decode split kernel")
    assert mg.decode_dispatch.endswith("; cross-attention: plain")
    assert mg.decode_kernel


def test_serving_kernel_config_validates_only_the_kernels_a_model_reaches():
    """On the card (only the device's type is read without a store):
    deepseek's MLA (q/k 192 against v 128, d/H 56) and xLSTM reach neither
    kernel and build a config; recurrentgemma reaches only the decode
    kernel (G 16, hd 256), musicgen both (hd 64); a head dim the kernels
    lack still raises for a model that reaches them."""
    cuda = torch.device("cuda")
    quiet = dict(batch=4, log=lambda *a: None)
    assert serve.kernel_paths(get_arch("deepseek-v3-671b")) == set()
    assert serve.kernel_paths(get_arch("xlstm-1.3b")) == set()
    assert serve.kernel_paths(get_arch("recurrentgemma-9b")) == {"decode"}
    assert serve.kernel_paths(get_arch("musicgen-large")) == {"flash",
                                                               "decode"}
    for name, prompt in (("deepseek-v3-671b", 1000), ("xlstm-1.3b", 1000),
                         ("recurrentgemma-9b", 3000), ("musicgen-large",
                                                       1024)):
        kc = serve.serving_kernel_config(get_arch(name), device=cuda,
                                         prompt_len=prompt,
                                         cache_cap=prompt + 64, **quiet)
        assert kc.use_flash and kc.use_decode
    with pytest.raises(ValueError, match="hd=16"):
        serve.serving_kernel_config(smoke_config("musicgen-large"),
                                    device=cuda, prompt_len=64,
                                    cache_cap=72, **quiet)
    with pytest.raises(ValueError, match="hd=16"):
        serve.serving_kernel_config(smoke_config("recurrentgemma-9b"),
                                    device=cuda, prompt_len=64,
                                    cache_cap=72, **quiet)


def test_the_decode_cell_is_resolved_at_the_windowed_capacity(tmp_path):
    """recurrentgemma's attention layers hold 2,048 slots whatever the
    prompt: the server resolves, and tails, the decode cell at 2,048."""
    from repro_torch.kernels import tuning
    from repro_torch.store import SpaceFingerprint, TuningRecord
    from repro_torch.store import TuningRecordStore
    cfg = get_arch("recurrentgemma-9b")
    assert M.attention_cache_cap(cfg, 3136) == 2048
    assert M.attention_cache_cap(get_arch("musicgen-large"), 1088) == 1088
    store = TuningRecordStore(str(tmp_path / "store"))
    cell = tuning.decode_cell(4, 2048, 16, 1, 256, dtype=torch.bfloat16,
                              device="cpu")
    conf = {"block_kv": 256, "num_splits": 2, "combine": "kernel"}
    fp = SpaceFingerprint.of(cell.space, objective=cell.objective_id())
    idx = cell.space.index_of(conf)
    store.append(TuningRecord(fp=fp.digest, run="t", seq=0, key=str(idx),
                              idx=idx, value=1e-5, config=conf),
                 fingerprint=fp)
    store.close()
    kc = serve.serving_kernel_config(
        cfg, device=torch.device("cpu"), prompt_len=3072, cache_cap=3136,
        batch=4, store=str(tmp_path / "store"), log=lambda *a: None)
    assert (kc.decode_block_kv, kc.decode_num_splits) == (256, 2)
    srcs = serve.kernel_sources(str(tmp_path / "store"), cfg, batch=4,
                                prompt_len=3072, cache_cap=3136,
                                device=torch.device("cpu"),
                                log=lambda *a: None)
    assert [s.objective_id for s in srcs] == [cell.objective_id()]


@pytest.mark.parametrize("name,prefill,decode", [
    ("deepseek-v3-671b", "MLA: plain direct attention, as the reference",
     "MLA: plain absorbed latent decode, as the reference"),
    ("xlstm-1.3b", "mLSTM: step scan; sLSTM: step scan",
     "mLSTM: one step; sLSTM: one step")])
def test_smoke_servers_of_kernel_free_families_serve_on_cpu(
        name, prefill, decode, capsys):
    """``--kernels`` on the CPU: these families reach neither kernel, so
    the server builds its kernel config, launches nothing and names the
    reference's paths."""
    out = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16",
                      "--decode-steps", "3", "--kernels"])
    text = capsys.readouterr().out
    assert len(out["step_s"]) == 3 and out["server"].pos == 19
    assert out["launches"] == {"flash_attention": 0, "flash_decode_split": 0,
                               "flash_decode_combine": 0,
                               "flash_decode_ring": 0}
    assert f"dispatch: {prefill}\n" in text
    assert f"dispatch: {decode}\n" in text
