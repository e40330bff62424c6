"""deepseek-v3-671b's multi-head latent attention against the JAX
package's, on the CPU: prefill (q/k head dim dn + dr against v's dv, by
the materialized scores and by the blockwise attention) and the
absorbed-weight decode over the ``c_kv``/``k_rope`` latent cache, which
also equals attention with k and v expanded from the cache; then the smoke
model (MLA + the sigmoid-routed MoE) end to end. Blocks at the reference's
fp32 2e-4; the model as ``torch_family_parity``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import params as JP
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx

from repro_torch.configs.registry import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.parallel.sharding import ParallelConfig

from torch_family_parity import BLOCKWISE, family_matches_jax

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=2e-4, atol=2e-4)
NB, NS, CAP = 2, 24, 30


def _attn_params():
    ref_cfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    ref_cfg, cfg = (c.replace(dtype="float32") for c in (ref_cfg, cfg))
    tree = jax.tree.map(np.asarray, JP.init_params(ref_cfg,
                                                   jax.random.PRNGKey(0)))
    pj = jax.tree.map(lambda a: a[0],
                      tree["segments"][0]["0:attn_dense"]["attn"])
    pt = P.params_from_jax(tree, cfg)["layers"][0]["attn"]
    return ref_cfg, cfg, pj, pt


def _jcache(cfg):
    m = cfg.mla
    return {"c_kv": jnp.zeros((NB, CAP, m.kv_lora_rank)),
            "k_rope": jnp.zeros((NB, CAP, m.qk_rope_head_dim)),
            "pos": jnp.full((NB, CAP), -1, jnp.int32)}


def _tcache(cfg):
    m = cfg.mla
    return {"c_kv": torch.zeros((NB, CAP, m.kv_lora_rank)),
            "k_rope": torch.zeros((NB, CAP, m.qk_rope_head_dim)),
            "pos": torch.full((NB, CAP), -1, dtype=torch.long)}


@pytest.mark.parametrize("pkw", [{}, BLOCKWISE], ids=["direct", "blockwise"])
def test_mla_prefill_and_absorbed_decode_match_the_reference(pkw):
    ref_cfg, cfg, pj, pt = _attn_params()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(NB, NS, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(NS), (NB, NS)).copy()
    px = ShardCtx(None, JaxParallelConfig(**{"flash_threshold": 1 << 30,
                                             **pkw}))
    pcfg = ParallelConfig(**{"flash_threshold": 1 << 30, **pkw})
    yj, jc = JL.mla_attention(pj, jnp.asarray(x), cfg=ref_cfg, px=px,
                              mode="prefill", cache=_jcache(ref_cfg),
                              positions=jnp.asarray(pos, jnp.int32))
    yt, tc = L.mla_attention(pt, torch.from_numpy(x), cfg=cfg, pcfg=pcfg,
                             mode="prefill", cache=_tcache(cfg),
                             positions=torch.from_numpy(pos))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for name in ("c_kv", "k_rope", "pos"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    bufs = _tcache(cfg)
    for name, buf in bufs.items():
        buf.copy_(tc[name])
    held = dict(bufs)
    for i in range(3):
        x1 = rng.normal(size=(NB, 1, 64)).astype(np.float32)
        p1 = np.full((NB, 1), NS + i)
        yj, jc = JL.mla_attention(pj, jnp.asarray(x1), cfg=ref_cfg, px=px,
                                  mode="decode", cache=jc,
                                  positions=jnp.asarray(p1, jnp.int32))
        yt, out = L.mla_attention(pt, torch.from_numpy(x1), cfg=cfg,
                                  pcfg=pcfg, mode="decode", cache=bufs,
                                  positions=torch.from_numpy(p1))
        assert out is bufs and all(bufs[n] is held[n] for n in held)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for name in ("c_kv", "k_rope", "pos"):
            np.testing.assert_allclose(bufs[name].numpy(),
                                       np.asarray(jc[name]), **TOL)


def test_absorbed_decode_equals_attention_over_the_expanded_cache():
    """The absorbed form scores q_nope W_k_nope^T against c_kv and maps the
    latent context through W_v: the same as expanding k_nope and v per
    head from the cache and attending over them."""
    _, cfg, _, pt = _attn_params()
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(NB, NS, 64)).astype(np.float32))
    pos = torch.arange(NS)[None].expand(NB, NS)
    pcfg = ParallelConfig()
    _, c = L.mla_attention(pt, x, cfg=cfg, pcfg=pcfg, mode="prefill",
                           cache=_tcache(cfg), positions=pos)
    x1 = torch.from_numpy(rng.normal(size=(NB, 1, 64)).astype(np.float32))
    p1 = torch.full((NB, 1), NS)
    y, c = L.mla_attention(pt, x1, cfg=cfg, pcfg=pcfg, mode="decode",
                           cache=c, positions=p1)
    q_lat = L.rms_norm(x1 @ pt["wq_a"], pt["q_a_norm"]["scale"], 1e-6)
    q = torch.einsum("bsl,lhk->bshk", q_lat, pt["wq_b"])
    cos, sin = L.rope_tables(p1, dr, cfg.rope_theta)
    q = torch.cat([q[..., :dn], L.apply_rope(q[..., dn:], cos, sin)], -1)
    k_nope = torch.einsum("btl,lhn->bthn", c["c_kv"], pt["wk_nope"])
    k = torch.cat([k_nope, c["k_rope"][:, :, None].expand(
        -1, -1, cfg.num_heads, -1)], -1)
    v = torch.einsum("btl,lhv->bthv", c["c_kv"], pt["wv"])
    n = NS + 1                                   # the filled slots
    out = L._direct_attention(q, k[:, :n], v[:, :n], q_pos=p1,
                              k_pos=c["pos"][:, :n], window=None,
                              scale=(dn + dr) ** -0.5)
    want = torch.einsum("bshv,hvd->bsd", out, pt["wo"])
    torch.testing.assert_close(y, want, **TOL)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_smoke_model_matches_jax(kernels):
    family_matches_jax(ARCH, "float32", kernels, {})


def test_smoke_model_blockwise_prefill_matches_jax():
    family_matches_jax(ARCH, "float32", True, BLOCKWISE)


def test_bf16_smoke_model_matches_jax():
    family_matches_jax(ARCH, "bfloat16", False, {})
