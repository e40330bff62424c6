"""recurrentgemma-9b's blocks against the JAX package's, on the CPU: the
blockwise attention (a window, causal q-chunks, a v head dim unlike q's),
the RG-LRU's doubling scan against ``lax.associative_scan``, the RG-LRU
block's prefill and its decode state, and the smoke model end to end with
a window of 16 under a prompt of 24 (the cache rolls). Blocks at the
reference's fp32 2e-4; the model as ``torch_family_parity``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

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

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("window", [None, 8], ids=["causal", "window8"])
@pytest.mark.parametrize("q_chunks", [1, 2, 3])
@pytest.mark.parametrize("hd_v", [16, 12], ids=["hdv=hd", "hdv!=hd"])
def test_blockwise_attention_matches_the_reference(window, q_chunks, hd_v):
    rng = np.random.default_rng(q_chunks + hd_v)
    Bq, Sq, H, KV, hd, bk = 2, 24, 4, 2, 16, 8
    q = rng.normal(size=(Bq, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(Bq, Sq, KV, hd)).astype(np.float32)
    v = rng.normal(size=(Bq, Sq, KV, hd_v)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq), (Bq, Sq)).copy()
    kw = dict(window=window, scale=0.25)
    pkw = dict(attn_block_kv=bk, attn_q_chunks=q_chunks)
    want = np.asarray(JL._flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(pos),
        k_pos=jnp.asarray(pos), px=ShardCtx(None, JaxParallelConfig(**pkw)),
        **kw))
    got = L._flash_attention(_t(q), _t(k), _t(v), q_pos=_t(pos),
                             k_pos=_t(pos), pcfg=ParallelConfig(**pkw), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    direct = L._direct_attention(_t(q), _t(k), _t(v), q_pos=_t(pos),
                                 k_pos=_t(pos), **kw)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), **TOL)
    with pytest.raises(ValueError, match="whole number of blocks"):
        L._flash_attention(_t(q), _t(k), _t(v), q_pos=_t(pos),
                           k_pos=_t(pos), pcfg=ParallelConfig(
                               attn_block_kv=7), **kw)


@pytest.mark.parametrize("S", [1, 5, 24, 100, 3072])
def test_doubling_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, size=(2, S, 8)).astype(np.float32)
    b = rng.normal(size=(2, S, 8)).astype(np.float32)

    def comb(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    wa, wb = lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                  axis=1)
    ga, gb = L._linear_scan(_t(a), _t(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=2e-4,
                               atol=1e-30)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL)
    # the recurrence itself, step by step in float64
    h = np.zeros((2, 8))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(gb.numpy()[:, -1], h, **TOL)


def test_doubling_scan_keeps_strong_decay_finite():
    """c_exponent 8: a = exp(-8 softplus(a_param) r) reaches 1e-30 and
    below, where exp(-cumsum(log a)) of the closed form overflows."""
    a = torch.full((1, 3072, 4), 1e-3)
    b = torch.ones((1, 3072, 4))
    A, Bc = L._linear_scan(a, b)
    assert bool(torch.isfinite(A).all()) and bool(torch.isfinite(Bc).all())
    torch.testing.assert_close(Bc[0, -1], torch.full((4,), 1 / (1 - 1e-3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_prefill_then_decode_state_matches_the_reference(dtype):
    """Prefill from a cache, then one decode step from the state it left:
    outputs and the conv and h states equal the reference's (bf16 within
    one ulp of max|y|); the decode writes the state into the cache's own
    buffers."""
    ref_cfg = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg = smoke_config(ARCH).replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, JP.init_params(ref_cfg,
                                                   jax.random.PRNGKey(0)))
    pj = jax.tree.map(lambda a: a[0], tree["segments"][0]["0:rglru"]["rec"])
    pt = P.params_from_jax(tree, cfg)["layers"][0]["rec"]
    dt = jnp.dtype(dtype)
    rng = np.random.default_rng(0)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 24, 64)), dt))
    x1 = np.asarray(jnp.asarray(rng.normal(size=(2, 1, 64)), dt))
    px = ShardCtx(None, JaxParallelConfig())
    jc = {"conv": jnp.zeros((2, 3, 64), dt), "h": jnp.zeros((2, 64))}
    tc = {"conv": torch.zeros((2, 3, 64), dtype=P.DTYPES[dtype]),
          "h": torch.zeros((2, 64))}
    tol = (TOL if dtype == "float32" else dict(rtol=0, atol=2.0 ** -7))
    yj, jc = JL.rglru_block(pj, jnp.asarray(x), cfg=ref_cfg, px=px,
                            mode="prefill", cache=jc)
    yt, tc2 = L.rglru_block(pt, P._to_torch(x, "cpu"), cfg=cfg,
                            pcfg=ParallelConfig(), mode="prefill", cache=tc)
    scale = float(np.abs(np.asarray(yj, np.float32)).max())
    np.testing.assert_allclose(yt.float().numpy() / scale,
                               np.asarray(yj, np.float32) / scale, **tol)
    for name in ("conv", "h"):
        np.testing.assert_allclose(tc2[name].float().numpy(),
                                   np.asarray(jc[name], np.float32), **tol)
    for name, buf in tc.items():
        buf.copy_(tc2[name])
    bufs = dict(tc)
    yj, jc = JL.rglru_block(pj, jnp.asarray(x1), cfg=ref_cfg, px=px,
                            mode="decode", cache=jc)
    yt, tc3 = L.rglru_block(pt, P._to_torch(x1, "cpu"), cfg=cfg,
                            pcfg=ParallelConfig(), mode="decode", cache=tc)
    assert tc3 is tc and all(tc[n] is bufs[n] for n in bufs)
    scale = float(np.abs(np.asarray(yj, np.float32)).max())
    np.testing.assert_allclose(yt.float().numpy() / scale,
                               np.asarray(yj, np.float32) / scale, **tol)
    for name in ("conv", "h"):
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name], np.float32), **tol)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_smoke_model_with_a_rolling_window_matches_jax(kernels):
    family_matches_jax(ARCH, "float32", kernels, {})


def test_smoke_model_blockwise_windowed_prefill_matches_jax():
    family_matches_jax(ARCH, "float32", True, BLOCKWISE)


def test_bf16_smoke_model_matches_jax():
    family_matches_jax(ARCH, "bfloat16", False, {})
