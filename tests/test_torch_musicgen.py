"""musicgen-large's pieces against the JAX package's, on the CPU: the
sinusoidal positions of the ``embeddings`` frontend, cross-attention over
the conditioning's K/V (``cond_kv``), the smoke model end to end (frame
embeddings and conditioning in, each decode step embedding its token by
``lm_head.w[:, token]`` as the reference's server does), and
``DecodeServer`` serving it. Blocks at the reference's fp32 2e-4; the
model as ``torch_family_parity``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import params as JP
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models.stepfn import make_decode_step, make_prefill_step
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig

from torch_family_parity import BLOCKWISE, KERNELS, family_matches_jax

ARCH = "musicgen-large"
TOL = dict(rtol=2e-4, atol=2e-4)


def test_sinusoidal_positions_match_the_reference():
    """Within fp32 rounding of the angle (position x frequency, up to
    3,136 radians, where one fp32 ulp of the angle is 2.4e-4: the
    packages' exp may round a frequency an ulp apart)."""
    pos = np.stack([np.arange(3136), np.arange(3136)[::-1]])
    for d in (64, 2048):
        want = np.asarray(JM._sinusoidal(jnp.asarray(pos, jnp.int32), d))
        got = M._sinusoidal(torch.from_numpy(pos.copy()), d).numpy()
        assert got.dtype == np.float32 and got.shape == (2, 3136, d)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_over_cond_kv_matches_the_reference(dtype):
    ref_cfg = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg = smoke_config(ARCH).replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, JP.init_params(ref_cfg,
                                                   jax.random.PRNGKey(0)))
    pj = jax.tree.map(lambda a: a[0], tree["segments"][0]["0:attn"]["cross"])
    pt = P.params_from_jax(tree, cfg)["layers"][0]["cross"]
    assert "q_norm" not in pt and set(pt) == {"wq", "wk", "wv", "wo"}
    rng = np.random.default_rng(0)
    dt = jnp.dtype(dtype)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 24, 64)), dt))
    cond = np.asarray(jnp.asarray(rng.normal(size=(2, 8, 64)), dt))
    kj = JL.cond_kv(pj, jnp.asarray(cond), cfg=ref_cfg)
    kt = L.cond_kv(pt, P._to_torch(cond, "cpu"), cfg=cfg)
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=2.0 ** -7)
    for a, b in zip(kt, kj):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    want = np.asarray(JL.cross_attention(
        pj, jnp.asarray(x), kj, cfg=ref_cfg,
        px=ShardCtx(None, JaxParallelConfig())), np.float32)
    got = L.cross_attention(pt, P._to_torch(x, "cpu"), kt, cfg=cfg)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               **tol)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_smoke_model_matches_jax(kernels):
    family_matches_jax(ARCH, "float32", kernels, {})


def test_smoke_model_blockwise_prefill_matches_jax():
    family_matches_jax(ARCH, "float32", False, BLOCKWISE)


def test_bf16_smoke_model_matches_jax():
    family_matches_jax(ARCH, "bfloat16", False, {})


def test_decode_server_serves_frame_embeddings_on_cpu():
    """The server's prompt is frame embeddings and conditioning from its
    seed; each decode step embeds the last greedy token by
    ``lm_head.w[:, token]``: the logits equal the step functions run by
    hand on those inputs, and the conditioning's K/V stay in the cache."""
    cfg = smoke_config(ARCH).replace(dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kc = KernelConfig(**KERNELS)
    srv = serve.DecodeServer(cfg, ParallelConfig(kernel=kc), batch=2,
                             prompt_len=16, decode_steps=4, device="cpu",
                             params=params, keep_logits=4)
    batch = srv.input_batch()
    assert batch["frame_embeddings"].shape == (2, 16, 64)
    assert batch["cond"].shape == (2, cfg.cross_seq, 64)
    srv.prefill_batch(batch)
    for _ in range(4):
        srv.decode_step()
    pcfg = ParallelConfig(kernel=kc)
    logits, cache = make_prefill_step(cfg, pcfg, cache_cap=20)(params, batch)
    want = [logits]
    decode = make_decode_step(cfg, pcfg)
    w = params["lm_head"]["w"]
    for i in range(4):
        toks = srv.out[i]
        logits, cache = decode(params, cache, {
            "frame_embeddings": w[:, toks].T[:, None, :]}, 16 + i)
        want.append(logits)
    for a, b in zip(srv.kept, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    k, _ = L.cond_kv(params["layers"][1]["cross"], batch["cond"], cfg=cfg)
    torch.testing.assert_close(srv.cache[1]["cross_k"], k, rtol=0, atol=0)
    assert srv.prefill_dispatch.endswith("; cross-attention: plain")
