"""xlstm-1.3b's blocks against the JAX package's, on the CPU: the
chunkwise mLSTM in fp32 and with bf16 streams against the reference's and
against the port's own per-step scan, the mLSTM block's decode state
written in place, the sLSTM block with and without a cache, the smoke
model end to end, and a stored sharding cell's ``mlstm_chunk`` reaching
the server's ``ParallelConfig`` and choosing the mLSTM path. Blocks at the
reference's fp32 2e-4 (bf16 streams: their own rounding, below); the
model as ``torch_family_parity``.
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
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.parallel.sharding import ParallelConfig

from torch_family_parity import CHUNKED, family_matches_jax

ARCH = "xlstm-1.3b"
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mlstm_inputs(S=32, seed=0):
    rng = np.random.default_rng(seed)
    B, nh, dqk, dv = 2, 2, 8, 16
    q = (rng.normal(size=(B, S, nh, dqk)) / np.sqrt(dqk)).astype(np.float32)
    k = rng.normal(size=(B, S, nh, dqk)).astype(np.float32)
    v = rng.normal(size=(B, S, nh, dv)).astype(np.float32)
    ig = rng.normal(size=(B, S, nh)).astype(np.float32)
    fg = (rng.normal(size=(B, S, nh)) + 2.0).astype(np.float32)
    c0 = rng.normal(size=(B, nh, dqk, dv)).astype(np.float32) * 0.1
    n0 = rng.normal(size=(B, nh, dqk)).astype(np.float32) * 0.1
    m0 = rng.normal(size=(B, nh)).astype(np.float32) * 0.1
    return q, k, v, ig, fg, c0, n0, m0


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("bf16_streams", [False, True], ids=["fp32", "bf16"])
def test_chunkwise_mlstm_matches_the_reference_and_the_step_scan(
        chunk, bf16_streams):
    args = _mlstm_inputs(seed=chunk)
    h_j, st_j = JL._mlstm_chunkwise(*(jnp.asarray(a) for a in args), chunk,
                                    bf16_streams=bf16_streams)
    h_t, st_t = L._mlstm_chunkwise(*(_t(a) for a in args), chunk,
                                   bf16_streams=bf16_streams)
    h_s, st_s = L._mlstm_steps(*(_t(a) for a in args))
    # bf16 streams: each package rounds its bf16 products (XLA keeps excess
    # precision where it fuses), so they agree to one bf16 ulp of the
    # largest value (2^-7 of max|ref|, as the MoE block's bf16 test); the
    # fp32 step scan is farther: bf16's own rounding, a few products deep
    ref_tol = TOL if not bf16_streams else dict(rtol=0, atol=2.0 ** -7)
    step_tol = TOL if not bf16_streams else dict(rtol=0, atol=3e-2)
    pairs = [(h_t, np.asarray(h_j), h_s)] + [
        (a, np.asarray(b), c) for a, b, c in zip(st_t, st_j, st_s)]
    for got, want, steps in pairs:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   **ref_tol)
        np.testing.assert_allclose(got.numpy() / scale,
                                   steps.numpy() / scale, **step_tol)


def _block(kind, dtype="float32"):
    ref_cfg = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg = smoke_config(ARCH).replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, JP.init_params(ref_cfg,
                                                   jax.random.PRNGKey(0)))
    j = 0 if kind == "mlstm" else 7
    key = {"mlstm": "mlstm", "slstm": "slstm"}[kind]
    pj = jax.tree.map(lambda a: a[0],
                      tree["segments"][0][f"{j}:{kind}"][key])
    pt = P.params_from_jax(tree, cfg)["layers"][j][key]
    return ref_cfg, cfg, pj, pt, j


@pytest.mark.parametrize("chunk", [0, 8], ids=["steps", "chunked"])
def test_mlstm_block_prefill_then_decode_in_place_matches_the_reference(
        chunk):
    ref_cfg, cfg, pj, pt, j = _block("mlstm")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    px = ShardCtx(None, JaxParallelConfig(mlstm_chunk=chunk))
    pcfg = ParallelConfig(mlstm_chunk=chunk)
    from repro.models.model import init_cache as jax_init_cache
    jc = jax.tree.map(lambda a: a[0], jax_init_cache(ref_cfg, 2, 8)[
        "segments"][0][f"{j}:mlstm"])
    tc = M.init_cache(cfg, 2, 8)[j]
    yj, jc = JL.mlstm_block(pj, jnp.asarray(x), cfg=ref_cfg, px=px,
                            mode="prefill", cache=jc)
    yt, new = L.mlstm_block(pt, _t(x), cfg=cfg, pcfg=pcfg, mode="prefill",
                            cache=tc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for name, buf in tc.items():
        buf.copy_(new[name])
    held = dict(tc)
    for _ in range(2):
        x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
        yj, jc = JL.mlstm_block(pj, jnp.asarray(x1), cfg=ref_cfg, px=px,
                                mode="decode", cache=jc)
        yt, out = L.mlstm_block(pt, _t(x1), cfg=cfg, pcfg=pcfg,
                                mode="decode", cache=tc)
        assert out is tc and all(tc[n] is held[n] for n in held)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for name in ("c", "n", "m", "conv"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("cached", [False, True], ids=["no cache", "cache"])
def test_slstm_block_matches_the_reference(cached):
    """Without a cache the normalizer starts at 1e-6, in a cache at 1; a
    decode step then continues from the prefill's state in place."""
    ref_cfg, cfg, pj, pt, j = _block("slstm")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    px = ShardCtx(None, JaxParallelConfig())
    jc = tc = None
    if cached:
        from repro.models.model import init_cache as jax_init_cache
        jc = jax.tree.map(lambda a: a[0], jax_init_cache(ref_cfg, 2, 8)[
            "segments"][0][f"{j}:slstm"])
        tc = M.init_cache(cfg, 2, 8)[j]
    yj, jn = JL.slstm_block(pj, jnp.asarray(x), cfg=ref_cfg, px=px,
                            mode="prefill", cache=jc)
    yt, tn = L.slstm_block(pt, _t(x), cfg=cfg, pcfg=ParallelConfig(),
                           mode="prefill", cache=tc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    if not cached:
        assert tn is None
        return
    for name, buf in tc.items():
        np.testing.assert_allclose(tn[name].numpy(), np.asarray(jn[name]),
                                   **TOL)
        buf.copy_(tn[name])
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    yj, jn = JL.slstm_block(pj, jnp.asarray(x1), cfg=ref_cfg, px=px,
                            mode="decode", cache=jn)
    yt, out = L.slstm_block(pt, _t(x1), cfg=cfg, pcfg=ParallelConfig(),
                            mode="decode", cache=tc)
    assert out is tc
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for name in ("c", "n", "h", "m"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jn[name]),
                                   **TOL)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_smoke_model_matches_jax(kernels):
    family_matches_jax(ARCH, "float32", kernels, {})


@pytest.mark.parametrize("pkw", [CHUNKED, dict(CHUNKED,
                                              mlstm_bf16_streams=True)],
                         ids=["chunked", "chunked-bf16-streams"])
def test_smoke_model_chunkwise_prefill_matches_jax(pkw):
    family_matches_jax(ARCH, "float32", True, pkw)


def test_bf16_smoke_model_matches_jax():
    family_matches_jax(ARCH, "bfloat16", False, {})


def test_a_stored_mlstm_chunk_reaches_the_server_and_picks_the_path(
        tmp_path):
    """A sharding cell's record for xlstm carries ``mlstm_chunk``: the
    server resolves it into its ParallelConfig (as the reference's
    ``apply_sharding_config`` does, ``flash`` as ``flash_threshold``), and
    the prefill runs the chunkwise scan it selects, where the default runs
    the per-step scan."""
    from repro.store.resolve import \
        apply_sharding_config as jax_apply_sharding_config
    from repro_torch.core.tuning_targets import sharding_space
    from repro_torch.launch import serve
    from repro_torch.store import SpaceFingerprint, TuningRecord
    from repro_torch.store import TuningRecordStore
    from repro_torch.store.resolve import (apply_sharding_config,
                                           cell_objective)
    shape = "decode_32k"
    space = sharding_space(ARCH, shape)
    idx = next(i for i in range(space.size)
               if space.config(i)["mlstm_chunk"] == 8 * 4
               and space.config(i)["flash"] == 0)
    rec = space.config(idx)
    fp = SpaceFingerprint.of(space, objective=cell_objective(ARCH, shape))
    store = TuningRecordStore(str(tmp_path / "store"))
    store.append(TuningRecord(fp=fp.digest, run="t", seq=0, key=str(idx),
                              idx=idx, value=0.5, config=rec),
                 fingerprint=fp)
    store.close()
    logged = []
    pcfg = apply_sharding_config(ParallelConfig(), rec, log=logged.append)
    want = jax_apply_sharding_config(JaxParallelConfig(), rec)
    for f in ("mlstm_chunk", "flash_threshold", "attn_block_kv",
              "attn_q_chunks"):
        assert getattr(pcfg, f) == getattr(want, f), f
    assert pcfg.mlstm_chunk == 32 and pcfg.flash_threshold == 1 << 30
    assert len(logged) == 1 and "mlstm_chunk" not in logged[0]
    resolved = serve.resolve_pcfg(ParallelConfig(), str(tmp_path / "store"),
                                  ARCH, shape, mesh="single")
    assert resolved.mlstm_chunk == 32

    calls = []
    orig = L._mlstm_chunkwise

    def spy(*a, **kw):
        calls.append(a[8])
        return orig(*a, **kw)

    cfg = smoke_config(ARCH)
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    try:
        L._mlstm_chunkwise = spy
        for p, want_calls in ((ParallelConfig(), []),
                              (resolved, [32] * 8)):
            srv = serve.DecodeServer(cfg, p, batch=1, prompt_len=64,
                                     decode_steps=1, device="cpu",
                                     params=params)
            calls.clear()
            srv.prefill_batch(srv.input_batch())
            assert calls == want_calls
    finally:
        L._mlstm_chunkwise = orig
    assert "chunkwise scan (chunk 32)" in srv.prefill_dispatch
