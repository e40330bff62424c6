"""The port's mixture-of-experts block against the JAX package's, on the CPU.

The same expert weights (the reference's ``init_params`` of qwen3-moe's
smoke config, carried across as numpy) and the same numpy activations go
through ``repro.models.layers.moe_block`` and the port's. The routing is
held to the reference's own lines (``lax.top_k`` on the same fp32 scores,
the cumsum position in expert): the top-k indices and the set of dropped
(token, k) copies must be equal. Outputs: fp32 within 1e-6 of max|y|
(sums in another order), bf16 within 2^-7 of max|y| (one bf16 ulp of the
largest output: each package rounds its products and its sum of the k
weighted rows to bf16, XLA keeping excess precision where it fuses).
"""
import dataclasses
import math

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

ARCH = "qwen3-moe-30b-a3b"
T_B, T_S = 2, 16                       # 32 tokens, 64 routed copies
ROUTERS = {
    "softmax": dict(router_score="softmax", num_shared_experts=0),
    "sigmoid+bias+shared": dict(router_score="sigmoid", num_shared_experts=1),
}


def _configs(dtype, router):
    ref = jax_smoke_config(ARCH)
    mine = smoke_config(ARCH)
    kw = ROUTERS[router]
    return (ref.replace(dtype=dtype, moe=dataclasses.replace(ref.moe, **kw)),
            mine.replace(dtype=dtype, moe=dataclasses.replace(mine.moe, **kw)))


def _moe_params(ref_cfg, seed=0, zero_router=False):
    """One layer's MoE weights of the reference's init, as numpy; a
    sigmoid router gets a nonzero bias, so that it takes part in the
    choice."""
    tree = JP.init_params(ref_cfg, jax.random.PRNGKey(seed))
    pm = jax.tree.map(lambda a: np.asarray(a)[0],
                      tree["segments"][0]["0:attn"]["moe"])
    if "router_bias" in pm:
        pm["router_bias"] = (np.random.default_rng(seed + 3).normal(
            size=pm["router_bias"].shape) * 0.01).astype(np.float32)
    if zero_router:
        pm["router"] = np.zeros_like(pm["router"])
    return pm


def _inputs(ref_cfg, seed=1):
    x = np.random.default_rng(seed).normal(
        size=(T_B, T_S, ref_cfg.d_model)).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(ref_cfg.dtype))


def _reference_routing(pm, x, ref_cfg, C):
    """The reference's router and position-in-expert lines, in JAX, for one
    dispatch group: (top_idx (T,K), dropped (token, k) set)."""
    mo = ref_cfg.moe
    xg = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = xg.astype(jnp.float32) @ jnp.asarray(pm["router"], jnp.float32)
    if mo.router_score == "sigmoid":
        sel = jax.nn.sigmoid(logits) + jnp.asarray(pm["router_bias"])[None]
    else:
        sel = jax.nn.softmax(logits, axis=-1)
    _, top_idx = lax.top_k(sel, mo.top_k)
    flat_e = top_idx.reshape(-1)
    oh = jax.nn.one_hot(flat_e, mo.num_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1, flat_e[:, None],
                              axis=-1)[:, 0]
    dropped = {divmod(int(i), mo.top_k)
               for i in np.nonzero(np.asarray(pos) >= C)[0]}
    return np.asarray(top_idx), dropped


def _both(pm, x, ref_cfg, cfg, cf):
    want, aux_want = JL.moe_block(
        jax.tree.map(jnp.asarray, pm), jnp.asarray(x), cfg=ref_cfg,
        px=ShardCtx(None, JaxParallelConfig(capacity_factor=cf)))
    tp = P.map_tree(lambda a: P._to_torch(a, "cpu"), pm)
    got, aux = L.moe_block(tp, P._to_torch(x, "cpu"), cfg=cfg,
                           pcfg=ParallelConfig(capacity_factor=cf))
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            float(aux), float(aux_want), tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("router", list(ROUTERS))
@pytest.mark.parametrize("cf", [None, 0.5], ids=["cf1.25", "cf0.5"])
def test_moe_block_matches_jax(dtype, router, cf):
    ref_cfg, cfg = _configs(dtype, router)
    pm, x = _moe_params(ref_cfg), _inputs(ref_cfg)
    got, want, aux, aux_want, tp = _both(pm, x, ref_cfg, cfg, cf)
    T = T_B * T_S
    C = L.moe_capacity(T, cfg, ParallelConfig(capacity_factor=cf))
    top_want, dropped_want = _reference_routing(pm, x, ref_cfg, C)
    xg = P._to_torch(x, "cpu").reshape(T, -1)
    top, _, _, keep, _, _ = L.moe_route(tp, xg, cfg=cfg, C=C)
    K = cfg.moe.top_k
    dropped = {divmod(int(i), K) for i in torch.nonzero(~keep)[:, 0]}
    np.testing.assert_array_equal(top.numpy(), top_want)
    assert dropped == dropped_want
    if cf == 0.5:
        assert dropped            # the case drops copies, as it means to
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert aux == pytest.approx(aux_want, rel=1e-5)


def test_moe_capacity_is_the_references():
    cfg = smoke_config(ARCH)
    assert L.moe_capacity(32, cfg, ParallelConfig()) == 10    # ceil(32*2/8*1.25)
    assert L.moe_capacity(32, cfg, ParallelConfig(capacity_factor=0.5)) == 4
    assert L.moe_capacity(1, cfg, ParallelConfig()) == 1       # at most T
    full = ParallelConfig()
    from repro_torch.configs.registry import get_arch
    q = get_arch(ARCH)
    assert L.moe_capacity(4, q, full) == 4                     # decode, B 4
    assert L.moe_capacity(4096, q, full) == 320                # prefill 4 x 1,024


def test_router_ties_go_to_the_lower_expert_as_in_lax_top_k():
    """A zero router scores every expert alike: lax.top_k takes experts
    0..k-1 for every token, and so must the port's stable sort."""
    ref_cfg, cfg = _configs("float32", "softmax")
    pm, x = _moe_params(ref_cfg, zero_router=True), _inputs(ref_cfg)
    T, K = T_B * T_S, cfg.moe.top_k
    C = L.moe_capacity(T, cfg, ParallelConfig())
    top_want, dropped_want = _reference_routing(pm, x, ref_cfg, C)
    tp = P.map_tree(lambda a: P._to_torch(a, "cpu"), pm)
    top, _, _, keep, _, _ = L.moe_route(
        tp, P._to_torch(x, "cpu").reshape(T, -1), cfg=cfg, C=C)
    assert np.all(top_want == np.arange(K))
    np.testing.assert_array_equal(top.numpy(), top_want)
    assert {divmod(int(i), K) for i in torch.nonzero(~keep)[:, 0]} == \
        dropped_want
    got, want, *_ = _both(pm, x, ref_cfg, cfg, None)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_drop_slot_never_reaches_the_output():
    """Copies past an expert's capacity all land in the drop slot, in an
    order the scatter does not fix. The output is held to a per-token
    formula that has no slots at all: y_t = sum over kept copies of
    gate x expert(x_t), so nothing of which duplicate the drop slot kept
    can show."""
    ref_cfg, cfg = _configs("float32", "sigmoid+bias+shared")
    pm, x = _moe_params(ref_cfg), _inputs(ref_cfg)
    pcfg = ParallelConfig(capacity_factor=0.25)
    tp = P.map_tree(lambda a: P._to_torch(a, "cpu"), pm)
    xt = P._to_torch(x, "cpu")
    y, _ = L.moe_block(tp, xt, cfg=cfg, pcfg=pcfg)
    T, K = T_B * T_S, cfg.moe.top_k
    xg = xt.reshape(T, -1)
    C = L.moe_capacity(T, cfg, pcfg)
    top, w, _, keep, _, _ = L.moe_route(tp, xg, cfg=cfg, C=C)
    assert int((~keep).sum()) > T // 2        # most copies are dropped
    want = L.mlp(tp["shared"], xg, cfg)
    for t in range(T):
        for j in range(K):
            if keep[t * K + j]:
                e = int(top[t, j])
                h = torch.nn.functional.silu(xg[t] @ tp["wg"][e]) * (
                    xg[t] @ tp["wu"][e])
                want[t] += w[t, j] * (h @ tp["wd"][e])
    got = y.reshape(T, -1)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-7)


def test_moe_aux_is_returned_to_a_caller_that_asks():
    """The model sums each MoE layer's aux loss and returns it with
    ``return_aux``; the serve path's call leaves it out."""
    from repro_torch.models import model as M
    cfg = smoke_config(ARCH).replace(dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 8)))
    pos = torch.arange(8)[None].expand(2, 8)
    with torch.inference_mode():
        x, cache, aux = M.forward(params, cfg=cfg, pcfg=ParallelConfig(),
                                  mode="train", tokens=toks, positions=pos,
                                  return_aux=True)
        x2, _ = M.forward(params, cfg=cfg, pcfg=ParallelConfig(),
                          mode="train", tokens=toks, positions=pos)
    assert cache is None and torch.equal(x, x2)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert math.isfinite(float(aux))


@pytest.mark.parametrize("dtype,kernels", [("float32", False),
                                           ("float32", True),
                                           ("bfloat16", True)],
                         ids=["fp32-plain", "fp32-kernels", "bf16-kernels"])
def test_moe_smoke_prefill_and_decode_match_jax(dtype, kernels):
    """qwen3-moe's smoke model end to end against the reference (the
    shared helper of ``test_torch_families.py``). bf16 within 2^-6 of
    max|logits|, two bf16 ulps of the largest logit: the head's products
    are rounded to bf16 in both packages, and the residual stream and the
    k weighted expert rows round in other places (XLA keeps excess
    precision inside its fusions); measured 1 to 2 ulps."""
    from test_torch_families import smoke_models_match_jax
    smoke_models_match_jax(ARCH, dtype, kernels, bf16_tol=2.0 ** -6)
