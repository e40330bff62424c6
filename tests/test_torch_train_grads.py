"""Training's loss and gradients, the port against a live run of the JAX
package on the CPU (``tests/torch_train_parity.py``): the attention
families (gemma-2b tied and scaled, through the materialized and the
blockwise attention; qwen3-moe-30b-a3b with its aux loss;
deepseek-v3-671b's MLA with dense first layers; musicgen-large's frame
embeddings, labels and cross-attention), the chunked cross-entropy,
``remat`` and ``microbatches``. The recurrent families are in
``test_torch_train_grads_recurrent.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models.stepfn import make_train_step as jax_make_train_step
from repro.optim.optimizers import AdamW as JaxAdamW
from repro.optim.optimizers import warmup_cosine as jax_warmup_cosine
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.models import params as P
from repro_torch.models.stepfn import make_train_step
from repro_torch.optim.optimizers import AdamW, warmup_cosine
from repro_torch.parallel.sharding import ParallelConfig

from torch_train_parity import (TRAIN_PCFG, assert_grads_close,
                                assert_updates_close, batch_np, configs,
                                family_grads_match_jax, jax_loss_and_grads,
                                ref_tree, to_torch, torch_loss_and_grads)

# the reference's blockwise attention at the smoke size: a threshold below
# S, KV blocks of 8, two causal q-chunks
BLOCKWISE = dict(flash_threshold=16, attn_block_kv=8, attn_q_chunks=2)


@pytest.mark.parametrize("name,pkw", [
    ("gemma-2b", {}), ("gemma-2b", BLOCKWISE), ("gemma-2b", {"logits_chunk": 8}),
    ("qwen3-moe-30b-a3b", {}), ("deepseek-v3-671b", {}),
    ("musicgen-large", {})],
    ids=["gemma-2b", "gemma-2b-blockwise", "gemma-2b-xent-chunk-8",
         "qwen3-moe-30b-a3b", "deepseek-v3-671b", "musicgen-large"])
def test_loss_and_grads_match_jax(name, pkw):
    """Loss within 1e-5 relative, each gradient leaf within 1e-4 of its
    largest entry (+1e-7), on the reference's weights and batch; the MoE
    families' aux loss is part of the loss and has a gradient."""
    met = family_grads_match_jax(name, pkw)
    if "moe" in name or "deepseek" in name:
        assert float(met["aux"]) > 0


def test_gemma_at_full_width_matches_jax():
    """gemma-2b's widths (d_model 2,048, MQA at head dim 256, the tied
    head over sqrt(d)-scaled embeddings) at one layer, d_ff 1,024 and a
    vocab of 4,096: the loss and every gradient leaf as the reference's.
    At this width the scaled embedding dominates the residual stream, so
    each token's own logit is about d_model x 0.02 = 41 at init, and the
    loss at init sits far above ln V in both packages."""
    kw = dict(num_layers=1, vocab_size=4096, d_ff=1024, dtype="float32")
    ref_cfg = jax_get_arch("gemma-2b").replace(**kw)
    cfg = get_arch("gemma-2b").replace(**kw)
    tree = ref_tree(ref_cfg)
    batch = batch_np(cfg)
    want_loss, _, want_g = jax_loss_and_grads(ref_cfg, tree, batch, {})
    loss, _, grads = torch_loss_and_grads(
        cfg, P.params_from_jax(tree, cfg), batch, {})
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert want_loss > math.log(cfg.vocab_size) + 20
    assert_grads_close(grads, dict(P.leaves(P.params_from_jax(want_g, cfg))))


def _port_grads(name, pkw):
    ref_cfg, cfg = configs(name)
    params = P.params_from_jax(ref_tree(ref_cfg), cfg)
    return torch_loss_and_grads(cfg, params, batch_np(cfg), pkw)


@pytest.mark.parametrize("pkw", [{"logits_chunk": 8}, {"remat": "dots"},
                                 {"remat": "full"},
                                 {"remat": "full", "logits_chunk": 8}],
                         ids=["xent-chunk-8", "remat-dots", "remat-full",
                              "remat-full-xent-chunk-8"])
def test_chunks_and_remat_change_memory_not_the_function(pkw):
    """The chunked cross-entropy (each chunk under checkpoint) and both
    remat policies give the loss and gradients of the plain step, to fp32
    rounding; qwen3-moe carries its aux loss through the checkpoints."""
    base_loss, base_met, base = _port_grads("qwen3-moe-30b-a3b", {})
    loss, met, grads = _port_grads("qwen3-moe-30b-a3b", pkw)
    assert loss == pytest.approx(base_loss, rel=1e-6)
    assert float(met["aux"]) == pytest.approx(float(base_met["aux"]),
                                              rel=1e-6)
    assert_grads_close(grads, {p: g.numpy() for p, g in base.items()},
                       rtol=1e-6, atol=1e-9)


def test_remat_rejects_an_unknown_policy():
    with pytest.raises(ValueError, match="remat"):
        _port_grads("gemma-2b", {"remat": "everything"})


def test_microbatches_2_match_the_reference_train_step():
    """One AdamW train step over 4 rows in 2 microbatches (fp32 gradients
    accumulated, each divided by 2) in both packages: the loss and the
    global norm within 1e-5 relative, both moments within 1e-4 of their
    largest entry, each leaf's weight update within 1e-3 of its norm
    (``assert_updates_close`` says why not entry by entry)."""
    ref_cfg, cfg = configs("gemma-2b")
    tree = ref_tree(ref_cfg)
    batch = batch_np(cfg, rows=4)
    pkw = {**TRAIN_PCFG, "microbatches": 2}
    jopt = JaxAdamW(schedule=jax_warmup_cosine(3e-3, 1, 3), weight_decay=0.01)
    jstep = jax.jit(jax_make_train_step(
        ref_cfg, ShardCtx(None, JaxParallelConfig(**pkw)), jopt))
    jparams = jax.tree.map(jnp.asarray, tree)
    new_tree, new_state, jmet = jstep(jparams, jopt.init(jparams),
                                      jax.tree.map(jnp.asarray, batch), 0)
    opt = AdamW(schedule=warmup_cosine(3e-3, 1, 3), weight_decay=0.01)
    params = P.params_from_jax(tree, cfg)
    before = {p: t.clone() for p, t in P.leaves(params)}
    state = opt.init(params)
    params, state, met = make_train_step(cfg, ParallelConfig(**pkw), opt)(
        params, state, to_torch(batch), 0)
    assert set(met) == {"loss", "grad_norm", "lr", "step"}
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-5)
    want = P.opt_state_from_jax(jax.tree.map(np.asarray, new_state), cfg)
    for part in ("mu", "nu"):
        assert_grads_close(dict(P.leaves(state[part])),
                           {p: t.numpy() for p, t in P.leaves(want[part])})
    assert int(state["count"]) == int(want["count"]) == 1
    assert_updates_close(
        {p: t.numpy() for p, t in before.items()}, dict(P.leaves(params)),
        dict(P.leaves(P.params_from_jax(jax.tree.map(np.asarray, new_tree),
                                        cfg))))


def _bf16_model_case():
    """gemma-2b's smoke layers in bf16 at d_model 256 and a vocab of 4,096,
    B 2 x S 64: (loss, {path: grad}) of both packages."""
    kw = dict(d_model=256, vocab_size=4096, dtype="bfloat16")
    ref_cfg = jax_smoke_config("gemma-2b").replace(**kw)
    cfg = smoke_config("gemma-2b").replace(**kw)
    tree = ref_tree(ref_cfg)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(
        np.int32)}
    want_loss, _, want_g = jax_loss_and_grads(ref_cfg, tree, batch, {})
    loss, _, grads = torch_loss_and_grads(
        cfg, P.params_from_jax(tree, cfg), batch, {})
    return (loss, grads), (want_loss,
                           dict(P.leaves(P.params_from_jax(want_g, cfg))))


def _bf16_xent_case():
    """The unchunked cross-entropy alone on random bf16 hidden states
    (B 2 x S 64 x d 256) and a random bf16 head (d 256 x V 4,096), both
    unit normal, so that the logits are large (a loss near 118) and bf16
    rounding of them shows: (loss, {name: grad}) of both packages."""
    from repro.models.stepfn import chunked_xent as jax_chunked_xent
    from repro_torch.models.stepfn import chunked_xent
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 64, 256)).astype(np.float32)
    w = rng.normal(size=(256, 4096)).astype(np.float32)
    labels = rng.integers(0, 4096, (2, 64)).astype(np.int32)
    labels[1, -5:] = -1
    px = ShardCtx(None, JaxParallelConfig(logits_chunk=0))

    def jloss(xx, ww):
        tot, cnt = jax_chunked_xent(xx, ww, jnp.asarray(labels), px)
        return tot / cnt

    jl, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in (x, w))
    tot, cnt = chunked_xent(tx, tw, torch.from_numpy(labels).long(),
                            ParallelConfig(logits_chunk=0))
    loss = tot / cnt
    gx, gw = torch.autograd.grad(loss, [tx, tw])
    want = {n: P._to_torch(np.asarray(g), "cpu")
            for n, g in (("x", jgx), ("head", jgw))}
    return (float(loss), {"x": gx, "head": gw}), (float(jl), want)


@pytest.mark.parametrize("case", [_bf16_model_case, _bf16_xent_case],
                         ids=["model", "xent"])
def test_bf16_loss_and_grads_match_jax(case):
    """bf16 operands, B 2 x S 64, d 256, V 4,096, the unchunked loss: the
    loss within 1e-5 relative of ``jax.value_and_grad``'s, which holds
    only if the head product's result stays fp32, as the reference's
    ``preferred_element_type`` keeps it (rounding the logits to bf16
    first moves the xent case's loss by 1.7e-4 relative). Each gradient,
    in its parameter's dtype, within 2e-2 of its largest entry, the limit
    the served bf16 logits are held to: the two packages round bf16
    intermediates at different points (XLA's CPU fusions keep some in
    fp32), which moves most bf16 gradient entries of the model case by
    more than an ulp (up to about 1e-2 of a leaf's largest entry,
    measured)."""
    (loss, grads), (want_loss, want) = case()
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
    assert sorted(grads) == sorted(want)
    for path, g in grads.items():
        w = want[path].float().numpy()
        assert g.dtype == want[path].dtype, path
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= 2e-2 * float(np.abs(w).max()), (path, err)
