"""The port's loss and gradients against a live run of the JAX package, on
the CPU: the reference's ``init_params`` weights (carried across by
``params_from_jax``) and the same numpy batch go through
``jax.value_and_grad(repro.models.stepfn.loss_fn)`` and the port's
``loss_fn`` + ``torch.autograd.grad``, the smoke configs in fp32. Shared
by ``test_torch_train_grads*.py``; not a test module.
"""
import jax
import jax.numpy as jnp
import numpy as np

import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import params as jax_params
from repro.models.stepfn import loss_fn as jax_loss_fn
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx

from repro_torch.configs.registry import smoke_config
from repro_torch.models import params as P
from repro_torch.models.stepfn import loss_fn
from repro_torch.parallel.sharding import ParallelConfig

# S passes the smoke window of 16 and is whole chunks of 8 (the mLSTM's
# and the blockwise attention's)
B, S = 2, 24
# the TrainLoop's parallel defaults: materialized attention, unchunked xent
TRAIN_PCFG = {"flash_threshold": 1 << 30, "logits_chunk": 0}
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


def configs(name):
    """(reference config, port config), the smoke config in fp32."""
    return (jax_smoke_config(name).replace(dtype="float32"),
            smoke_config(name).replace(dtype="float32"))


def ref_tree(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jax_params.init_params(cfg, jax.random.PRNGKey(seed)))


def batch_np(cfg, seed=1, rows=B):
    """Token ids, or for the ``embeddings`` frontend frame embeddings,
    labels (a few masked with -1) and the cross-attention condition."""
    rng = np.random.default_rng(seed)
    if cfg.frontend != "embeddings":
        return {"tokens": rng.integers(0, cfg.vocab_size,
                                       (rows, S)).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)
    labels[0, -3:] = -1
    return {"frame_embeddings": rng.normal(
                size=(rows, S, cfg.d_model)).astype(np.float32),
            "labels": labels,
            "cond": rng.normal(
                size=(rows, cfg.cross_seq, cfg.d_model)).astype(np.float32)}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_loss_and_grads(cfg, tree, batch, pkw):
    px = ShardCtx(None, JaxParallelConfig(**{**TRAIN_PCFG, **pkw}))
    f = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, cfg=cfg, px=px), has_aux=True))
    (loss, met), grads = f(jax.tree.map(jnp.asarray, tree),
                           jax.tree.map(jnp.asarray, batch))
    return float(loss), jax.tree.map(np.asarray, met), \
        jax.tree.map(np.asarray, grads)


def torch_loss_and_grads(cfg, params, batch, pkw):
    """(loss, metrics, {path: grad}) of the port's loss_fn."""
    views = P.trainable(params)
    loss, met = loss_fn(views, to_torch(batch), cfg=cfg,
                        pcfg=ParallelConfig(**{**TRAIN_PCFG, **pkw}))
    flat = list(P.leaves(views))
    grads = torch.autograd.grad(loss, [t for _, t in flat],
                                materialize_grads=True)
    met = {k: v.detach() for k, v in met.items()}
    return float(loss.detach()), met, {path: g for (path, _), g in
                                       zip(flat, grads)}


def assert_grads_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Each leaf: max|got - want| <= rtol x max|want| + atol."""
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = np.asarray(want[path], np.float32)
        err = float(np.abs(g.detach().float().numpy() - w).max())
        assert err <= rtol * float(np.abs(w).max()) + atol, (path, err)


def family_grads_match_jax(name, pkw):
    """The smoke model's loss within LOSS_RTOL and every gradient leaf
    within GRAD_RTOL of the reference's, on the reference's weights."""
    ref_cfg, cfg = configs(name)
    tree = ref_tree(ref_cfg)
    batch = batch_np(cfg)
    want_loss, want_met, want_g = jax_loss_and_grads(ref_cfg, tree, batch,
                                                     pkw)
    loss, met, grads = torch_loss_and_grads(
        cfg, P.params_from_jax(tree, cfg), batch, pkw)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for k in ("xent", "aux", "n_tokens"):
        np.testing.assert_allclose(float(met[k]), float(want_met[k]),
                                   rtol=LOSS_RTOL, atol=1e-9)
    assert_grads_close(grads, dict(P.leaves(P.params_from_jax(want_g, cfg))))
    return met


def assert_updates_close(before, got, want, rtol=1e-3):
    """Each leaf's change over a run of AdamW steps, port against
    reference: ||d_got - d_want||_2 <= rtol ||d_want||_2. Not each weight
    on its own: AdamW moves a weight by about lr g / (|g| + eps), so a
    gradient entry near eps = 1e-8 (a sum that cancels, as some of a few
    thousand always are) moves its weight by an amount its last bits set,
    in either package; the gradients themselves are held entry by entry
    (:func:`assert_grads_close`)."""
    for path, b in before.items():
        b = np.asarray(b, np.float64)
        d_got = got[path].detach().double().numpy() - b
        d_want = np.asarray(want[path], np.float64) - b
        err = float(np.linalg.norm(d_got - d_want))
        assert err <= rtol * float(np.linalg.norm(d_want)) + 1e-12, \
            (path, err, float(np.linalg.norm(d_want)))
