"""End-to-end parity of a smoke model against a live run of the JAX
package, on the CPU: prefill + decode steps of both packages on the
reference's weights (``init_params`` carried across by
``params_from_jax``) and the same numpy inputs, token ids or frame
embeddings with conditioning. Shared by the family test files
(``test_torch_{hybrid,mla,xlstm,musicgen}.py``); not a test module.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import params as jax_params
from repro.models.stepfn import make_decode_step as jax_decode_step
from repro.models.stepfn import make_prefill_step as jax_prefill_step
from repro.parallel.sharding import KernelConfig as JaxKernelConfig
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx

from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.models import params as P
from repro_torch.models.stepfn import make_decode_step, make_prefill_step
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig

B, S, STEPS = 2, 24, 6          # S > the smoke window of 16: the cache rolls
KERNELS = dict(use_flash=True, flash_block_q=8, flash_block_kv=8,
               use_decode=True, decode_block_kv=8, decode_num_splits=2,
               decode_combine="kernel")
# the reference's prefill selections at the smoke size: the blockwise
# attention (a threshold below S, KV blocks of 8, two causal q-chunks)
# and the chunkwise mLSTM (chunks of 8)
BLOCKWISE = dict(flash_threshold=16, attn_block_kv=8, attn_q_chunks=2)
CHUNKED = dict(mlstm_chunk=8)


def _inputs(cfg, tree):
    """The prompt batch (numpy) of either frontend."""
    rng = np.random.default_rng(1)
    if cfg.frontend != "embeddings":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    dt = jnp.dtype(cfg.dtype)
    return {"frame_embeddings": np.asarray(jnp.asarray(
                rng.normal(size=(B, S, cfg.d_model)), dt)),
            "cond": np.asarray(jnp.asarray(
                rng.normal(size=(B, cfg.cross_seq, cfg.d_model)), dt))}


def _step_input(cfg, tree, toks):
    """A decode step's batch from the previous step's greedy tokens: the
    token ids, or the reference server's embedding ``lm_head.w[:, toks].T``."""
    if cfg.frontend != "embeddings":
        return {"tokens": toks[:, None]}
    return {"frame_embeddings": tree["lm_head"]["w"][:, toks].T[:, None, :]}


def _jax_run(cfg, tree, kernel, pkw):
    px = ShardCtx(None, JaxParallelConfig(logits_chunk=0, kernel=kernel,
                                          **{"flash_threshold": 1 << 30,
                                             **pkw}))
    params = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(jax_prefill_step(cfg, px, cache_cap=S + STEPS))
    decode = jax.jit(jax_decode_step(cfg, px))
    batch = jax.tree.map(jnp.asarray, _inputs(cfg, tree))
    logits, cache = prefill(params, batch)
    out, toks = [np.asarray(logits, np.float32)], [np.asarray(
        jnp.argmax(logits, -1))]
    for i in range(STEPS):
        step = jax.tree.map(jnp.asarray, _step_input(cfg, tree, toks[-1]))
        logits, cache = decode(params, cache, step,
                               jnp.asarray(S + i, jnp.int32))
        out.append(np.asarray(logits, np.float32))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    return out, toks


def _torch(a):
    return P._to_torch(a, "cpu")


def _torch_run(cfg, tree, params, kernel, pkw, toks):
    pcfg = ParallelConfig(kernel=kernel, **{"flash_threshold": 1 << 30,
                                            **pkw})
    prefill = make_prefill_step(cfg, pcfg, cache_cap=S + STEPS)
    decode = make_decode_step(cfg, pcfg)
    batch = {k: _torch(v) for k, v in _inputs(cfg, tree).items()}
    logits, cache = prefill(params, batch)
    out = [logits.float().numpy()]
    for i in range(STEPS):
        step = {k: _torch(v) for k, v in
                _step_input(cfg, tree, toks[i]).items()}
        logits, cache = decode(params, cache, step, S + i)
        out.append(logits.float().numpy())
    return out


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def family_matches_jax(name, dtype, kernels, pkw):
    """Prefill + STEPS greedy decode steps of the smoke model in both
    packages on the reference's weights, the port teacher-forced on the
    reference's tokens; fp32 within 1e-4 and the same greedy tokens, bf16
    within 5e-3 of max|logits| or one bf16 ulp of max|logits|, whichever
    is larger: these smoke models' logits reach only 0.5 to 1.3, where
    5e-3 of them is below one ulp of the largest (the logits are bf16
    products), and the packages round some bf16 products and sums apart
    (XLA keeps excess precision where it fuses)."""
    ref_cfg = jax_smoke_config(name).replace(dtype=dtype)
    cfg = smoke_config(name).replace(dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        jax_params.init_params(ref_cfg, jax.random.PRNGKey(0)))
    want, toks = _jax_run(ref_cfg, tree,
                          JaxKernelConfig(**KERNELS) if kernels else None,
                          pkw)
    kfa.launches = kfd.split_launches = 0
    got = _torch_run(cfg, tree, P.params_from_jax(tree, cfg),
                     KernelConfig(**KERNELS) if kernels else None, pkw, toks)
    assert kfa.launches == kfd.split_launches == 0   # plain versions
    denom = max(float(np.abs(want[0]).max()), 1e-6)
    bf16_tol = max(5e-3 * denom, _bf16_ulp(denom))
    for step, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        if dtype == "float32":
            assert err <= 1e-4 * denom, (step, err)
            np.testing.assert_array_equal(np.argmax(g, -1), toks[step])
        else:
            assert err <= bf16_tol, (step, err, denom)
