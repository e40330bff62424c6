"""The port's dense decoder and serve path against a live run of the JAX
package, on the CPU.

The same weights (the reference's ``init_params``, carried across by
``params_from_jax``) and the same numpy prompt go through both packages'
prefill and decode steps. The golden file ``tests/golden/decode_logits.json``
is not used: on this jax version the reference no longer reproduces it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import params as jax_params
from repro.models.stepfn import make_decode_step as jax_decode_step
from repro.models.stepfn import make_prefill_step as jax_prefill_step
from repro.parallel.sharding import KernelConfig as JaxKernelConfig
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.model import Decoder, init_cache
from repro_torch.models.stepfn import make_decode_step, make_prefill_step
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig

B, S, STEPS = 2, 8, 12
KERNELS = dict(use_flash=True, flash_block_q=8, flash_block_kv=8,
               use_decode=True, decode_block_kv=8, decode_num_splits=2,
               decode_combine="kernel")


def _jax_tree(cfg, seed=0):
    tree = jax_params.init_params(cfg, jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, tree)


def _prompt(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))


def _jax_run(cfg, tree, kernel):
    """Prefill + STEPS greedy decode steps in the JAX package: the logits
    of every step and the greedy tokens fed to the next."""
    px = ShardCtx(None, JaxParallelConfig(flash_threshold=1 << 30,
                                          logits_chunk=0, kernel=kernel))
    params = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(jax_prefill_step(cfg, px, cache_cap=S + STEPS))
    decode = jax.jit(jax_decode_step(cfg, px))
    logits, cache = prefill(params, {"tokens": jnp.asarray(_prompt(cfg))})
    out, toks = [np.asarray(logits, np.float32)], [np.asarray(
        jnp.argmax(logits, -1))]
    for i in range(STEPS):
        logits, cache = decode(params, cache,
                               {"tokens": jnp.asarray(toks[-1])[:, None]},
                               jnp.asarray(S + i, jnp.int32))
        out.append(np.asarray(logits, np.float32))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    return out, toks


def _torch_run(cfg, params, kernel, toks):
    """The port's prefill + decode, teacher-forced with the reference's
    tokens, so every step sees the same inputs."""
    pcfg = ParallelConfig(kernel=kernel)
    prefill = make_prefill_step(cfg, pcfg, cache_cap=S + STEPS)
    decode = make_decode_step(cfg, pcfg)
    logits, cache = prefill(params,
                            {"tokens": torch.from_numpy(_prompt(cfg))})
    out = [logits.float().numpy()]
    for i in range(STEPS):
        logits, cache = decode(params, cache,
                               {"tokens": torch.tensor(toks[i])[:, None]},
                               S + i)
        out.append(logits.float().numpy())
    return out


# -- configs and parameters --------------------------------------------------------

def test_gemma_config_and_parameter_count_match_the_reference():
    cfg, ref_cfg = get_arch("gemma-2b"), jax_get_arch("gemma-2b")
    assert cfg.__dict__ == ref_cfg.__dict__
    assert P.count_params(cfg) == jax_params.count_params(ref_cfg)
    assert smoke_config("gemma-2b").__dict__ == \
        jax_smoke_config("gemma-2b").__dict__
    with pytest.raises(KeyError, match="unknown"):
        get_arch("gpt-5")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_carries_every_leaf(dtype):
    cfg = jax_smoke_config("gemma-2b").replace(dtype=dtype)
    tree = _jax_tree(cfg)
    mine = P.params_from_jax(tree, smoke_config("gemma-2b").replace(
        dtype=dtype))
    flat = dict(P.leaves(mine))
    n_ref = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(tree))
    assert sum(t.numel() for t in flat.values()) == n_ref
    assert len(flat) == 2 + cfg.num_layers * 9   # embed, final norm, layers
    spec = dict(P.leaves(P.model_specs(smoke_config("gemma-2b"))))
    assert set(flat) == set(spec)
    seg = tree["segments"][0]["0:attn"]
    for i in range(cfg.num_layers):
        for path in (("attn", "wq"), ("attn", "wo"), ("mlp", "wd"),
                     ("ln1", "scale")):
            want = seg[path[0]][path[1]][i]
            got = mine["layers"][i][path[0]][path[1]]
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
    np.testing.assert_array_equal(
        mine["embed"]["table"].float().numpy(),
        tree["embed"]["table"].astype(np.float32))
    assert mine["final_norm"]["scale"].dtype == torch.float32
    assert mine["embed"]["table"].dtype == P.DTYPES[dtype]


def test_init_params_distributions_and_seed():
    cfg = smoke_config("gemma-2b")
    a = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (pa, ta), (pb, tb) in zip(P.leaves(a), P.leaves(b)):
        assert pa == pb and torch.equal(ta, tb)
    assert torch.all(a["layers"][0]["ln1"]["scale"] == 1)
    assert a["layers"][0]["ln1"]["scale"].dtype == torch.float32
    table = a["embed"]["table"].float()
    assert table.dtype == torch.float32 and abs(float(table.std()) - 0.02) < 2e-3
    wd = a["layers"][1]["mlp"]["wd"].float()
    assert abs(float(wd.std()) - 0.02 / math.sqrt(4)) < 1e-3


# -- end to end against the reference ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_gemma_smoke_prefill_and_decode_match_jax(dtype, kernels):
    ref_cfg = jax_smoke_config("gemma-2b").replace(dtype=dtype)
    cfg = smoke_config("gemma-2b").replace(dtype=dtype)
    tree = _jax_tree(ref_cfg)
    want, toks = _jax_run(ref_cfg, tree,
                          JaxKernelConfig(**KERNELS) if kernels else None)
    kfa.launches = kfd.split_launches = 0
    got = _torch_run(cfg, P.params_from_jax(tree, cfg),
                     KernelConfig(**KERNELS) if kernels else None, toks)
    assert kfa.launches == kfd.split_launches == 0   # plain versions
    denom = max(float(np.abs(want[0]).max()), 1e-6)
    for step, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        if dtype == "float32":
            assert err <= 1e-4 * denom, (step, err)
            np.testing.assert_array_equal(np.argmax(g, -1), toks[step])
        else:
            assert err <= 5e-3 * denom, (step, err)


def test_decoder_module_and_cache_layout():
    cfg = smoke_config("gemma-2b")
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dec = Decoder(cfg, params)
    toks = torch.from_numpy(_prompt(cfg))
    positions = torch.arange(S)[None].expand(B, S)
    cache = init_cache(cfg, B, S + 4)
    assert cache[0]["k"].shape == (B, S + 4, 1, 16)
    assert torch.all(cache[0]["pos"] == -1)
    with torch.inference_mode():
        x, new = dec(toks, positions, mode="prefill", cache=cache)
        logits = dec.logits(x)
    assert x.shape == (B, S, 64) and logits.shape == (B, S, 256)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert torch.equal(new[1]["pos"][0], torch.tensor(list(range(S))
                                                      + [-1] * 4))


# -- the serve entry point ----------------------------------------------------------

def test_decode_server_on_cpu_matches_its_plain_path():
    cfg = smoke_config("gemma-2b").replace(dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for name, kc in (("plain", None), ("kernels", KernelConfig(**KERNELS))):
        srv = serve.DecodeServer(cfg, ParallelConfig(kernel=kc), batch=B,
                                 prompt_len=16, decode_steps=6, device="cpu",
                                 params=params, keep_logits=6)
        assert srv.prefill_batch(srv.input_batch()) > 0
        assert srv.prefill_batch(srv.input_batch()) > 0     # starts anew
        for _ in range(6):
            srv.decode_step()
        runs[name] = srv
    plain, kern = runs["plain"], runs["kernels"]
    assert plain.prefill_dispatch == "plain direct attention"
    assert kern.prefill_dispatch == "flash-attention kernel plain version (cpu)"
    assert "combine fused in" in kern.decode_dispatch
    assert len(kern.kept) == 7 and kern.pos == 22
    for a, b in zip(plain.kept, kern.kept):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert [t.tolist() for t in plain.out] == [t.tolist() for t in kern.out]


def test_serve_main_smoke_on_cpu(tmp_path, capsys):
    out = serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "128",
                      "--decode-steps", "4", "--kernels", "--store",
                      str(tmp_path / "empty")])
    text = capsys.readouterr().out
    assert "no usable flash (prefill) kernel record" in text
    assert "flash-attention kernel plain version (cpu)" in text
    assert len(out["step_s"]) == 4 and out["server"].pos == 132
    assert out["launches"] == {"flash_attention": 0, "flash_decode_split": 0,
                               "flash_decode_combine": 0,
                               "flash_decode_ring": 0}
    plain = serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "128",
                        "--decode-steps", "4"])
    assert "plain decode attention" in capsys.readouterr().out
    assert ([t.tolist() for t in plain["server"].out]
            == [t.tolist() for t in out["server"].out])


def test_kernel_gates_raise_on_the_card_and_fall_back_on_the_cpu():
    """An opted-in gate that the shape closes: the CPU runs the plain path,
    as the reference does; the card raises. Only the device's type is
    read, so no card is needed."""
    kc = KernelConfig(**KERNELS)                      # blocks of 8
    assert L._flash_kernel_ok(16, 16, 16, None, kc, "cuda")
    assert not L._flash_kernel_ok(16, 16, 16, None, None, "cuda")
    assert not L._flash_kernel_ok(12, 16, 16, None, kc, "cpu")
    with pytest.raises(ValueError, match="do not tile a prefill of 12"):
        L._flash_kernel_ok(12, 16, 16, None, kc, "cuda")
    # a window or unequal head dims is not a kernel shape, on either
    # device: the reference's plain attention runs (its gate's rule)
    assert not L._flash_kernel_ok(16, 16, 16, 8, kc, "cuda")
    assert not L._flash_kernel_ok(16, 24, 16, None, kc, "cuda")
    assert L._decode_kernel_ok(16, 16, kc, "cuda")
    assert not L._decode_kernel_ok(16, 8, kc, "cpu")
    with pytest.raises(ValueError, match="equal k and v head dims"):
        L._decode_kernel_ok(16, 8, kc, "cuda")


def test_serving_config_on_the_card_fits_blocks_or_raises():
    """On the card the server's dispatch never leaves a kernel off: flash
    blocks shrink to the largest multiple of 64 that tiles the prompt, and
    a shape no blocks serve raises. Without a store only the device's type
    is read."""
    cuda, cfg = torch.device("cuda"), get_arch("gemma-2b")
    quiet = dict(cache_cap=1088, batch=4, log=lambda *a: None)
    kc = serve.serving_kernel_config(cfg, device=cuda, prompt_len=1024,
                                     **quiet)
    assert kc == KernelConfig(use_flash=True, use_decode=True)
    assert kc.decode_combine == "kernel"
    kc = serve.serving_kernel_config(cfg, device=cuda, prompt_len=192,
                                     **quiet)
    assert (kc.flash_block_q, kc.flash_block_kv) == (64, 64)
    assert kc.use_flash and kc.use_decode
    with pytest.raises(ValueError, match="not a multiple of 64"):
        serve.serving_kernel_config(cfg, device=cuda, prompt_len=32, **quiet)
    with pytest.raises(ValueError, match="hd=16"):
        serve.serving_kernel_config(smoke_config("gemma-2b"), device=cuda,
                                    prompt_len=128, **quiet)
    # the CPU's plain versions take any blocks
    kc = serve.serving_kernel_config(cfg, device=torch.device("cpu"),
                                     prompt_len=32, **quiet)
    assert (kc.flash_block_q, kc.flash_block_kv) == (128, 128)


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma-2b", "--smoke"])


@pytest.mark.parametrize("S,cap,window", [(6, 10, None), (12, 8, None),
                                          (12, 8, 8), (5, 8, 8)])
def test_prefill_cache_layout_matches_jax(S, cap, window):
    """Padding to capacity, keeping the last ``cap`` tokens, and the rolling
    window's slot = position mod capacity layout."""
    from repro.models.layers import _prefill_cache as jax_prefill_cache
    from repro_torch.models.layers import _prefill_cache
    rng = np.random.default_rng(S + cap)
    k = rng.normal(size=(2, S, 1, 4)).astype(np.float32)
    v = rng.normal(size=(2, S, 1, 4)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S) + 3, (2, S)).copy()
    want = jax_prefill_cache(None, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), cap, window)
    got = _prefill_cache(torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(pos), cap, window)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
