"""Sequence-sharded activations and caches on a device mesh: the
reference's ``act_seq`` and ``act_cache_seq`` rules of ``act_rules``.

On 4 gloo ranks over (data 2, model 2) against the reference's own
sharded runs on 4 forced host devices under the same rules
(``torch_mesh_parity.run_both``, one reference subprocess):

  * two AdamW steps of every family under ``act_seq=model`` (each rank
    holds a block of the sequence; attention gathers K and V whole);
  * a prefill and 3 decode steps under ``act_cache_seq=model`` and under
    both rules, for gemma-2b (a prompt of 8 in a cache of 36: the model
    rank holding slots 18..35 has no valid slot), recurrentgemma-9b (its
    rolling cache of 16 slots, the decode slots 14, 15 and 0 crossing the
    rank boundary) and deepseek-v3-671b (the latent cache), and gemma-2b
    under both rules with the kernels opted in (the flash kernel over Q
    gathered whole, each rank keeping its rows; the decode kernel's
    partials over each rank's slots, merged across ranks).

Beside them: the decode kernel's gate on a one-rank mesh, and the
partials of a block of the cache with no valid slot.
"""
import math

import pytest

import torch

import torch_mesh_parity as MP
import torch_mesh_ranks as R

SEQ = {"act_seq": "model"}
CACHE = {"act_cache_seq": "model"}
BOTH = {**SEQ, **CACHE}
#: decode through the kernel gate: splits of 8 slots, two a rank's block
KERNEL = {"kernel": {"use_decode": True, "decode_block_kv": 8,
                     "decode_num_splits": 2}}
#: and prefill through the flash kernel's, blocks that tile a prompt of 8
FLASH = {"kernel": {**KERNEL["kernel"], "use_flash": True,
                    "flash_block_q": 8, "flash_block_kv": 8}}

TRAIN = [(name, SEQ) for name in (
    "gemma-2b", "qwen3-moe-30b-a3b", "deepseek-v3-671b", "recurrentgemma-9b",
    "xlstm-1.3b", "musicgen-large")]
#: (name, overrides, prompt, cache positions, tokens)
SERVE = [(name, rules, prompt, 36, prompt + 3)
         for name, prompt in (("gemma-2b", 8), ("recurrentgemma-9b", 30),
                              ("deepseek-v3-671b", 30))
         for rules in (CACHE, BOTH)] + [("gemma-2b", {**BOTH, **FLASH},
                                         8, 36, 11)]
TRAIN_TAGS = [R.tag(*run) for run in TRAIN]
SERVE_TAGS = [R.tag(*run[:2]) for run in SERVE]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return MP.run_both(tmp_path_factory.mktemp("seq"), 2, 2, TRAIN,
                       spread=[R.tag("xlstm-1.3b", SEQ)], serve=SERVE)


@pytest.mark.parametrize("tag", TRAIN_TAGS)
def test_sequence_split_losses_match_the_references(runs, tag):
    """Both steps' losses within LOSS_RTOL of the reference's on its
    4-device mesh under ``act_seq=model`` (S 32: 16 positions a model
    rank)."""
    MP.assert_losses_match(runs[tag], 4)


@pytest.mark.parametrize("tag", TRAIN_TAGS)
def test_sequence_split_updates_match_the_references(runs, tag):
    """Each weight's update over the two steps within 1e-3 of the norm of
    the reference's; xlstm's sLSTM input-gate bias, whose gradient sits at
    the rounding level, within twice the reference's own spread between
    its sharded and unsharded steps (``test_torch_mesh_recurrent.py``)."""
    MP.assert_updates_match(runs[tag])


@pytest.mark.parametrize("tag", SERVE_TAGS)
def test_cache_split_logits_match_the_references(runs, tag):
    """The prefill's and each decode step's logits within 1e-5 x
    max|logits| of the reference's under the same rules; with the kernels
    opted in, the prefill reaches the flash kernel once a layer and every
    decode step the decode kernel in partials mode over a rank's block
    (the fused launch needs the whole cache)."""
    got = runs["serve"][tag]
    MP.assert_logits_match(got)
    if "kernel" in tag:
        layers = 2                      # the smoke gemma's two layers
        assert got["calls"] == {"fused": 0, "partials": 3 * layers,
                                "flash": layers}
    else:
        assert got["calls"] == {"fused": 0, "partials": 0, "flash": 0}


def test_the_decode_kernel_gate_on_a_one_rank_mesh(tmp_path):
    """gemma-2b's smoke config in fp32 with ``KernelConfig(use_decode=
    True)`` on a one-rank gloo mesh: each decode step of each layer calls
    the decode kernel's wrapper (the fused call: the one rank holds the
    whole cache), as off the mesh, and the logits equal the off-mesh
    ones."""
    import numpy as np
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import params as P
    cfg = smoke_config("gemma-2b").replace(dtype="float32")
    torch.save(P.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
               tmp_path / "params.pt")
    np.savez(tmp_path / "batch.npz", tokens=R.tokens(cfg.vocab_size, 2, 20))
    run = [("gemma-2b", KERNEL, str(tmp_path / "params.pt"),
            str(tmp_path / "batch.npz"), 16, 32)]
    R.spawn(R.kernel_gate_job, 1, tmp_path, run, str(tmp_path / "out"))
    mesh = torch.load(tmp_path / "out.mesh")[R.tag(*run[0][:2])]
    off = torch.load(tmp_path / "out.off")[R.tag(*run[0][:2])]
    assert mesh["calls"] == off["calls"] == {"fused": 4 * cfg.num_layers,
                                             "partials": 0, "flash": 0}
    for a, b in zip(mesh["logits"], off["logits"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_a_block_with_no_valid_slot_weighs_zero(kernel):
    """The partials of a block of the cache whose every slot is empty are
    exact zeros (o 0, l 0, m -inf), with the plain path and through the
    kernel's wrapper (its plain version here), and merged with a block
    that holds valid slots they leave that block's output bit for bit: no
    NaN, weight exactly 0."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import KernelConfig
    kc = KernelConfig(use_decode=True, decode_block_kv=8,
                      decode_num_splits=2) if kernel else None
    g = torch.Generator().manual_seed(0)
    B, H, KV, hd, n = 2, 4, 1, 16, 16
    q = torch.randn(B, 1, H, hd, generator=g)
    k, v = (torch.randn(B, n, KV, hd, generator=g) for _ in range(2))
    cur = torch.tensor([20, 21])
    empty = torch.full((B, n), -1)
    full = torch.arange(n)[None].expand(B, n) + 4
    o, m, l = L._decode_partials(q, k, v, empty, cur, window=None, kc=kc)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(l, torch.zeros_like(l))
    assert bool((m == -math.inf).all())
    parts = L._decode_partials(q, k, v, full, cur, window=None, kc=kc)
    alone = ref.combine_partials(*parts)
    merged = ref.combine_partials(*(torch.cat([a, b], dim=2)
                                    for a, b in zip(parts, (o, m, l))))
    assert torch.isfinite(merged).all()
    assert torch.equal(merged, alone)
    want = L._decode_attention(q, k, v, cache_pos=full, cur_pos=cur,
                               window=None, scale=hd ** -0.5)
    torch.testing.assert_close(alone.reshape(B, 1, H, hd), want, rtol=1e-5,
                               atol=1e-6)
