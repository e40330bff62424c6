"""The yardstick's work counts (the dense family's) against numbers worked
by hand, and the seeded weights against the port's layout."""
import json
from pathlib import Path

import pytest
import torch

from chipbench import work
from chipbench.families import dense
from chipbench.weights import Prompts, seeds

HERE = Path(__file__).resolve().parent


def dims(name: str) -> dense.Dims:
    with open(HERE / "configs" / f"{name}.json", encoding="utf-8") as f:
        return dense.Dims.of(json.load(f))


def test_stablelm_3b_counts():
    m = dims("stablelm-3b")
    assert dense.kv_bytes_per_token(m) == 327_680
    # embedding and head 50,304 x 2,560 each; a layer 4 x 2,560^2 of
    # attention, 3 x 2,560 x 6,912 of MLP and two norms; the final norm
    assert dense.param_count(m) == (2 * 128_778_240
                                   + 32 * (26_214_400 + 53_084_160 + 5_120)
                                   + 2_560) == 2_795_276_800


def test_mistral_stage_counts():
    m = dims("mistral-large-123b-pp8")
    assert dense.kv_bytes_per_token(m) == 45_056
    # 11 layers of q, o (12,288^2), k, v (12,288 x 1,024) and the MLP
    # (3 x 12,288 x 28,672), embedding and head 32,768 x 12,288
    layer = 2 * 150_994_944 + 2 * 12_582_912 + 1_056_964_608 + 24_576
    assert dense.param_count(m) == 11 * layer + 2 * 402_653_184 + 12_288
    assert round(dense.param_count(m) / 1e9, 2) == 16.03


def test_product_bound_takes_the_longer_of_operations_and_bytes():
    # one row through a 12,288^2 weight: bytes bound (the weight read once)
    k = n = 12_288
    nbytes = 2 * (k + k * n + n)
    assert work.product_bound_s(1, k, n) == nbytes / 3.35e12
    # 8,192 rows: operations bound
    assert work.product_bound_s(8192, k, n) == 2 * 8192 * k * n / 989e12


def test_attention_work_by_hand():
    m = dense.Dims(layers=1, d=8, heads=2, kv_heads=1, head_dim=4, d_ff=8,
                   vocab=16)
    # a prompt of 3: 6 causal pairs, 4 operations a pair a dim and head
    flops, nbytes = dense.flash_attention_work(m, work.Batch(1, 3, 2))
    assert flops == 4 * 1 * 2 * 4 * 6
    assert nbytes == 2 * 1 * 3 * 4 * (2 * 2 + 2 * 1)
    # decode over 5 valid slots: K and V of 5 slots, q and out of 2 heads
    assert dense.decode_attention_bytes(m, 1, 5) == 2 * (2 * 5 * 4 + 2 * 8)
    # a batch of 3 + 2 out has one decode step, over 4 slots
    assert list(work.Batch(1, 3, 2).decode_contexts()) == [4]
    assert dense.decode_attention_bound_s(m, work.Batch(1, 3, 2)) == (
        dense.decode_attention_bytes(m, 1, 4) / 3.35e12)


def test_model_flops_counts_every_token_once():
    m = dense.Dims(layers=2, d=8, heads=2, kv_heads=1, head_dim=4, d_ff=8,
                   vocab=16)
    b = work.Batch(batch=3, prompt=5, output=4)
    per_tok = 2 * 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 8)
    head = 2 * 8 * 16
    attn = 4 * 2 * 4 * 2
    want = 3 * (5 * per_tok + head + attn * 15)
    want += sum(3 * (per_tok + head + attn * c) for c in (6, 7, 8))
    assert dense.model_flops(m, b) == want


def test_weights_take_the_ports_layout():
    from repro_torch.models.params import leaves, model_specs
    with open(HERE / "testdata" / "smoke.json", encoding="utf-8") as f:
        c = json.load(f)
    m = dense.Dims.of(c)
    w = dense.make_weights(m, torch.bfloat16, 7, "cpu")
    specs = dict(leaves(model_specs(dense.arch_config(c))))
    got = dict(leaves(w))
    assert sorted(got) == sorted(specs)
    for path, spec in specs.items():
        want = torch.float32 if spec.dtype == "float32" else torch.bfloat16
        assert tuple(got[path].shape) == spec.shape, path
        assert got[path].dtype == want, path
    wo = w["layers"][0]["attn"]["wo"].float()
    assert abs(float(wo.std()) / (0.02 / 2) - 1) < 0.1


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 3 * 2**40])
def test_a_seed_gives_the_same_inputs(seed):
    m = dense.Dims(layers=1, d=8, heads=2, kv_heads=1, head_dim=4, d_ff=8,
                   vocab=16)
    a = dense.make_weights(m, torch.bfloat16, seed, "cpu")
    b = dense.make_weights(m, torch.bfloat16, seed, "cpu")
    assert torch.equal(a["lm_head"]["w"], b["lm_head"]["w"])
    p, q = (Prompts(seed, 16, 2, 4, "cpu") for _ in range(2))
    assert torch.equal(p.next(), q.next())
    assert len(set(seeds(seed).values())) == 3
