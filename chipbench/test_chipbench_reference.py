"""The plain reference against the port's served logits at a smoke size on
the CPU: a prefill, then decode steps through the cache, on the weights
and prompts the benchmark makes (the port's kernels run their plain
versions here)."""
import json
from pathlib import Path

import pytest
import torch

from chipbench.families import dense
from chipbench.reference.decoder import Decoder, fp8_round
from chipbench.weights import Prompts

HERE = Path(__file__).resolve().parent


def smoke(dtype: str, **kw):
    with open(HERE / "testdata" / "smoke.json", encoding="utf-8") as f:
        c = json.load(f)
    c["torch_dtype"] = dtype
    c.update(kw)
    c["smoke"] = {**c["smoke"], "dtype": dtype}
    return c


def served(c, seed, batch=3, prompt=64, output=6):
    """The port's served tokens and the logits that chose them (B, n, V)."""
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import ParallelConfig
    m = dense.sizes(c)
    w = dense.make_weights(m, getattr(torch, c["torch_dtype"]), seed, "cpu")
    cfg = dense.arch_config(c)
    kc = serve.serving_kernel_config(cfg, device=torch.device("cpu"),
                                     prompt_len=prompt,
                                     cache_cap=prompt + output, batch=batch)
    srv = serve.DecodeServer(cfg, ParallelConfig().replace(kernel=kc),
                             batch=batch, prompt_len=prompt,
                             decode_steps=output, device="cpu", params=w,
                             keep_logits=output)
    toks = Prompts(seed, m.vocab, batch, prompt, "cpu").next()
    srv.prefill_batch({"tokens": toks})
    for _ in range(output - 1):
        srv.decode_step()
    return w, toks, torch.stack(srv.out, 1), torch.stack(srv.kept, 1)


@pytest.mark.parametrize("kv_heads", [2, 4])
def test_reference_holds_the_ports_fp32_logits(kv_heads):
    c = smoke("float32", num_key_value_heads=kv_heads,
              smoke={**smoke("float32")["smoke"], "num_kv_heads": kv_heads})
    w, prompts, tokens, logits = served(c, seed=11)
    ref = Decoder(c, w).served_logits(prompts, tokens)
    assert ref.shape == logits.shape
    scale = float(ref.abs().max())
    # fp32 on both sides: only the order of sums differs
    assert float((ref - logits).abs().max()) <= 1e-4 * scale
    assert torch.equal(ref.argmax(-1), tokens)


def test_reference_holds_the_ports_bf16_logits():
    c = smoke("bfloat16")
    w, prompts, tokens, logits = served(c, seed=12)
    ref = Decoder(c, w).served_logits(prompts, tokens)
    scale = float(ref.abs().max())
    # the port rounds every product and the residual to bf16 (2^-8
    # relative); over two layers it stays within a few of those
    assert float((ref - logits).abs().max()) <= 2e-2 * scale


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.0625, 1.125, 448.0]])
    got = fp8_round(t, 1)
    assert torch.equal(got, torch.tensor([[1.0, 1.0, 1.125, 448.0]]))
