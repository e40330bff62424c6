"""The dense decoder family: GQA (or MHA) attention and a SwiGLU MLP in
every layer, the port's ``family="dense"`` models. A configuration file
without a ``"family"`` key is of this family.

The interface is ``families/__init__.py``'s. The work counts take
operations as multiply-adds counted as two, and bytes as each input read
once and each output written once in bf16, whatever a kernel reads again;
nothing here reads a block size, a split count or anything the program
chose.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import torch

from chipbench.reference.decoder import Decoder
from chipbench.weights import tree_of
from chipbench.work import (BF16_BYTES, PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S,
                            Batch, causal_pairs, product_bound_s)


@dataclass(frozen=True)
class Dims:
    """A dense decoder's sizes, as its configuration file gives them."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    @classmethod
    def of(cls, c: Dict) -> "Dims":
        return cls(c["num_hidden_layers"], c["hidden_size"],
                   c["num_attention_heads"], c["num_key_value_heads"],
                   c["head_dim"], c["intermediate_size"], c["vocab_size"])


def sizes(c: Dict) -> Dims:
    return Dims.of(c)


def arch_config(c: Dict):
    """The port's ``ArchConfig`` of a configuration file: its registry entry
    at the file's depth, checked field by field against the file, so that
    a change of the port's registry stops the benchmark instead of
    measuring another model."""
    from chipbench.program import get_arch
    cfg = get_arch(c["registry_name"]).replace(
        num_layers=c["num_hidden_layers"])
    if c.get("smoke"):          # a test's cut of the widths, never a cell's
        cfg = cfg.replace(**c["smoke"])
    want = {"num_layers": c["num_hidden_layers"], "d_model": c["hidden_size"],
            "num_heads": c["num_attention_heads"],
            "num_kv_heads": c["num_key_value_heads"],
            "resolved_head_dim": c["head_dim"],
            "d_ff": c["intermediate_size"], "vocab_size": c["vocab_size"],
            "rope_theta": c["rope_theta"], "norm_eps": c["norm_eps"],
            "tie_embeddings": c["tie_word_embeddings"],
            "dtype": c["torch_dtype"], "family": "dense",
            "attention": "gqa", "mlp_act": "swiglu",
            "block_pattern": ("attn",), "local_window": None, "moe": None,
            "qk_norm": False, "scale_embeddings": False, "frontend": None,
            "cross_attention": False}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise ValueError(f"the port's {c['registry_name']} is not the "
                         f"configuration file's: (port, file) {bad}")
    return cfg


def _leaves(m: Dims) -> Tuple[List, List, List]:
    """(path, shape) of each weight, in three groups: normal at 0.02, the
    output projections, and the norm scales."""
    wide, out, norms = [(("embed", "table"), (m.vocab, m.d))], [], []
    for i in range(m.layers):
        a = ("layers", i, "attn")
        wide += [(a + ("wq",), (m.d, m.heads, m.head_dim)),
                 (a + ("wk",), (m.d, m.kv_heads, m.head_dim)),
                 (a + ("wv",), (m.d, m.kv_heads, m.head_dim)),
                 (("layers", i, "mlp", "wg"), (m.d, m.d_ff)),
                 (("layers", i, "mlp", "wu"), (m.d, m.d_ff))]
        out += [(a + ("wo",), (m.heads, m.head_dim, m.d)),
                (("layers", i, "mlp", "wd"), (m.d_ff, m.d))]
        norms += [(("layers", i, "ln1", "scale"), (m.d,)),
                  (("layers", i, "ln2", "scale"), (m.d,))]
    wide.append((("lm_head", "w"), (m.d, m.vocab)))
    norms.append((("final_norm", "scale"), (m.d,)))
    return wide, out, norms


def make_weights(m: Dims, dtype, seed: int, device) -> Dict:
    """The weights of seed ``seed`` as the port's tree: ``embed.table``
    (V, d), ``layers[i]`` with ``ln1``/``ln2`` scales, ``attn`` wq, wk, wv
    (d, heads, hd) and wo (H, hd, d), ``mlp`` wg, wu (d, d_ff) and wd
    (d_ff, d); ``final_norm.scale``; ``lm_head.w`` (d, V). The port's
    distributions (``repro_torch.models.params.init_params``): normal x
    0.02, the two output projections of a layer at 0.02 / sqrt(2L), norm
    scales ones in fp32."""
    wide, out, norms = _leaves(m)
    return tree_of([(wide, 0.02, dtype),
                    (out, 0.02 / math.sqrt(2 * m.layers), dtype),
                    (norms, None, torch.float32)], seed, device)


def reference(c: Dict, weights: Dict, fp8: bool = False) -> Decoder:
    return Decoder(c, weights, fp8=fp8)


def layer_products(m: Dims) -> Tuple[Tuple[str, int, int], ...]:
    """One layer's weight products as (name, K, N): rows of K in, N out."""
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    return (("wq", m.d, q), ("wk", m.d, kv), ("wv", m.d, kv),
            ("wo", q, m.d), ("wg", m.d, m.d_ff), ("wu", m.d, m.d_ff),
            ("wd", m.d_ff, m.d))


def layer_params(m: Dims) -> int:
    """Weights of one layer's products (the two norm scales left out)."""
    return sum(k * n for _, k, n in layer_products(m))


def param_count(m: Dims) -> int:
    """Every weight: embedding, layers with their norm scales, final norm,
    and the untied head."""
    return (m.vocab * m.d + m.layers * (layer_params(m) + 2 * m.d) + m.d
            + m.d * m.vocab)


def kv_bytes_per_token(m: Dims) -> int:
    """K and V of one position over every layer."""
    return m.layers * 2 * m.kv_heads * m.head_dim * BF16_BYTES


def forward_products(m: Dims, rows: int, head_rows: int
                     ) -> Iterator[Tuple[int, int, int]]:
    """(rows, K, N) of every product of one forward pass over ``rows``
    tokens whose last ``head_rows`` go through the head."""
    for _ in range(m.layers):
        for _, k, n in layer_products(m):
            yield rows, k, n
    yield head_rows, m.d, m.vocab


def products_bound_s(m: Dims, b: Batch) -> float:
    """Least time of every weight product of one batch: its prefill (the
    head on each row's last position) and its decode steps."""
    pre = sum(product_bound_s(*p) for p in
              forward_products(m, b.batch * b.prompt, b.batch))
    step = sum(product_bound_s(*p) for p in
               forward_products(m, b.batch, b.batch))
    return pre + (b.output - 1) * step


def flash_attention_work(m: Dims, b: Batch) -> Tuple[float, float]:
    """(operations, bytes) of one layer's causal prefill attention: QK^T
    and PV over the causal pairs of every head; q, k, v read and the
    output written once."""
    flops = 4 * b.batch * m.heads * m.head_dim * causal_pairs(b.prompt)
    nbytes = (BF16_BYTES * b.batch * b.prompt * m.head_dim
              * (2 * m.heads + 2 * m.kv_heads))
    return flops, nbytes


def flash_attention_bound_s(m: Dims, b: Batch) -> float:
    """Least time of every layer's prefill attention of one batch."""
    flops, nbytes = flash_attention_work(m, b)
    return m.layers * max(flops / PEAK_BF16_FLOPS,
                          nbytes / PEAK_HBM_BYTES_PER_S)


def decode_attention_bytes(m: Dims, batch: int, context: int) -> int:
    """Bytes one layer's decode attention needs at one step: K and V of
    the ``context`` valid slots of each row, the query and the output."""
    kv = 2 * batch * context * m.kv_heads * m.head_dim
    qo = 2 * batch * m.heads * m.head_dim
    return BF16_BYTES * (kv + qo)


def decode_attention_bound_s(m: Dims, b: Batch) -> float:
    """Least time of every layer's decode attention over one batch's
    decode steps, by bytes at the HBM rate."""
    nbytes = sum(decode_attention_bytes(m, b.batch, c)
                 for c in b.decode_contexts())
    return m.layers * nbytes / PEAK_HBM_BYTES_PER_S


def model_flops(m: Dims, b: Batch) -> float:
    """The model's operations in one batch: two a weight of each product
    per token (the head on the prefill's last position and on every
    decode token), and 4 x context x H x hd per attention layer and token
    (the causal pairs in the prefill)."""
    per_tok = 2 * layer_params(m) * m.layers
    head = 2 * m.d * m.vocab
    attn = 4 * m.heads * m.head_dim * m.layers
    pre = (b.batch * (b.prompt * per_tok + head)
           + b.batch * attn * causal_pairs(b.prompt))
    dec = sum(b.batch * (per_tok + head + attn * c)
              for c in b.decode_contexts())
    return pre + dec
