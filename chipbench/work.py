"""The yardstick's arithmetic: the H100's published peaks, and the work a
served step needs, counted from shapes alone.

Nothing here reads a block size, a split count or anything the program
chose: a later change that replaces a kernel leaves these counts as they
are. Operations are multiply-adds counted as two; bytes count each input
read once and each output written once, in the model's dtype (bf16, two
bytes), whatever a kernel reads again.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


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


def product_bound_s(rows: int, k: int, n: int) -> float:
    """Least time of a (rows, k) x (k, n) bf16 product: its operations at
    the bf16 peak or its bytes (both operands and the result once) at the
    HBM rate, whichever is longer."""
    flops = 2 * rows * k * n
    nbytes = BF16_BYTES * (rows * k + k * n + rows * n)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def forward_products(m: Dims, rows: int, head_rows: int
                     ) -> Iterator[Tuple[int, int, int]]:
    """(rows, K, N) of every product of one forward pass over ``rows``
    tokens whose last ``head_rows`` go through the head."""
    for _ in range(m.layers):
        for _, k, n in layer_products(m):
            yield rows, k, n
    yield head_rows, m.d, m.vocab


@dataclass(frozen=True)
class Batch:
    """One closed-loop batch: ``batch`` prompts of ``prompt`` tokens, each
    answered with ``output`` tokens (the prefill gives the first, each of
    ``output - 1`` decode steps one more)."""

    batch: int
    prompt: int
    output: int

    def decode_contexts(self) -> range:
        """The valid cache slots a row attends over at each decode step:
        the prompt and the tokens fed so far, the step's own included."""
        return range(self.prompt + 1, self.prompt + self.output)


def products_bound_s(m: Dims, b: Batch) -> float:
    """Least time of every weight product of one batch: its prefill (the
    head on each row's last position) and its decode steps."""
    pre = sum(product_bound_s(*p) for p in
              forward_products(m, b.batch * b.prompt, b.batch))
    step = sum(product_bound_s(*p) for p in
               forward_products(m, b.batch, b.batch))
    return pre + (b.output - 1) * step


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal prefill of ``s`` positions scores."""
    return s * (s + 1) // 2


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
