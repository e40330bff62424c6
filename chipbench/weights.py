"""Inputs made from ``--seed``: the weights, the prompts and the sample the
comparison draws.

The weights are made on the device in a few large calls: every weight of
one distribution is a view into one flat buffer filled by ``normal_`` in
chunks of a gigaelement, in the dtype they are served in. The
distributions are the port's (``repro_torch.models.params.init_params``):
normal x 0.02, the two output projections of a layer at 0.02 / sqrt(2L),
norm scales ones in fp32. The tree is laid out as the port's model takes
it; the reference reads the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from chipbench.work import Dims

CHUNK = 1 << 30

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def seeds(seed: int) -> Dict[str, int]:
    """Independent streams of one ``--seed``, any whole number: weights,
    prompts and the comparison's sample."""
    kids = np.random.SeedSequence(int(seed)).spawn(3)
    return {name: int(k.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for name, k in zip(("weights", "prompts", "sample"), kids)}


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


def _put(tree: Dict, path: Tuple, value: torch.Tensor) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _views(buf: torch.Tensor, leaves) -> List[Tuple[Tuple, torch.Tensor]]:
    out, at = [], 0
    for path, shape in leaves:
        n = math.prod(shape)
        out.append((path, buf[at:at + n].view(shape)))
        at += n
    return out


def _normal(n: int, std: float, dtype, gen: torch.Generator, device):
    buf = torch.empty(n, dtype=dtype, device=device)
    for lo in range(0, n, CHUNK):
        buf[lo:lo + CHUNK].normal_(0.0, std, generator=gen)
    return buf


def make_weights(m: Dims, dtype: torch.dtype, seed: int, device
                 ) -> Dict:
    """The weights of seed ``seed`` as the port's tree: ``embed.table``
    (V, d), ``layers[i]`` with ``ln1``/``ln2`` scales, ``attn`` wq, wk, wv
    (d, heads, hd) and wo (H, hd, d), ``mlp`` wg, wu (d, d_ff) and wd
    (d_ff, d); ``final_norm.scale``; ``lm_head.w`` (d, V)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seeds(seed)["weights"])
    wide, out, norms = _leaves(m)
    tree: Dict = {}
    groups = ((wide, 0.02, dtype), (out, 0.02 / math.sqrt(2 * m.layers),
                                    dtype))
    for leaves, std, dt in groups:
        buf = _normal(sum(math.prod(s) for _, s in leaves), std, dt, gen,
                      device)
        for path, view in _views(buf, leaves):
            _put(tree, path, view)
    ones = torch.ones(len(norms) * m.d, dtype=torch.float32, device=device)
    for path, view in _views(ones, norms):
        _put(tree, path, view)
    return tree


class Prompts:
    """The prompts of one run: batch after batch of token ids drawn
    uniformly from the vocabulary on the device, from the seed's own
    stream, so that a seed gives the same prompts in the same order."""

    def __init__(self, seed: int, vocab: int, batch: int, prompt: int,
                 device):
        self.vocab, self.shape = vocab, (batch, prompt)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            seeds(seed)["prompts"])

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)
