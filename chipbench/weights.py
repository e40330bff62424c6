"""Inputs made from ``--seed``: the weights, the prompts and the sample the
comparison draws.

The weights are made on the device in a few large calls: every weight of
one distribution is a view into one flat buffer filled by ``normal_`` in
chunks of a gigaelement, in the dtype they are served in
(:func:`tree_of`). Which weights there are, their shapes and their
distributions are the family's (``families/<family>.py``
``make_weights``), laid out as the port's model takes them; the reference
reads the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CHUNK = 1 << 30

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def seeds(seed: int) -> Dict[str, int]:
    """Independent streams of one ``--seed``, any whole number: weights,
    prompts and the comparison's sample."""
    kids = np.random.SeedSequence(int(seed)).spawn(3)
    return {name: int(k.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for name, k in zip(("weights", "prompts", "sample"), kids)}


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


def tree_of(groups: Sequence[Tuple[Sequence, Optional[float], torch.dtype]],
            seed: int, device) -> Dict:
    """A weight tree from the seed's own stream. ``groups`` holds
    (leaves, std, dtype), each leaf a (path, shape): a group's weights are
    views into one flat buffer of ``dtype``, filled by ``normal_`` at
    ``std`` in chunks of a gigaelement, or with ones where ``std`` is None.
    The groups are filled in order, so a family that keeps its groups'
    order keeps its weights."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seeds(seed)["weights"])
    tree: Dict = {}
    for leaves, std, dtype in groups:
        n = sum(math.prod(s) for _, s in leaves)
        buf = (torch.ones(n, dtype=dtype, device=device) if std is None
               else _normal(n, std, dtype, gen, device))
        for path, view in _views(buf, leaves):
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
