"""Gradient compression for the pod (DCN) axis.

Port of ``repro/parallel/compression.py``: ``int8_allreduce``,
``topk_error_feedback`` and ``compress_tree_psum``. Where the reference
reduces over a named ``shard_map`` axis, these reduce over a
``Reduction``: a ``torch.distributed`` process group (``Reduction.group``;
on a device mesh the ``pod`` dim's, ``Reduction.group(mesh.get_group(
"pod"))``) or a pair of callables, the sum and the max
over the ranks, with the caller's rank and world size. Randomness comes
from an explicit ``torch.Generator`` seeded by (seed, rank): the
reference decorrelates the ranks' dither with ``fold_in(key,
axis_index)``. The reference calls these from no training path (only a
multi-device test runs them), and neither does the port.

Two schemes, both on the gradient after the intra-pod reduction:

  * int8 stochastic-rounding quantized all-reduce (8x fewer bytes on the
    wire, unbiased);
  * top-k sparsification with error feedback (the residual carried to the
    next step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.params import leaves, map_tree, map_tree_paths


@dataclass(frozen=True)
class Reduction:
    """The ranks a compressed reduction runs over: ``sum`` and ``max`` map
    a tensor to its elementwise sum and max over the ranks (a new tensor),
    ``rank`` and ``world`` place the caller among them."""

    sum: Callable[[torch.Tensor], torch.Tensor]
    max: Callable[[torch.Tensor], torch.Tensor]
    rank: int = 0
    world: int = 1

    @classmethod
    def local(cls) -> "Reduction":
        """One rank: both reductions are the identity."""
        return cls(sum=lambda t: t.clone(), max=lambda t: t.clone())

    @classmethod
    def group(cls, group=None) -> "Reduction":
        """Over a ``torch.distributed`` process group (the default group
        when None), with ``all_reduce``."""
        import torch.distributed as dist

        def reduce(op):
            def run(t):
                out = t.clone()
                dist.all_reduce(out, op=op, group=group)
                return out
            return run

        return cls(sum=reduce(dist.ReduceOp.SUM),
                   max=reduce(dist.ReduceOp.MAX),
                   rank=dist.get_rank(group), world=dist.get_world_size(group))


def rank_generator(seed: int, red: Reduction, device) -> torch.Generator:
    """A generator on ``device`` seeded by (seed, rank): the ranks' streams
    differ, as the reference's ``fold_in(key, axis_index)`` makes them."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + red.rank) % (2 ** 63))
    return g


def int8_allreduce(g: torch.Tensor, red: Reduction,
                   generator: torch.Generator) -> torch.Tensor:
    """Unbiased int8-quantized mean over the ranks.

    The scale must be SHARED across ranks (sum_i q_i s_i != (sum_i q_i) s
    for per-rank scales), so one scalar max precedes the int8 payload
    exchange. ``generator`` draws the dither (one per rank)."""
    gmax = red.max(torch.max(torch.abs(g)).float())
    scale = gmax / 127.0 + 1e-12
    noise = torch.rand(g.shape, generator=generator, device=g.device,
                       dtype=torch.float32) - 0.5
    q = torch.clamp(torch.round(g.float() / scale + noise), -127,
                    127).to(torch.int8)
    total = red.sum(q.to(torch.int32))
    return total.float() * scale / red.world


def topk_error_feedback(g: torch.Tensor, residual: torch.Tensor,
                        red: Reduction, k_frac: float = 0.05
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse all-reduce with error feedback: (the mean over the ranks of
    the sparsified gradient, the new residual). The dense sum of the
    sparsified tensor stands in for the index-union exchange; the bytes
    that need to move are k_frac of dense. Ties at the threshold are all
    kept, as the reference keeps them."""
    acc = g + residual
    flat = torch.abs(acc.reshape(-1))
    k = max(int(k_frac * flat.numel()), 1)
    thresh = torch.topk(flat, k).values[-1]
    mask = (torch.abs(acc) >= thresh).to(acc.dtype)
    sparse = acc * mask
    new_residual = acc - sparse
    return red.sum(sparse) / red.world, new_residual


def compress_tree_psum(grads: Any, residuals: Optional[Any], red: Reduction,
                       method: str, seed: int = 0, k_frac: float = 0.05
                       ) -> Tuple[Any, Optional[Any]]:
    """A compression scheme leaf by leaf over a gradient tree (the port's
    nested dicts and lists): "none" (the plain mean), "int8" (one
    generator stream for the tree, seeded by (seed, rank), drawn in
    ``params.leaves`` order) or "topk" (``residuals`` a tree like
    ``grads``). Returns (the reduced tree, the residuals)."""
    if method == "none":
        return map_tree(lambda g: red.sum(g) / red.world, grads), residuals
    flat = list(leaves(grads))
    if method == "int8":
        if not flat:
            return grads, residuals
        gen = rank_generator(seed, red, flat[0][1].device)
        out = {p: int8_allreduce(g, red, gen) for p, g in flat}
        return map_tree_paths(grads, out), residuals
    if method == "topk":
        if residuals is None:
            raise ValueError("topk compression needs the residuals")
        res = dict(leaves(residuals))
        pairs = {p: topk_error_feedback(g, res[p], red, k_frac)
                 for p, g in flat}
        return (map_tree_paths(grads, {p: v[0] for p, v in pairs.items()}),
                map_tree_paths(grads, {p: v[1] for p, v in pairs.items()}))
    raise ValueError(method)
