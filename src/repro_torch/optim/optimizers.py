"""Optimizers: AdamW and Adafactor, plus LR schedules.

Port of ``repro/optim/optimizers.py``. State trees mirror the port's
parameter tree (the same dicts and lists, ``models/params.leaves`` order),
and the arithmetic is the reference's op for op: the clip casts
``g * scale`` back to the grad's dtype; AdamW divides ``mu`` and ``nu`` by
their bias corrections and adds ``eps`` after the square root; the decay
joins the step before the multiply by ``lr``; the new parameter is computed
in fp32 and then cast; ``lr = schedule(count)`` reads the count before its
increment; schedules are evaluated in fp32. ``torch.optim.AdamW`` is a
different function (it decays as ``p *= 1 - lr * wd`` and places ``eps``
elsewhere) and is not used.

``update`` writes the new parameters and state into the tensors it was
given (the reference donates them to its jitted step) and returns them, so
one card holds one copy of the weights and the moments. Scalars (``count``,
``lr``, the global norm) stay tensors on the parameters' device: a step
reads nothing back to the host. On a device mesh the weights, gradients
and moments are DTensors placed alike (``shard_params``; the train step
places each gradient as its weight), each update is local to its shard,
and ``global_norm`` sums over the ranks. ``abstract_state`` is the state
``init`` builds for a tree of meta tensors (the dry-run's shapes, no
storage).

The reference stacks each segment's layers on a leading axis, so its
Adafactor factors and clips a stacked leaf: a norm's scale (L, d) has a
row and a column state and is clipped by its RMS over all L layers.
``Adafactor(stacks=params.layer_stacks(cfg))`` does the same over the
port's per-layer tree: each stack's leaves are stacked for the update and
its state is the reference's, ``state["v"]["segments"]``. Without
``stacks`` each leaf is its own, which is the reference's rule on a tree
that stacks nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.models.params import DTYPES, layer_stacks, leaves, map_tree


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (step + 1) / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return schedule


def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def _flat(tree):
    return [t for _, t in leaves(tree)]


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in _flat(tree)]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _meta(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a meta tensor; a meta tensor (a meta DTensor on a mesh, its
    placements kept) as it is."""
    if t.device.type == "meta":
        return t
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _zeros(p: torch.Tensor, shape, dims: Sequence[Optional[int]]
           ) -> torch.Tensor:
    """fp32 zeros of ``shape`` on ``p``'s device. For a DTensor ``p`` they
    are a DTensor on its mesh, placed as ``p``: tensor dim i of ``p`` is dim
    ``dims[i]`` of the state (None: reduced away, so replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    pl = [Shard(dims[q.dim]) if isinstance(q, Shard)
          and dims[q.dim] is not None else Replicate() for q in p.placements]
    from torch.distributed.tensor import zeros
    return zeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                 placements=pl)


def _count(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=like.device)


@dataclass(frozen=True)
class AdamW:
    schedule: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"
    clip_norm: Optional[float] = 1.0

    def init(self, params):
        md = DTYPES[self.moment_dtype]
        zeros = lambda p: torch.zeros_like(p, dtype=md)
        return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
                "count": _count(_flat(params)[0])}

    def abstract_state(self, param_structs):
        """The state of a tree of meta tensors, as meta tensors."""
        return self.init(map_tree(_meta, param_structs))

    @torch.no_grad()
    def update(self, grads, state, params):
        if self.clip_norm:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        else:
            gnorm = global_norm(grads)
        count = state["count"] + 1
        cf = count.to(torch.float32)
        lr = self.schedule(state["count"])
        bc1 = 1 - self.b1 ** cf
        bc2 = 1 - self.b2 ** cf
        md = DTYPES[self.moment_dtype]
        for p, g, mu, nu in zip(_flat(params), _flat(grads), _flat(state["mu"]),
                                _flat(state["nu"])):
            g32 = g.float()
            mu32 = self.b1 * mu.float() + (1 - self.b1) * g32
            nu32 = self.b2 * nu.float() + (1 - self.b2) * torch.square(g32)
            step = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + self.eps)
            step = step + self.weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
            mu.copy_(mu32.to(md))
            nu.copy_(nu32.to(md))
        state["count"] = count
        return params, state, {"grad_norm": gnorm, "lr": lr}


@dataclass(frozen=True)
class Adafactor:
    """Factored second-moment optimizer (memory: ~1 fp32 scalar per row+col).

    ``stacks``: the reference's stacking of ``params["layers"]``
    (``params.layer_stacks``), one dict a segment mapping each stack's key
    to its layers; None treats every leaf alone."""

    schedule: Callable[[torch.Tensor], torch.Tensor]
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    stacks: Optional[List[Dict[str, List[int]]]] = None

    def _factored(self, shape) -> bool:
        return len(shape) >= 2

    def _one(self, p, lead: int = 0):
        """The state of a leaf like ``p``, stacked ``lead`` deep when
        ``lead`` > 0 (a stack of that many layers)."""
        shape = ((lead,) if lead else ()) + tuple(p.shape)
        n, off = len(shape), 1 if lead else 0
        dims = range(off, n)                 # p's dims in the stacked shape
        if self._factored(shape):
            return {"vr": _zeros(p, shape[:-1],
                                 [j if j < n - 1 else None for j in dims]),
                    "vc": _zeros(p, shape[:-2] + shape[-1:],
                                 [j if j < n - 2 else (None if j == n - 2
                                                       else n - 2)
                                  for j in dims])}
        return {"v": _zeros(p, shape, list(dims))}

    def _unstacked(self, tree):
        return {k: v for k, v in tree.items()
                if self.stacks is None or k != "layers"}

    def _groups(self, tree):
        """(leaves, state path, stacked) of each update: each leaf outside
        the stacks alone, then each stack's leaves path by path, at the
        paths of the reference's state tree."""
        out = [([t], path, False) for path, t in leaves(self._unstacked(tree))]
        for si, seg in enumerate(self.stacks or []):
            for key, idx in seg.items():
                for path, _ in leaves(tree["layers"][idx[0]]):
                    out.append(([_at(tree["layers"][i], path) for i in idx],
                                ("segments", si, key) + path, True))
        return out

    def init(self, params):
        v = map_tree(self._one, self._unstacked(params))
        if self.stacks is not None:
            v["segments"] = [
                {key: map_tree(lambda p, n=len(idx): self._one(p, n),
                               params["layers"][idx[0]])
                 for key, idx in seg.items()} for seg in self.stacks]
        return {"v": v, "count": _count(_flat(params)[0])}

    def abstract_state(self, param_structs):
        """The state of a tree of meta tensors, as meta tensors."""
        return self.init(map_tree(_meta, param_structs))

    @torch.no_grad()
    def update(self, grads, state, params):
        count = state["count"] + 1
        cf = count.to(torch.float32)
        lr = self.schedule(state["count"])
        beta = 1.0 - cf ** (-self.decay)
        gs = {path: torch.stack(g) if stacked else g[0]
              for g, path, stacked in self._groups(grads)}
        for ps, path, stacked in self._groups(params):
            p = torch.stack(ps) if stacked else ps[0]
            v = _at(state["v"], path)
            g32 = gs[path].float()
            g2 = torch.square(g32) + self.eps
            if self._factored(p.shape):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                       min=self.eps))
                upd = g32 * torch.rsqrt(denom + self.eps)
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                nv = beta * v["v"] + (1 - beta) * g2
                upd = g32 * torch.rsqrt(nv + self.eps)
                v["v"].copy_(nv)
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-12)
            upd = upd / torch.clamp(rms / self.clip_threshold, min=1.0)
            new_p = (p.float() - lr * (upd + self.weight_decay * p.float())
                     ).to(p.dtype)
            for i, t in enumerate(ps):
                t.copy_(new_p[i] if stacked else new_p)
        state["count"] = count
        return params, state, {"lr": lr}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def make_optimizer(name: str, schedule, moment_dtype: str = "float32",
                   arch=None):
    """The reference's ``make_optimizer``; ``arch`` (an ``ArchConfig``)
    gives Adafactor the reference's layer stacks."""
    if name == "adamw":
        return AdamW(schedule=schedule, moment_dtype=moment_dtype)
    if name == "adafactor":
        return Adafactor(schedule=schedule, stacks=None if arch is None
                         else layer_stacks(arch))
    raise ValueError(name)
