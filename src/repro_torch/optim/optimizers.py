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
reads nothing back to the host. ``abstract_state`` is the state
``init`` builds for a tree of meta tensors (the dry-run's shapes, no
storage). It follows the port's per-layer tree: where the reference
stacks a segment's layers on a leading axis, Adafactor factors the
stacked leaf, so a stacked vector (a norm's scale, a bias) is a matrix
there, with a row and a column state, and a vector with one full state
here (ROADMAP Queue 3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.models.params import DTYPES, leaves, map_tree


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
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


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
        zeros = lambda p: torch.zeros(p.shape, dtype=md, device=p.device)
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
    """Factored second-moment optimizer (memory: ~1 fp32 scalar per row+col)."""

    schedule: Callable[[torch.Tensor], torch.Tensor]
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def _factored(self, shape) -> bool:
        return len(shape) >= 2

    def init(self, params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if self._factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"v": map_tree(one, params), "count": _count(_flat(params)[0])}

    def abstract_state(self, param_structs):
        """The state of a tree of meta tensors, as meta tensors."""
        return self.init(map_tree(_meta, param_structs))

    @torch.no_grad()
    def update(self, grads, state, params):
        count = state["count"] + 1
        cf = count.to(torch.float32)
        lr = self.schedule(state["count"])
        beta = 1.0 - cf ** (-self.decay)
        for (path, p), g in zip(leaves(params), _flat(grads)):
            v = state["v"]          # the parameter's {"vr", "vc"} or {"v"}
            for k in path:
                v = v[k]
            g32 = g.float()
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
            new_p = p.float() - lr * (upd + self.weight_decay * p.float())
            p.copy_(new_p.to(p.dtype))
        state["count"] = count
        return params, state, {"lr": lr}


def make_optimizer(name: str, schedule, moment_dtype: str = "float32"):
    if name == "adamw":
        return AdamW(schedule=schedule, moment_dtype=moment_dtype)
    if name == "adafactor":
        return Adafactor(schedule=schedule)
    raise ValueError(name)
