"""Prefill and decode step functions.

Port of ``repro/models/stepfn.py``: ``make_prefill_step`` and
``make_decode_step``. ``loss_fn``, ``chunked_xent`` and the train step wait
for the training slice. Eager PyTorch has no ``jit``: a step is the plain
function, and the kernel dispatch is read from ``pcfg.kernel`` at every
call (``models/layers.py``), so swapping kernel blocks needs no re-derive.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.models import model as M
from repro_torch.parallel.sharding import ParallelConfig

Tree = Dict[str, Any]


def make_prefill_step(cfg: ArchConfig, pcfg: ParallelConfig, cache_cap: int):
    """prefill_step(params, batch) -> (last-token logits (B,V) fp32, cache)."""

    @torch.inference_mode()
    def prefill_step(params: Tree, batch: Tree):
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.long,
                                 device=tokens.device)[None, :].expand(B, S)
        cache = M.init_cache(cfg, B, cache_cap, device=tokens.device)
        x, new_cache = M.forward(params, cfg=cfg, pcfg=pcfg, mode="prefill",
                                 tokens=tokens, positions=positions,
                                 cache=cache)
        logits = M.output_head(params, cfg, x[:, -1:, :])[:, 0]
        return logits, new_cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, pcfg: ParallelConfig):
    """decode_step(params, cache, batch, pos) -> (logits (B,V), cache).

    ``pos`` is the position of the incoming token; the cache holds the
    positions before it and is updated in place."""

    @torch.inference_mode()
    def decode_step(params: Tree, cache: List[Tree], batch: Tree, pos: int):
        tokens = batch["tokens"]
        B = tokens.shape[0]
        positions = torch.full((B, 1), int(pos), dtype=torch.long,
                               device=tokens.device)
        x, new_cache = M.forward(params, cfg=cfg, pcfg=pcfg, mode="decode",
                                 tokens=tokens, positions=positions,
                                 cache=cache)
        logits = M.output_head(params, cfg, x)[:, 0]
        return logits, new_cache

    return decode_step
