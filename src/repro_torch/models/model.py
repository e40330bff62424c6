"""The dense decoder: forward pass + cache management.

Port of ``repro/models/model.py`` for decoders whose every layer is an
attention layer (``block_pattern == ("attn",)``). The reference scans each
segment's stacked parameters with ``lax.scan``; eager PyTorch has no
compile time to save, so the port loops over ``params["layers"]`` in
Python. Other layer kinds, MLA, MoE, cross-attention and the embeddings
frontend raise ``NotImplementedError`` (``models/params.check_supported``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.arch import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.params import DTYPES, check_supported
from repro_torch.parallel.sharding import ParallelConfig

Tree = Dict[str, Any]


def init_cache(cfg: ArchConfig, batch: int, cap: int, device=None
               ) -> List[Tree]:
    """One ``{"k", "v", "pos"}`` cache per layer: zeros in the model dtype,
    positions -1 (empty). Positions are int64, the index type of torch."""
    check_supported(cfg)
    dt = DTYPES[cfg.dtype]
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return [{"k": torch.zeros((batch, cap, kv, hd), dtype=dt, device=device),
             "v": torch.zeros((batch, cap, kv, hd), dtype=dt, device=device),
             "pos": torch.full((batch, cap), -1, dtype=torch.long,
                               device=device)}
            for _ in range(cfg.num_layers)]


def forward(params: Tree, *, cfg: ArchConfig, pcfg: ParallelConfig,
            mode: str, tokens: torch.Tensor, positions: torch.Tensor,
            cache: Optional[List[Tree]] = None
            ) -> Tuple[torch.Tensor, Optional[List[Tree]]]:
    """Returns (hidden (B,S,d) before the final norm, new cache)."""
    x = params["embed"]["table"][tokens]
    if cfg.scale_embeddings:
        # the factor is rounded to the model dtype first, as the reference
        # does: in bf16 sqrt(2048) becomes 45.25
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    new_cache = [] if cache is not None else None
    for i, p in enumerate(params["layers"]):
        lc = cache[i] if cache is not None else None
        h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        a_out, a_cache = L.gqa_attention(p["attn"], h, cfg=cfg, pcfg=pcfg,
                                         mode=mode, cache=lc,
                                         positions=positions)
        x = x + a_out
        h2 = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h2, cfg)
        if new_cache is not None:
            new_cache.append(a_cache)
    return x, new_cache


def output_head(params: Tree, cfg: ArchConfig, x: torch.Tensor
                ) -> torch.Tensor:
    """Final norm + logits projection in the model dtype. x (B,S,d) ->
    (B,S,V) fp32. A tied model reads its head from ``embed.table.T``."""
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if "lm_head" in params:
        w = params["lm_head"]["w"]
    else:
        w = params["embed"]["table"].T
    return (x @ w.to(x.dtype)).float()


class Decoder(nn.Module):
    """The decoder as a module: ``forward`` is :func:`forward` over the
    weights it holds. Weights stay a plain tree of tensors
    (``self.params``), the layout ``params_from_jax`` produces and the
    tests compare with the reference; they are inference weights, not
    ``nn.Parameter`` s."""

    def __init__(self, cfg: ArchConfig, params: Tree,
                 pcfg: Optional[ParallelConfig] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.pcfg = pcfg or ParallelConfig()

    def forward(self, tokens, positions, *, mode: str, cache=None):
        return forward(self.params, cfg=self.cfg, pcfg=self.pcfg, mode=mode,
                       tokens=tokens, positions=positions, cache=cache)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return output_head(self.params, self.cfg, x)
