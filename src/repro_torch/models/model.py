"""The decoder: forward pass + cache management.

Port of ``repro/models/model.py`` for decoders whose layers are attention
layers (``block_pattern == ("attn",)``): ``attn`` layers, with an MoE MLP
where the config has one, and an MoE config's dense first layers
(``attn_dense``), the reference's ``_apply_layer`` for those two kinds.
The reference scans each segment's stacked parameters with ``lax.scan``;
eager PyTorch has no compile time to save, so the port loops over
``params["layers"]`` in Python. Still cut, and raising
``NotImplementedError`` (``models/params.check_supported``): MLA, RG-LRU,
mLSTM/sLSTM, cross-attention, the embeddings frontend and local windows.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.arch import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.params import DTYPES, check_supported, layer_kinds
from repro_torch.parallel.sharding import ParallelConfig

Tree = Dict[str, Any]


def init_cache(cfg: ArchConfig, batch: int, cap: int, device=None
               ) -> List[Tree]:
    """One ``{"k", "v", "pos"}`` cache per layer, every layer of either
    kind (``attn``, ``attn_dense``): zeros in the model dtype, positions -1
    (empty). Positions are int64, the index type of torch."""
    check_supported(cfg)
    dt = DTYPES[cfg.dtype]
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return [{"k": torch.zeros((batch, cap, kv, hd), dtype=dt, device=device),
             "v": torch.zeros((batch, cap, kv, hd), dtype=dt, device=device),
             "pos": torch.full((batch, cap), -1, dtype=torch.long,
                               device=device)}
            for _ in range(cfg.num_layers)]


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to the model dtype first, as the reference
    does (in bf16 sqrt(2048) becomes 45.25), as a Python number: the
    product then takes no host-to-device copy, which a captured CUDA graph
    refuses, and rounds as the product with a tensor of the dtype does
    (the factor is exact in the dtype, the product computed in fp32)."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def _apply_layer(kind: str, p: Tree, x: torch.Tensor, *, cfg: ArchConfig,
                 pcfg: ParallelConfig, mode: str, cache, positions):
    """One ``attn`` or ``attn_dense`` layer, as the reference's
    ``_apply_layer``: attention, then the MoE where the layer has one (its
    aux loss returned), else the MLP (aux None: no zero is launched for
    it). Returns (x, new cache, aux)."""
    if kind not in ("attn", "attn_dense"):
        raise NotImplementedError(f"layer kind {kind!r} not ported yet")
    aux = None
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    a_out, new_cache = L.gqa_attention(p["attn"], h, cfg=cfg, pcfg=pcfg,
                                       mode=mode, cache=cache,
                                       positions=positions)
    x = x + a_out
    h2 = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    if "moe" in p:
        m_out, aux = L.moe_block(p["moe"], h2, cfg=cfg, pcfg=pcfg)
    else:
        m_out = L.mlp(p["mlp"], h2, cfg)
    return x + m_out, new_cache, aux


def forward(params: Tree, *, cfg: ArchConfig, pcfg: ParallelConfig,
            mode: str, tokens: torch.Tensor, positions: torch.Tensor,
            cache: Optional[List[Tree]] = None, return_aux: bool = False):
    """Returns (hidden (B,S,d) before the final norm, new cache), and the
    layers' summed MoE aux loss (fp32) after them with ``return_aux``; the
    serve path does not ask for it, as the reference's ignores it."""
    x = params["embed"]["table"][tokens]
    if cfg.scale_embeddings:
        x = x * _embed_scale(cfg.d_model, x.dtype)
    new_cache = [] if cache is not None else None
    auxes = []
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        lc = cache[i] if cache is not None else None
        x, a_cache, aux = _apply_layer(kind, p, x, cfg=cfg, pcfg=pcfg,
                                       mode=mode, cache=lc,
                                       positions=positions)
        if aux is not None:
            auxes.append(aux)
        if new_cache is not None:
            new_cache.append(a_cache)
    if return_aux:
        return x, new_cache, sum(auxes, torch.zeros(
            (), dtype=torch.float32, device=x.device))
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
