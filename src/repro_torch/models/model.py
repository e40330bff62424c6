"""The decoder: forward pass + cache management.

Port of ``repro/models/model.py`` for every layer kind: ``attn`` (GQA or
MLA attention, with cross-attention where the config has it, then an MoE
or an MLP), ``attn_dense``, ``rglru``, ``mlstm`` and ``slstm``; the cache
of each kind as the reference's ``_cache_layer_specs`` sets it out; the
``embeddings`` frontend with its sinusoidal positions. The reference scans
each segment's stacked parameters with ``lax.scan``; eager PyTorch has no
compile time to save, so the port loops over ``params["layers"]`` in
Python, and its cache is one dict a layer in the same order. Train mode
(no cache) runs each layer under the reference's ``remat`` policy
(``_remat_wrap`` on ``torch.utils.checkpoint``). On a device mesh
(``px``, a ``ShardCtx``) the embedding output takes the reference's
constraint and every layer kind its own, as the reference places them
(``models/layers.py``). ``cache_specs`` and
``abstract_cache`` are the dry-run's views of the cache: its shapes and
dtypes, and the cache as tensors on the ``meta`` device (no storage).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.arch import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.params import DTYPES, layer_kinds, model_specs
from repro_torch.parallel.sharding import (ParallelConfig, ShardCtx,
                                           block_local, constrain,
                                           gather_embed)

Tree = Dict[str, Any]


def attention_cache_cap(cfg: ArchConfig, cap: int) -> int:
    """Slots of a GQA layer's KV cache for a cache of ``cap`` positions:
    ``min(cap, local_window)`` in a config with a local window (a rolling
    cache), else ``cap``."""
    return min(cap, cfg.local_window) if cfg.local_window else cap


def layer_window(cfg: ArchConfig, kind: str) -> Optional[int]:
    """The local window an attention layer of ``kind`` attends over: the
    config's, for the ``attn`` layers of a mixed pattern (the reference's
    rule), else None."""
    if kind == "attn" and cfg.block_pattern != ("attn",):
        return cfg.local_window
    return None


def _cache_layer(cfg: ArchConfig, kind: str, batch: int, cap: int,
                 device) -> Tree:
    """One layer's cache, the reference's ``_cache_layer_specs``: zeros in
    the model dtype for KV, latent and conv buffers, positions -1 (empty;
    int64, the index type of torch), recurrent state in fp32 (the sLSTM
    normalizer ``n`` at 1)."""
    dt = DTYPES[cfg.dtype]

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def pos(c):
        return torch.full((batch, c), -1, dtype=torch.long, device=device)

    f32 = torch.float32
    if kind in ("attn", "attn_dense"):
        if cfg.attention == "mla":
            m = cfg.mla
            t = {"c_kv": zeros(batch, cap, m.kv_lora_rank),
                 "k_rope": zeros(batch, cap, m.qk_rope_head_dim),
                 "pos": pos(cap)}
        else:
            c = attention_cache_cap(cfg, cap)
            kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
            t = {"k": zeros(batch, c, kv, hd), "v": zeros(batch, c, kv, hd),
                 "pos": pos(c)}
        if cfg.cross_attention:
            kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
            t["cross_k"] = zeros(batch, cfg.cross_seq, kv, hd)
            t["cross_v"] = zeros(batch, cfg.cross_seq, kv, hd)
        return t
    if kind == "rglru":
        r = cfg.rglru
        width = r.lru_width or cfg.d_model
        return {"conv": zeros(batch, r.conv_width - 1, width),
                "h": zeros(batch, width, dtype=f32)}
    if kind == "mlstm":
        x = cfg.xlstm
        inner = int(x.mlstm_proj_factor * cfg.d_model)
        nh = x.num_heads
        dv = inner // nh
        dqk = int(x.qk_dim_factor * dv)
        return {"c": zeros(batch, nh, dqk, dv, dtype=f32),
                "n": zeros(batch, nh, dqk, dtype=f32),
                "m": zeros(batch, nh, dtype=f32),
                "conv": zeros(batch, 3, inner)}
    if kind == "slstm":
        nh = cfg.xlstm.num_heads
        shape = (batch, nh, cfg.d_model // nh)
        return {"c": zeros(*shape, dtype=f32),
                "n": torch.ones(shape, dtype=f32, device=device),
                "h": zeros(*shape, dtype=f32), "m": zeros(*shape, dtype=f32)}
    raise ValueError(f"unknown layer kind {kind!r}")


def init_cache(cfg: ArchConfig, batch: int, cap: int, device=None
               ) -> List[Tree]:
    """One cache dict a layer, in layer order (:func:`_cache_layer`)."""
    return [_cache_layer(cfg, kind, batch, cap, device)
            for kind in layer_kinds(cfg)]


def abstract_cache(cfg: ArchConfig, batch: int, cap: int,
                   shardings: Optional[Tree] = None) -> List[Tree]:
    """The cache as meta tensors (the reference's ``ShapeDtypeStruct``
    tree): :func:`init_cache`'s shapes and dtypes, no storage.
    ``shardings`` must be None: a mesh's cache is placed by
    :func:`place_cache`."""
    if shardings is not None:
        raise ValueError("abstract_cache: shardings must be None; place "
                         "the cache on a mesh with place_cache")
    return init_cache(cfg, batch, cap, device="meta")


#: each cache leaf's logical activation axes by (layer kind, name), the
#: reference's ``_cache_layer_specs``
CACHE_AXES = {
    ("attn", "k"): L.KV_CACHE_AXES,
    ("attn", "v"): L.KV_CACHE_AXES,
    ("attn", "pos"): L.POS_CACHE_AXES,
    ("attn", "c_kv"): L.LATENT_CACHE_AXES,
    ("attn", "k_rope"): L.LATENT_CACHE_AXES,
    ("attn", "cross_k"): ("act_batch", None, "act_kv_heads", None),
    ("attn", "cross_v"): ("act_batch", None, "act_kv_heads", None),
    ("rglru", "conv"): ("act_batch", None, "act_mlp"),
    ("rglru", "h"): ("act_batch", "act_mlp"),
    ("mlstm", "c"): ("act_batch", "act_heads", None, None),
    ("mlstm", "n"): ("act_batch", "act_heads", None),
    ("mlstm", "m"): ("act_batch", "act_heads"),
    ("mlstm", "conv"): ("act_batch", None, "act_mlp"),
    **{("slstm", k): ("act_batch", "act_heads", None)
       for k in ("c", "n", "h", "m")},
}


def cache_axes(kind: str, name: str):
    """The logical axes of one cache leaf (``attn_dense`` as ``attn``)."""
    return CACHE_AXES[("attn" if kind == "attn_dense" else kind, name)]


def place_cache(cache: List[Tree], cfg: ArchConfig, px) -> List[Tree]:
    """Off a mesh the cache; on one each leaf a DTensor placed by its
    logical axes (:data:`CACHE_AXES`, ``act_rules``), each rank keeping its
    own block (no rank sends any)."""
    if px is None or px.mesh is None:
        return cache
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.sharding import act_sharding
    return [{k: distribute_tensor(t, *act_sharding(
        t.shape, cache_axes(kind, k), px.mesh, px.pcfg), src_data_rank=None)
        for k, t in layer.items()}
        for kind, layer in zip(layer_kinds(cfg), cache)]


def cache_specs(cfg: ArchConfig, batch: int, cap: int) -> List[Tree]:
    """Each layer's cache as (shape, dtype name) pairs, in layer order."""
    return [{k: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for k, t in layer.items()}
            for layer in abstract_cache(cfg, batch, cap)]


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to the model dtype first, as the reference
    does (in bf16 sqrt(2048) becomes 45.25), as a Python number: the
    product then takes no host-to-device copy, which a captured CUDA graph
    refuses, and rounds as the product with a tensor of the dtype does
    (the factor is exact in the dtype, the product computed in fp32)."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B,S) positions -> (B,S,d) fp32: sin then cos of position x
    10000^(-i / (d/2))."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _apply_layer(kind: str, p: Tree, x: torch.Tensor, *, cfg: ArchConfig,
                 pcfg: ParallelConfig, mode: str, cache, positions, cond,
                 px: Optional[ShardCtx] = None):
    """One layer, as the reference's ``_apply_layer``. Returns (x, new
    cache, aux): aux is an MoE layer's load-balance loss, else None (no
    zero is launched for it). In decode the new cache is ``cache`` itself,
    updated in place. On a mesh the residual stream takes the embedding's
    constraint at each add (GSPMD carries it down the residual), and so
    does each block's output, a sum pending over the mesh dims that split
    its last product's contraction (the row split of ``wo``): else DTensor
    keeps such sums pending, forward and backward, into the next block and
    may plan that block's first product whole on every rank."""
    aux = None
    new_cache = cache

    def out(y):
        return constrain(y, ("act_batch", "act_seq", "act_embed"), px)

    def add(x, y):
        return out(x + out(y))
    if kind in ("attn", "attn_dense"):
        h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        mla = cfg.attention == "mla"
        names = ("c_kv", "k_rope", "pos") if mla else ("k", "v", "pos")
        a_cache = {k: cache[k] for k in names} if cache is not None else None
        kw = dict(cfg=cfg, pcfg=pcfg, mode=mode, cache=a_cache,
                  positions=positions)
        if mla:
            a_out, a_cache = L.mla_attention(p["attn"], h, px=px, **kw)
        else:
            a_out, a_cache = L.gqa_attention(
                p["attn"], h, window=layer_window(cfg, kind), px=px, **kw)
        x = add(x, a_out)
        if cache is not None and mode != "decode":
            new_cache = dict(cache)
            new_cache.update(a_cache)
        if cfg.cross_attention:
            hc = L.rms_norm(x, p["ln_cross"]["scale"], cfg.norm_eps)
            if mode == "decode":
                ckv = (cache["cross_k"], cache["cross_v"])
            else:
                ckv = L.cond_kv(p["cross"], cond, cfg=cfg)
                if cache is not None:
                    new_cache["cross_k"], new_cache["cross_v"] = ckv
            x = add(x, L.cross_attention(p["cross"], hc, ckv, cfg=cfg,
                                         px=px))
        h2 = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        if "moe" in p:
            m_out, aux = L.moe_block(p["moe"], h2, cfg=cfg, pcfg=pcfg, px=px)
        else:
            m_out = L.mlp(p["mlp"], h2, cfg, px)
        return add(x, m_out), new_cache, aux
    h = L.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if kind == "rglru":
        r_out, new_cache = L.rglru_block(p["rec"], h, cfg=cfg, pcfg=pcfg,
                                         mode=mode, cache=cache, px=px)
        x = add(x, r_out)
        h2 = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        return add(x, L.mlp(p["mlp"], h2, cfg, px)), new_cache, aux
    if kind == "mlstm":
        m_out, new_cache = L.mlstm_block(p["mlstm"], h, cfg=cfg, pcfg=pcfg,
                                         mode=mode, cache=cache, px=px)
        return add(x, m_out), new_cache, aux
    if kind == "slstm":
        s_out, new_cache = L.slstm_block(p["slstm"], h, cfg=cfg, pcfg=pcfg,
                                         mode=mode, cache=cache, px=px)
        x = add(x, s_out)
        h2 = L.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
        return add(x, L.mlp(p["ffn"], h2, cfg, px)), new_cache, aux
    raise ValueError(f"unknown layer kind {kind!r}")


#: the matmul ops whose outputs "dots" saves: what ``torch.einsum`` and
#: ``@`` reach at the ATen level (the analogue of ``dots_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, policy: str):
    """The reference's ``_remat_wrap`` on ``torch.utils.checkpoint``:
    "none" keeps every activation, "full" saves the layer's inputs only and
    recomputes the rest in the backward pass, "dots" saves the outputs of
    the matmuls and recomputes the elementwise work between them."""
    if policy == "none":
        return fn
    if policy not in ("dots", "full"):
        raise ValueError(f"remat must be none, dots or full, not {policy!r}")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def forward(params: Tree, *, cfg: ArchConfig, pcfg: ParallelConfig,
            mode: str, positions: torch.Tensor,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            cond: Optional[torch.Tensor] = None,
            cache: Optional[List[Tree]] = None, return_aux: bool = False,
            px: Optional[ShardCtx] = None):
    """Returns (hidden (B,S,d) before the final norm, new cache), and the
    layers' summed MoE aux loss (fp32) after them with ``return_aux``; the
    serve path does not ask for it, as the reference's ignores it.
    ``mode="train"`` takes no cache and runs each layer under
    ``pcfg.remat`` (:func:`_train_layers`). The
    ``embeddings`` frontend takes ``embeds`` (B,S,d) and adds sinusoidal
    positions; the others take ``tokens``. ``cond`` (B,cross_seq,d) feeds
    cross-attention outside decode (decode reads its K/V from the cache).
    ``px`` with a mesh: parameters and inputs are DTensors on it, and the
    reference's constraints are placed."""
    if cfg.frontend == "embeddings":
        if embeds is None:
            raise ValueError(f"{cfg.name} takes frame embeddings")
        pe = _sinusoidal(positions, cfg.d_model).to(embeds.dtype)
        if px is not None and px.mesh is not None:
            # built alike on every rank: each keeps the block of it that
            # sits beside its block of the embeddings
            from torch.distributed.tensor import distribute_tensor
            pe = distribute_tensor(pe, px.mesh, embeds.placements,
                                   src_data_rank=None)
        x = embeds + pe
    else:
        # on a mesh each rank looks its own rows up (DTensor places the
        # lookup's backward, a scatter, wrongly)
        (x,) = block_local(px, lambda p, t: (p["table"][t],),
                           (params["embed"], tokens), (None, ("act_batch",)),
                           (("act_batch",),))
        if cfg.scale_embeddings:
            x = x * _embed_scale(cfg.d_model, x.dtype)
    x = constrain(x, ("act_batch", "act_seq", "act_embed"), px)
    if mode == "train":
        if cache is not None:
            raise ValueError("train mode takes no cache")
        x, auxes = _train_layers(params, x, cfg=cfg, pcfg=pcfg,
                                 positions=positions, cond=cond, px=px)
        return (x, None, _aux_sum(auxes, x)) if return_aux else (x, None)
    new_cache = [] if cache is not None else None
    auxes = []
    specs = (model_specs(cfg)["layers"] if px is not None
             and px.mesh is not None else None)
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        lc = cache[i] if cache is not None else None
        if specs is not None:
            p = gather_embed(p, specs[i], px)
        x, a_cache, aux = _apply_layer(kind, p, x, cfg=cfg, pcfg=pcfg,
                                       mode=mode, cache=lc,
                                       positions=positions, cond=cond, px=px)
        if aux is not None:
            auxes.append(aux)
        if new_cache is not None:
            new_cache.append(a_cache)
    if return_aux:
        return x, new_cache, _aux_sum(auxes, x)
    return x, new_cache


def _aux_sum(auxes, x) -> torch.Tensor:
    return sum(auxes, torch.zeros((), dtype=torch.float32, device=x.device))


def _train_layers(params: Tree, x, *, cfg: ArchConfig, pcfg: ParallelConfig,
                  positions, cond, px: Optional[ShardCtx] = None):
    """The layers in train mode (no cache): each layer under
    ``pcfg.remat`` (the reference wraps each scan body, one cycle of the
    pattern; the unit here is one layer, the same function). Returns
    (hidden, the MoE layers' aux losses)."""
    auxes = []
    kinds = layer_kinds(cfg)
    specs = (model_specs(cfg)["layers"] if px is not None
             and px.mesh is not None else [None] * len(kinds))
    for i, (kind, p, spec) in enumerate(zip(kinds, params["layers"],
                                            specs)):
        def layer(x_, p_, kind=kind, spec=spec, i=i):
            # gathered inside the remat unit: recomputation gathers again
            p_ = gather_embed(p_, spec, px)
            y, _, a = _apply_layer(kind, p_, x_, cfg=cfg, pcfg=pcfg,
                                   mode="train", cache=None,
                                   positions=positions, cond=cond, px=px)
            return y, a
        x, aux = _remat_wrap(layer, pcfg.remat)(x, p)
        if aux is not None:
            auxes.append(aux)
    return x, auxes


def head_params(params: Tree, cfg: ArchConfig,
                px: Optional[ShardCtx] = None) -> Tree:
    """The final norm and the head's weight ({"final_norm", "lm_head" or
    "embed"}), on a mesh with their ``embed`` dims gathered
    (``sharding.gather_embed``)."""
    keep = {k: params[k] for k in ("final_norm", "lm_head", "embed")
            if k in params}
    if px is None or px.mesh is None:
        return keep
    specs = model_specs(cfg)
    return gather_embed(keep, {k: specs[k] for k in keep}, px)


def output_head(params: Tree, cfg: ArchConfig, x: torch.Tensor,
                px: Optional[ShardCtx] = None) -> torch.Tensor:
    """Final norm + logits projection in the model dtype. x (B,S,d) ->
    (B,S,V) fp32. A tied model reads its head from ``embed.table.T``."""
    params = head_params(params, cfg, px)
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
        self.cfg = cfg
        self.params = params
        self.pcfg = pcfg or ParallelConfig()

    def forward(self, tokens, positions, *, mode: str, cache=None):
        return forward(self.params, cfg=self.cfg, pcfg=self.pcfg, mode=mode,
                       tokens=tokens, positions=positions, cache=cache)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return output_head(self.params, self.cfg, x)
