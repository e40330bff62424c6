"""Declarative parameter specs and initialisation for the decoders.

Port of ``repro/models/params.py``, cut to the dense and MoE attention
families (GQA/MQA/MHA attention + a gated MLP or a mixture of experts,
``attn`` and ``attn_dense`` layers): ``ParamSpec``, ``layer_specs``,
``model_specs``, ``count_params`` and ``init_params``. MLA, RG-LRU, xLSTM
and cross-attention specs wait for their slices and raise
``NotImplementedError``; the sharding and ``ShapeDtypeStruct`` views of the
spec tree have no use on one card and are cut.

The port's tree differs from the reference's in one way: layers are a
Python list of per-layer dicts (``params["layers"][i]``), where the
reference stacks each segment on a leading ``layers`` axis for ``lax.scan``.
:func:`params_from_jax` unstacks a reference tree into this layout, which is
how the tests hold the port against the JAX package on the same weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.arch import ArchConfig

Tree = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"         # normal | zeros | ones
    scale: Optional[float] = None
    dtype: Optional[str] = None  # None -> cfg.dtype; norms are fp32


def _norm(d: int) -> Tree:
    return {"scale": ParamSpec((d,), init="ones", dtype="float32")}


def _mlp_specs(cfg: ArchConfig, d_ff: int) -> Tree:
    d = cfg.d_model
    return {
        "wg": ParamSpec((d, d_ff)),
        "wu": ParamSpec((d, d_ff)),
        "wd": ParamSpec((d_ff, d), scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _gqa_specs(cfg: ArchConfig) -> Tree:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    t: Tree = {
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, kv, hd)),
        "wv": ParamSpec((d, kv, hd)),
        "wo": ParamSpec((h, hd, d), scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qk_norm:
        t["q_norm"] = _norm(hd)
        t["k_norm"] = _norm(hd)
    return t


def _moe_specs(cfg: ArchConfig) -> Tree:
    """Router (fp32), the experts' stacked gated MLPs, a router bias for the
    sigmoid router and the shared experts' MLP, as the reference's."""
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.num_experts, mo.d_expert
    t: Tree = {
        "router": ParamSpec((d, e), dtype="float32"),
        "wg": ParamSpec((e, d, f)),
        "wu": ParamSpec((e, d, f)),
        "wd": ParamSpec((e, f, d), scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }
    if mo.router_score == "sigmoid":
        t["router_bias"] = ParamSpec((e,), init="zeros", dtype="float32")
    if mo.num_shared_experts > 0:
        t["shared"] = _mlp_specs(cfg, mo.num_shared_experts * mo.d_expert)
    return t


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the parts of a config the port does not run yet: MLA,
    RG-LRU, mLSTM/sLSTM, cross-attention, the embeddings frontend and
    local windows."""
    cut = [(cfg.attention != "gqa", f"attention={cfg.attention!r}"),
           (cfg.cross_attention, "cross-attention"),
           (cfg.frontend is not None, f"frontend={cfg.frontend!r}"),
           (set(cfg.block_pattern) != {"attn"},
            f"layer kinds {cfg.block_pattern}"),
           (cfg.local_window is not None, "local windows")]
    bad = [what for hit, what in cut if hit]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet (the port runs "
            "dense and MoE attention decoders)")


def layer_specs(cfg: ArchConfig, kind: str = "attn") -> Tree:
    """Specs for one layer: ``attn`` (attention + the MoE where the config
    has one, else the MLP) or ``attn_dense`` (an MoE config's dense first
    layers: attention + an MLP of ``dense_d_ff``)."""
    if kind not in ("attn", "attn_dense"):
        raise NotImplementedError(f"layer kind {kind!r} not ported yet")
    t: Tree = {"ln1": _norm(cfg.d_model), "attn": _gqa_specs(cfg),
               "ln2": _norm(cfg.d_model)}
    if cfg.moe is not None and kind == "attn":
        t["moe"] = _moe_specs(cfg)
    else:
        d_ff = ((cfg.dense_d_ff or cfg.d_ff) if kind == "attn_dense"
                else cfg.d_ff)
        t["mlp"] = _mlp_specs(cfg, d_ff)
    return t


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """Each layer's kind in order: the reference's segments
    (``pattern_layers``) unrolled."""
    return [kind for n_rep, cycle in cfg.pattern_layers()
            for _ in range(n_rep) for kind in cycle]


def model_specs(cfg: ArchConfig) -> Tree:
    """Full spec tree: embed table, one tree per layer, final norm, and an
    untied head where the config has one."""
    check_supported(cfg)
    t: Tree = {"embed": {"table": ParamSpec((cfg.vocab_size, cfg.d_model),
                                            scale=0.02)},
               "layers": [layer_specs(cfg, kind)
                          for kind in layer_kinds(cfg)],
               "final_norm": _norm(cfg.d_model)}
    if not cfg.tie_embeddings:
        t["lm_head"] = {"w": ParamSpec((cfg.d_model, cfg.vocab_size),
                                       scale=0.02)}
    return t


def leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in a fixed order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Total (or active, for MoE: each routed expert tensor counted at
    top_k / num_experts) parameter count, as the reference's."""
    total = 0
    for path, spec in leaves(model_specs(cfg)):
        n = int(np.prod(spec.shape))
        if active_only and cfg.moe is not None and "moe" in path:
            last = str(path[-1])
            if "shared" not in path and "router" not in last:
                n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Tree:
    """Random weights with the reference's distributions: fp32 normal ×
    scale (0.02 unless the spec says otherwise), then cast to the model
    dtype; norms are ones in fp32. Draws come from ``generator`` (on
    ``device``) in :func:`leaves` order, so a seed fixes the weights —
    though not the reference's, whose ``jax.random`` bits torch cannot
    reproduce (:func:`params_from_jax` carries those across)."""
    device = torch.device(device or generator.device)

    def one(spec: ParamSpec):
        dt = DTYPES[spec.dtype or cfg.dtype]
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        scale = spec.scale if spec.scale is not None else 0.02
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dt)

    specs = model_specs(cfg)
    flat = {path: one(s) for path, s in leaves(specs)}
    return map_tree_paths(specs, flat)


def map_tree_paths(specs: Tree, flat: Dict[Tuple, Any]) -> Tree:
    """Rebuild ``specs``' structure with the values of ``flat`` by path."""
    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, path + (i,)) for i, v in enumerate(tree)]
        return flat[path]
    return build(specs, ())


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: carry the bits exactly
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Tree, cfg: ArchConfig, device="cpu") -> Tree:
    """The reference's parameter tree (leaves as numpy arrays, segments
    stacked on a leading ``layers`` axis, ``repro/models/params.py:196``)
    as the port's per-layer tree, values and dtypes unchanged."""
    check_supported(cfg)
    layers: List[Tree] = []
    for si, (n_rep, cycle) in enumerate(cfg.pattern_layers()):
        seg = tree["segments"][si]
        for i in range(n_rep):
            for j, kind in enumerate(cycle):
                layers.append(map_tree(lambda a: _to_torch(a[i], device),
                                       seg[f"{j}:{kind}"]))
    out: Tree = {"embed": map_tree(lambda a: _to_torch(a, device),
                                   tree["embed"]),
                 "layers": layers,
                 "final_norm": map_tree(lambda a: _to_torch(a, device),
                                        tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = map_tree(lambda a: _to_torch(a, device),
                                  tree["lm_head"])
    return out
