"""Declarative parameter specs and initialisation for every family.

Port of ``repro/models/params.py``: ``ParamSpec``, the specs of every
layer kind (GQA attention and its cross-attention, MLA, the MLP and the
mixture of experts, RG-LRU, mLSTM and sLSTM), ``layer_specs``,
``model_specs``, ``count_params``, ``init_params`` and the dry-run's
views of the spec tree, ``is_spec``, ``spec_leaves`` and
``abstract_params``: a ``jax.ShapeDtypeStruct`` becomes a tensor on the
``meta`` device (a shape and a dtype, no storage); the dry-run plans one
card, so ``abstract_params`` takes no shardings. Every spec carries the
reference's logical sharding axes, less the stacked ``layers`` axis (its
rule is None): :func:`shard_params` places a tree on a device mesh by
them, and :func:`layer_stacks` says which per-layer leaves the reference
stacks into one (Adafactor factors the stack).

The port's tree differs from the reference's in one way: layers are a
Python list of per-layer dicts (``params["layers"][i]``), where the
reference stacks each segment on a leading ``layers`` axis for ``lax.scan``.
:func:`params_from_jax` unstacks a reference tree into this layout, which is
how the tests hold the port against the JAX package on the same weights;
:func:`opt_state_from_jax` carries AdamW's state across the same way.
Weights are plain tensors (leaves that require no grad); a train step
differentiates with respect to :func:`trainable` views of them and updates
them in place.
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
    logical: Tuple[Optional[str], ...]   # the reference's sharding axes
    init: str = "normal"         # normal | zeros | ones | lru_a
    scale: Optional[float] = None
    dtype: Optional[str] = None  # None -> cfg.dtype; norms are fp32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def _norm(d: int) -> Tree:
    return {"scale": ParamSpec((d,), (None,), init="ones", dtype="float32")}


def _mlp_specs(cfg: ArchConfig, d_ff: int) -> Tree:
    d = cfg.d_model
    return {
        "wg": ParamSpec((d, d_ff), ("embed", "mlp")),
        "wu": ParamSpec((d, d_ff), ("embed", "mlp")),
        "wd": ParamSpec((d_ff, d), ("mlp", "embed"), scale=_out_scale(cfg)),
    }


def _out_scale(cfg: ArchConfig) -> float:
    return 0.02 / math.sqrt(2 * cfg.num_layers)


def _gqa_specs(cfg: ArchConfig, cross: bool = False) -> Tree:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    t: Tree = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"),
                        scale=_out_scale(cfg)),
    }
    if cfg.qk_norm and not cross:
        t["q_norm"] = _norm(hd)
        t["k_norm"] = _norm(hd)
    return t


def _mla_specs(cfg: ArchConfig) -> Tree:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
        "q_a_norm": _norm(m.q_lora_rank),
        "wq_b": ParamSpec((m.q_lora_rank, h, dn + dr),
                          ("lora", "heads", "head_dim")),
        "wkv_a": ParamSpec((d, m.kv_lora_rank), ("embed", "lora")),
        "kv_a_norm": _norm(m.kv_lora_rank),
        "wk_rope": ParamSpec((d, dr), ("embed", None)),
        "wk_nope": ParamSpec((m.kv_lora_rank, h, dn),
                             ("lora", "heads", "head_dim")),
        "wv": ParamSpec((m.kv_lora_rank, h, dv), ("lora", "heads", "head_dim")),
        "wo": ParamSpec((h, dv, d), ("heads", "head_dim", "embed"),
                        scale=_out_scale(cfg)),
    }


def _rglru_specs(cfg: ArchConfig) -> Tree:
    r = cfg.rglru
    d = cfg.d_model
    width = r.lru_width or d
    nb = cfg.num_heads                 # block-diagonal gate blocks
    bs = width // nb
    return {
        "wx": ParamSpec((d, width), ("embed", "mlp")),
        "wy": ParamSpec((d, width), ("embed", "mlp")),
        "conv_w": ParamSpec((r.conv_width, width), (None, "mlp")),
        "conv_b": ParamSpec((width,), ("mlp",), init="zeros"),
        "gate_r_w": ParamSpec((nb, bs, bs), ("heads", None, None)),
        "gate_r_b": ParamSpec((width,), ("mlp",), init="zeros"),
        "gate_i_w": ParamSpec((nb, bs, bs), ("heads", None, None)),
        "gate_i_b": ParamSpec((width,), ("mlp",), init="zeros"),
        "a_param": ParamSpec((width,), ("mlp",), init="lru_a",
                             dtype="float32"),
        "wo": ParamSpec((width, d), ("mlp", "embed"), scale=_out_scale(cfg)),
    }


def _mlstm_specs(cfg: ArchConfig) -> Tree:
    x = cfg.xlstm
    d = cfg.d_model
    inner = int(x.mlstm_proj_factor * d)
    nh = x.num_heads
    d_v = inner // nh
    d_qk = int(x.qk_dim_factor * d_v)
    return {
        "w_up": ParamSpec((d, 2, inner), ("embed", None, "mlp")),
        "conv_w": ParamSpec((4, inner), (None, "mlp")),
        "conv_b": ParamSpec((inner,), ("mlp",), init="zeros"),
        "wq": ParamSpec((inner, nh, d_qk), ("mlp", "heads", None)),
        "wk": ParamSpec((inner, nh, d_qk), ("mlp", "heads", None)),
        "wv": ParamSpec((inner, nh, d_v), ("mlp", "heads", None)),
        "w_igate": ParamSpec((inner, nh), ("mlp", "heads"), dtype="float32"),
        "b_igate": ParamSpec((nh,), ("heads",), init="zeros",
                             dtype="float32"),
        "w_fgate": ParamSpec((inner, nh), ("mlp", "heads"), dtype="float32"),
        "b_fgate": ParamSpec((nh,), ("heads",), init="ones", dtype="float32"),
        "out_norm": _norm(inner),
        "w_down": ParamSpec((inner, d), ("mlp", "embed"),
                            scale=_out_scale(cfg)),
    }


def _slstm_specs(cfg: ArchConfig) -> Tree:
    nh = cfg.xlstm.num_heads
    d = cfg.d_model
    dh = d // nh
    return {
        "wx": ParamSpec((d, 4, nh, dh), ("embed", None, "heads", None)),
        "r": ParamSpec((4, nh, dh, dh), (None, "heads", None, None)),
        "b": ParamSpec((4, nh, dh), (None, "heads", None), init="zeros",
                       dtype="float32"),
        "group_norm": _norm(d),
    }


def _moe_specs(cfg: ArchConfig) -> Tree:
    """Router (fp32), the experts' stacked gated MLPs, a router bias for the
    sigmoid router and the shared experts' MLP, as the reference's."""
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.num_experts, mo.d_expert
    t: Tree = {
        "router": ParamSpec((d, e), ("embed", None), dtype="float32"),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wu": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wd": ParamSpec((e, f, d), ("experts", "mlp", "embed"),
                        scale=_out_scale(cfg)),
    }
    if mo.router_score == "sigmoid":
        t["router_bias"] = ParamSpec((e,), (None,), init="zeros",
                                     dtype="float32")
    if mo.num_shared_experts > 0:
        t["shared"] = _mlp_specs(cfg, mo.num_shared_experts * mo.d_expert)
    return t


def layer_specs(cfg: ArchConfig, kind: str = "attn") -> Tree:
    """Specs for one layer of a kind: ``attn`` (attention, GQA or MLA, with
    cross-attention where the config has it, then the MoE where the config
    has one, else the MLP), ``attn_dense`` (an MoE config's dense first
    layers: an MLP of ``dense_d_ff``), ``rglru``, ``mlstm`` or ``slstm``."""
    if kind in ("attn", "attn_dense"):
        t: Tree = {"ln1": _norm(cfg.d_model), "ln2": _norm(cfg.d_model),
                   "attn": (_mla_specs(cfg) if cfg.attention == "mla"
                            else _gqa_specs(cfg))}
        if cfg.cross_attention:
            t["ln_cross"] = _norm(cfg.d_model)
            t["cross"] = _gqa_specs(cfg, cross=True)
        if cfg.moe is not None and kind == "attn":
            t["moe"] = _moe_specs(cfg)
        else:
            d_ff = ((cfg.dense_d_ff or cfg.d_ff) if kind == "attn_dense"
                    else cfg.d_ff)
            t["mlp"] = _mlp_specs(cfg, d_ff)
        return t
    if kind == "rglru":
        return {"ln1": _norm(cfg.d_model), "rec": _rglru_specs(cfg),
                "ln2": _norm(cfg.d_model), "mlp": _mlp_specs(cfg, cfg.d_ff)}
    if kind == "mlstm":
        return {"ln1": _norm(cfg.d_model), "mlstm": _mlstm_specs(cfg)}
    if kind == "slstm":
        return {"ln1": _norm(cfg.d_model), "slstm": _slstm_specs(cfg),
                "ln2": _norm(cfg.d_model),
                "ffn": _mlp_specs(cfg, int(cfg.xlstm.slstm_proj_factor
                                           * cfg.d_model))}
    raise ValueError(f"unknown layer kind {kind!r}")


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """Each layer's kind in order: the reference's segments
    (``pattern_layers``) unrolled."""
    return [kind for n_rep, cycle in cfg.pattern_layers()
            for _ in range(n_rep) for kind in cycle]


def layer_stacks(cfg: ArchConfig) -> List[Dict[str, List[int]]]:
    """The reference's stacking of the port's layers: one dict a segment of
    ``cfg.pattern_layers()``, mapping each cycle position ``f"{j}:{kind}"``
    (the reference's key) to the indices in ``params["layers"]`` of the
    layers it stacks on its leading ``layers`` axis, in order."""
    out, first = [], 0
    for n_rep, cycle in cfg.pattern_layers():
        out.append({f"{j}:{kind}": [first + i * len(cycle) + j
                                    for i in range(n_rep)]
                    for j, kind in enumerate(cycle)})
        first += n_rep * len(cycle)
    return out


def model_specs(cfg: ArchConfig) -> Tree:
    """Full spec tree: the embed table (none for the ``embeddings``
    frontend), one tree per layer, final norm, and a head where the config
    is untied or has no table to tie it to. ``cfg.mtp`` changes nothing:
    the reference has no multi-token-prediction head and reads the flag
    nowhere, so a config with ``mtp=True`` builds and runs as with
    False."""
    t: Tree = {"layers": [layer_specs(cfg, kind)
                          for kind in layer_kinds(cfg)],
               "final_norm": _norm(cfg.d_model)}
    if cfg.frontend != "embeddings":
        t["embed"] = {"table": ParamSpec((cfg.vocab_size, cfg.d_model),
                                         ("vocab", "embed"), scale=0.02)}
    if cfg.frontend == "embeddings" or not cfg.tie_embeddings:
        t["lm_head"] = {"w": ParamSpec((cfg.d_model, cfg.vocab_size),
                                       ("embed", "vocab"), scale=0.02)}
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


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_leaves(tree: Tree) -> List[ParamSpec]:
    """The specs of a spec tree in :func:`leaves` order."""
    return [s for _, s in leaves(tree)]


def abstract_params(cfg: ArchConfig, shardings: Optional[Tree] = None
                    ) -> Tree:
    """The parameter tree as meta tensors: each leaf's shape and dtype,
    no storage (the reference's ``ShapeDtypeStruct`` tree). ``shardings``
    must be None: a mesh's parameters are placed by :func:`shard_params`."""
    if shardings is not None:
        raise ValueError("abstract_params: shardings must be None; place "
                         "the tree on a mesh with shard_params")
    return map_tree(lambda spec: torch.empty(
        spec.shape, dtype=DTYPES[spec.dtype or cfg.dtype], device="meta"),
        model_specs(cfg))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Tree:
    """Random weights with the reference's distributions: fp32 normal ×
    scale (0.02 unless the spec says otherwise), then cast to the model
    dtype; norms are ones in fp32; the RG-LRU's ``a_param`` is
    log(u / (1 - u)), u uniform in (0.9, 0.999) (Griffin's init). Draws
    come from ``generator`` (on ``device``) in :func:`leaves` order, so a
    seed fixes the weights —
    though not the reference's, whose ``jax.random`` bits torch cannot
    reproduce (:func:`params_from_jax` carries those across)."""
    device = torch.device(device or generator.device)

    def one(spec: ParamSpec):
        dt = DTYPES[spec.dtype or cfg.dtype]
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        if spec.init == "lru_a":
            u = torch.rand(spec.shape, generator=generator,
                           dtype=torch.float32, device=device)
            u = u.mul_(0.999 - 0.9).add_(0.9)
            return torch.log(u / (1.0 - u)).to(dt)
        scale = spec.scale if spec.scale is not None else 0.02
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dt)

    specs = model_specs(cfg)
    flat = {path: one(s) for path, s in leaves(specs)}
    return map_tree_paths(specs, flat)


def map_tree_paths(specs: Tree, flat: Dict[Tuple, Any],
                   path: Tuple = ()) -> Tree:
    """Rebuild ``specs``' structure with the values of ``flat`` by path.
    (Recursive at module level: a recursive inner function is a reference
    cycle, which would keep ``flat``'s tensors alive until the garbage
    collector ran.)"""
    if isinstance(specs, dict):
        return {k: map_tree_paths(v, flat, path + (k,))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_tree_paths(v, flat, path + (i,))
                for i, v in enumerate(specs)]
    return flat[path]


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: carry the bits exactly
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Tree, cfg: ArchConfig, device="cpu") -> Tree:
    """The reference's parameter tree (leaves as numpy arrays, segments
    stacked on a leading ``layers`` axis, ``repro/models/params.py:196``)
    as the port's per-layer tree, values and dtypes unchanged: segment by
    segment, repeat by repeat, the cycle's kinds in order (the order of
    :func:`layer_kinds`)."""
    layers: List[Tree] = []
    for si, (n_rep, cycle) in enumerate(cfg.pattern_layers()):
        seg = tree["segments"][si]
        for i in range(n_rep):
            for j, kind in enumerate(cycle):
                layers.append(map_tree(lambda a: _to_torch(a[i], device),
                                       seg[f"{j}:{kind}"]))
    out: Tree = {"layers": layers}
    for name in ("embed", "final_norm", "lm_head"):
        if name in tree:
            out[name] = map_tree(lambda a: _to_torch(a, device), tree[name])
    return out


def opt_state_from_jax(state: Tree, cfg: ArchConfig, device="cpu") -> Tree:
    """The reference's AdamW state (``mu``, ``nu`` as parameter trees with
    numpy leaves, ``count`` an int32 scalar) in the port's layout, values
    and dtypes unchanged."""
    return {"mu": params_from_jax(state["mu"], cfg, device),
            "nu": params_from_jax(state["nu"], cfg, device),
            "count": _to_torch(np.asarray(state["count"], np.int32), device)}


def shard_params(params: Tree, specs: Tree, mesh, pcfg) -> Tree:
    """Each leaf as a DTensor on ``mesh``, placed by the reference's
    ``param_shardings`` (``parallel/sharding.py``). Every rank must hold
    the same weights (made from one generator seed on every rank): each
    keeps its own slice of them, and no rank sends any."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.sharding import param_shardings
    where = dict(leaves(param_shardings(specs, mesh, pcfg)))
    return map_tree_paths(params, {
        path: distribute_tensor(t, *where[path], src_data_rank=None)
        for path, t in leaves(params)})


def trainable(params: Tree) -> Tree:
    """The tree as leaf views that require grad: they share the weights'
    storage, so the optimizer's in-place update is what the next step's
    views see, and the caller's tensors stay free of autograd state."""
    return map_tree(lambda t: t.detach().requires_grad_(True), params)
