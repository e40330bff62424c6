"""Meta-tensor inputs for every (arch × shape) dry-run cell.

Port of ``repro/launch/specs.py``: ``batch_specs``,
``abstract_params_sharded``, ``abstract_cache_sharded`` and
``input_specs``. A ``jax.ShapeDtypeStruct`` becomes a tensor on the
``meta`` device: a shape and a dtype and no storage, which the step
functions of ``models/stepfn.py`` run on as they run on the card
(``launch/dryrun.py`` traces them). On a mesh (a ``DeviceMesh``, the
dry-run's ``launch/mesh.make_production_mesh``) each leaf is a meta
``DTensor`` placed as ``runtime/train.TrainLoop(mesh=...)`` places a real
one, through the same code: parameters by ``params.shard_params`` (the
reference's ``param_shardings``), the optimizer state by the optimizer's
own ``init`` on them, the batch by ``stepfn.place_batch`` and the cache
by ``model.place_cache`` (``resolve_spec`` on ``act_rules``). Token ids, labels and the
decode position are int64, the index type the port's entry points feed
(the reference's are int32), and the train step's ``step`` is a Python
int, as ``runtime/train.TrainLoop`` passes it (the reference traces an
int32 scalar).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.arch import ArchConfig, ShapeConfig
from repro_torch.models.model import abstract_cache, place_cache
from repro_torch.models.params import (DTYPES, abstract_params, model_specs,
                                       shard_params)
from repro_torch.models.stepfn import place_batch
from repro_torch.parallel.sharding import ParallelConfig, ShardCtx


def _px(mesh, pcfg: Optional[ParallelConfig]) -> ShardCtx:
    return ShardCtx(mesh=mesh, pcfg=pcfg or ParallelConfig())


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                pcfg: Optional[ParallelConfig] = None) -> Dict[str, Any]:
    """The step's batch: token ids (B,S) (S = 1 in decode), or for the
    ``embeddings`` frontend frame embeddings (B,S,d), the labels of a train
    step and, outside decode, the cross-attention condition."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    dt = DTYPES[cfg.dtype]
    out: Dict[str, Any] = {}
    if cfg.frontend == "embeddings":
        out["frame_embeddings"] = _meta((B, S, cfg.d_model), dt)
        if shape.kind == "train":
            out["labels"] = _meta((B, S), torch.long)
        if cfg.cross_attention and shape.kind != "decode":
            out["cond"] = _meta((B, cfg.cross_seq, cfg.d_model), dt)
    else:
        out["tokens"] = _meta((B, S), torch.long)
    return place_batch(out, _px(mesh, pcfg))


def abstract_params_sharded(cfg: ArchConfig, mesh=None,
                            pcfg: Optional[ParallelConfig] = None):
    params = abstract_params(cfg)
    if mesh is None:
        return params
    return shard_params(params, model_specs(cfg), mesh, _px(mesh, pcfg).pcfg)


def abstract_cache_sharded(cfg: ArchConfig, batch: int, cap: int, mesh=None,
                           pcfg: Optional[ParallelConfig] = None):
    return place_cache(abstract_cache(cfg, batch, cap), cfg, _px(mesh, pcfg))


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                pcfg: Optional[ParallelConfig] = None,
                optimizer=None) -> Dict[str, Any]:
    """Everything the step function of this cell takes, as meta tensors:
    train (params, opt_state, batch, step), prefill (params, batch),
    decode (params, cache of ``seq_len`` positions, batch, pos). On a mesh
    the decode position is a plain tensor, as every rank builds it."""
    params = abstract_params_sharded(cfg, mesh, pcfg)
    batch = batch_specs(cfg, shape, mesh, pcfg)
    if shape.kind == "train":
        if optimizer is None:
            raise ValueError("a train cell's specs need the optimizer")
        return {"params": params, "opt_state": optimizer.abstract_state(params),
                "batch": batch, "step": 0}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch}
    cache = abstract_cache_sharded(cfg, shape.global_batch, shape.seq_len,
                                   mesh, pcfg)
    return {"params": params, "cache": cache, "batch": batch,
            "pos": _meta((), torch.long)}
