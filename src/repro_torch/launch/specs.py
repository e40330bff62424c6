"""Meta-tensor inputs for every (arch × shape) dry-run cell.

Port of ``repro/launch/specs.py``: ``batch_specs``,
``abstract_params_sharded``, ``abstract_cache_sharded`` and
``input_specs``. A ``jax.ShapeDtypeStruct`` becomes a tensor on the
``meta`` device: a shape and a dtype and no storage, which the step
functions of ``models/stepfn.py`` run on as they run on the card
(``launch/dryrun.py`` traces them). ``mesh=None`` is the only branch with
a meaning on one card; another mesh raises. Token ids, labels and the
decode position are int64, the index type the port's entry points feed
(the reference's are int32), and the train step's ``step`` is a Python
int, as ``runtime/train.TrainLoop`` passes it (the reference traces an
int32 scalar).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.arch import ArchConfig, ShapeConfig
from repro_torch.models.model import abstract_cache
from repro_torch.models.params import DTYPES, abstract_params
from repro_torch.parallel.sharding import ParallelConfig


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("the dry-run plans one card: its specs take "
                         "mesh=None only")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                pcfg: Optional[ParallelConfig] = None) -> Dict[str, Any]:
    """The step's batch: token ids (B,S) (S = 1 in decode), or for the
    ``embeddings`` frontend frame embeddings (B,S,d), the labels of a train
    step and, outside decode, the cross-attention condition."""
    _no_mesh(mesh)
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
    return out


def abstract_params_sharded(cfg: ArchConfig, mesh=None,
                            pcfg: Optional[ParallelConfig] = None):
    _no_mesh(mesh)
    return abstract_params(cfg)


def abstract_cache_sharded(cfg: ArchConfig, batch: int, cap: int, mesh=None,
                           pcfg: Optional[ParallelConfig] = None):
    _no_mesh(mesh)
    return abstract_cache(cfg, batch, cap)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                pcfg: Optional[ParallelConfig] = None,
                optimizer=None) -> Dict[str, Any]:
    """Everything the step function of this cell takes, as meta tensors:
    train (params, opt_state, batch, step), prefill (params, batch),
    decode (params, cache of ``seq_len`` positions, batch, pos)."""
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
