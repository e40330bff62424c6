"""Registry of the ported architectures + reduced smoke variants.

Port of ``repro/configs/registry.py``, holding the families the port's
model code runs: the dense decoders (gemma-2b, internlm2-1.8b,
stablelm-3b, mistral-large-123b, chameleon-34b) and MoE
(qwen3-moe-30b-a3b). The reference's other four configs wait for their
family's slice, and ``get_arch`` names that slice. ``smoke_config`` is the
reference's, field for field, with the branches of the families ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (chameleon_34b, gemma_2b, internlm2_1_8b,
                                 mistral_large_123b, qwen3_moe_30b_a3b,
                                 stablelm_3b)
from repro_torch.configs.arch import ArchConfig

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_moe_30b_a3b, gemma_2b, mistral_large_123b,
              internlm2_1_8b, stablelm_3b, chameleon_34b)
}

#: Reference configs not yet ported, and the slice each waits for.
PENDING: Dict[str, str] = {
    "deepseek-v3-671b": "MLA + MoE",
    "recurrentgemma-9b": "windowed attention + RG-LRU",
    "xlstm-1.3b": "mLSTM/sLSTM",
    "musicgen-large": "cross-attention + embeddings frontend",
}


def get_arch(name: str) -> ArchConfig:
    if name in PENDING:
        raise KeyError(f"arch {name!r} is not ported yet: it waits for the "
                       f"{PENDING[name]} slice; ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """A reduced config of the same family, runnable on CPU in seconds:
    the reference's reduction (tiny widths, same pattern, attention type
    and MoE-ness; 2 layers, or 3 for an MoE config with dense first
    layers; 8 experts, top 2, d_expert 96)."""
    cfg = get_arch(name)
    kw = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        dense_d_ff=96 if cfg.dense_d_ff else None,
        vocab_size=256,
        cross_seq=8,
    )
    if cfg.moe is not None:
        kw["num_layers"] = 3 if cfg.moe_dense_first else 2
        kw["moe_dense_first"] = 1 if cfg.moe_dense_first else 0
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_expert=96,
        )
    else:
        kw["num_layers"] = 2
    return cfg.replace(**kw)
