"""Registry of the architectures + reduced smoke variants.

Port of ``repro/configs/registry.py``: the reference's ten configs, each a
copy in this package, and ``smoke_config``, the reference's field for
field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (chameleon_34b, deepseek_v3_671b, gemma_2b,
                                 internlm2_1_8b, mistral_large_123b,
                                 musicgen_large, qwen3_moe_30b_a3b,
                                 recurrentgemma_9b, stablelm_3b, xlstm_1_3b)
from repro_torch.configs.arch import ArchConfig, MLAConfig

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (deepseek_v3_671b, qwen3_moe_30b_a3b, recurrentgemma_9b,
              gemma_2b, mistral_large_123b, internlm2_1_8b, stablelm_3b,
              musicgen_large, chameleon_34b, xlstm_1_3b)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """A reduced config of the same family, runnable on CPU in seconds:
    the reference's reduction (tiny widths, same pattern, attention type
    and MoE-ness; about one cycle of the pattern and its remainder; 8
    experts, top 2, d_expert 96; small MLA ranks, an RG-LRU of width 64,
    two xLSTM heads, a window of 16)."""
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
    elif cfg.name.startswith("recurrentgemma"):
        kw["num_layers"] = 5  # (rglru, rglru, attn) + 2 remainder rglru
    elif cfg.name.startswith("xlstm"):
        kw["num_layers"] = 9  # one full 7:1 cycle + remainder
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, num_heads=2,
                                          mlstm_chunk=8)
    else:
        kw["num_layers"] = 2
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=64)
    if cfg.local_window is not None:
        kw["local_window"] = 16
    return cfg.replace(**kw)
