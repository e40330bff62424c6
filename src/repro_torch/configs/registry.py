"""Registry of the ported architectures + reduced smoke variants.

Port of ``repro/configs/registry.py``, holding gemma-2b only: the port's
model code runs dense attention so far. The reference's other nine configs
wait for their family's slice, and ``get_arch`` names that slice.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import gemma_2b
from repro_torch.configs.arch import ArchConfig

ARCHS: Dict[str, ArchConfig] = {gemma_2b.CONFIG.name: gemma_2b.CONFIG}

#: Reference configs not yet ported, and the slice each waits for.
PENDING: Dict[str, str] = {
    "deepseek-v3-671b": "MLA + MoE",
    "qwen3-moe-30b-a3b": "MoE",
    "recurrentgemma-9b": "windowed attention + RG-LRU",
    "xlstm-1.3b": "mLSTM/sLSTM",
    "musicgen-large": "cross-attention + embeddings frontend",
    "chameleon-34b": "qk-norm dense",
    "mistral-large-123b": "other dense configs",
    "internlm2-1.8b": "other dense configs",
    "stablelm-3b": "other dense configs",
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
    the reference's dense reduction (2 layers, tiny widths, same pattern
    and attention type)."""
    cfg = get_arch(name)
    return cfg.replace(
        name=cfg.name + "-smoke",
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        dense_d_ff=96 if cfg.dense_d_ff else None,
        vocab_size=256,
        cross_seq=8,
        num_layers=2,
    )
