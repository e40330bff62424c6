"""Architecture configuration dataclasses (copy of ``repro/configs/arch.py``).

Every assigned architecture is expressed as an ``ArchConfig``: a declarative
description of a block-pattern decoder. The model code in
``repro_torch.models`` consumes only this dataclass. The dataclasses are
plain data and are copied whole; the port's model code runs every family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # "softmax" (classic top-k softmax) or "sigmoid" (DeepSeek-V3 style
    # sigmoid scores with normalized top-k weights).
    router_score: str = "softmax"


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (Griffin / RecurrentGemma)."""

    lru_width: int = 0          # 0 -> d_model
    conv_width: int = 4
    c_exponent: float = 8.0     # the fixed `c` in a_t = a^(c * r_t)


@dataclass(frozen=True)
class XLSTMConfig:
    """mLSTM / sLSTM blocks (xLSTM)."""

    num_heads: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    mlstm_chunk: int = 64       # chunkwise-parallel chunk length for training
    qk_dim_factor: float = 0.5  # d_qk = qk_dim_factor * d_inner (per head after split)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None    # None -> d_model // num_heads
    mlp_act: str = "swiglu"           # swiglu | geglu
    attention: str = "gqa"            # gqa | mla
    # One cycle of the layer pattern; repeated over the depth.
    # kinds: "attn", "rglru", "mlstm", "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    # Layers whose MLP is dense even when `moe` is set (e.g. DeepSeek first 3).
    moe_dense_first: int = 0
    dense_d_ff: Optional[int] = None  # d_ff of those dense layers (None -> d_ff)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    local_window: Optional[int] = None  # local attention window (hybrid archs)
    qk_norm: bool = False
    tie_embeddings: bool = False
    scale_embeddings: bool = False    # gemma-style sqrt(d) embed scaling
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # Modality frontend: None -> token ids; "embeddings" -> input_specs()
    # provides precomputed frame/patch embeddings (B, S, d_model).
    frontend: Optional[str] = None
    cross_attention: bool = False     # musicgen text-conditioning cross-attn
    cross_seq: int = 64               # stub text-conditioning length
    mtp: bool = False                 # DeepSeek multi-token-prediction head
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def pattern_layers(self) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
        """Decompose depth into homogeneous scan segments.

        Returns ``((n_repeat, cycle), ...)`` where each segment repeats its
        cycle of layer kinds ``n_repeat`` times; sum(n * len(cycle)) plus the
        dense-MoE prefix equals num_layers. Segments keep the lowered HLO
        small: each segment is one ``lax.scan``.
        """
        segs = []
        remaining = self.num_layers
        if self.moe is not None and self.moe_dense_first > 0:
            segs.append((self.moe_dense_first, ("attn_dense",)))
            remaining -= self.moe_dense_first
        cyc = self.block_pattern
        full = remaining // len(cyc)
        rem = remaining - full * len(cyc)
        if full > 0:
            segs.append((full, cyc))
        if rem > 0:
            segs.append((1, cyc[:rem]))
        return tuple(segs)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND math."""
        from repro_torch.models.params import count_params  # local, no cycle

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params

        return count_params(self, active_only=True)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(arch: "ArchConfig", shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic context handling (see DESIGN.md §4)."""
    if shape.name == "long_500k" and arch.family not in ("hybrid", "ssm"):
        return False, (
            "long_500k skipped: pure full-attention arch would need a 524288-token "
            "KV cache with no sub-quadratic mechanism (DESIGN.md §4)"
        )
    return True, ""
