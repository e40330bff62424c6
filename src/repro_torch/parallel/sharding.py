"""Logical-axis sharding rules, kernel-dispatch, serving and training knobs.

Port of ``repro/parallel/sharding.py``. ``ParallelConfig`` holds every
field of the reference's, with its defaults: ``param_rules`` and
``act_rules`` (the logical-axis rule tables), ``remat``, ``microbatches``,
``attn_block_q``, ``attn_block_kv``, ``attn_q_chunks``,
``capacity_factor``, ``logits_chunk``, ``opt_moment_dtype``,
``grad_compression`` and ``grad_compression_topk``, ``flash_threshold``,
``mlstm_chunk``, ``mlstm_bf16_streams``, ``moe_combine`` and ``kernel``.
``resolve_spec`` is the reference's pure rule resolution: it takes any
object with ``axis_names`` and ``devices.shape`` and returns a tuple where
the reference returns a ``PartitionSpec``. ``flash_vmem_bytes`` and
``attn_tile_occupancy`` are the reference's column arithmetic for the hard
sharding grids (``core/tuning_targets.sharding_space(hard=True)``); they
model the TPU's VMEM and cores, as the reference's do.

One card has no mesh, so on it the rule tables, ``attn_block_q``,
``moe_combine`` (which only picks the mesh constraint around the expert
outputs: an all-to-all reshard or none) and gradient compression (over
the pod axis; ``parallel/compression.py`` has the functions) change no
shape or value, and the dry-run (``launch/dryrun.py``) records them as
such. ``param_shardings``, ``act_sharding`` and ``ShardCtx`` are cut: they
build ``NamedSharding`` objects of a JAX mesh, which the port has no
counterpart of; ``constrain`` is cut too: off a mesh it is the identity
(the reference's branch for no mesh), and the port's model code has no
constraint to place. ``scan_layers`` is cut too: a compile knob with no eager
counterpart (the port loops over layers). The kernels' resource models
live in ``kernels/ops.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]

# Parameter logical axes. "embed" on weights is the ZeRO-3/FSDP axis.
DEFAULT_PARAM_RULES: Dict[str, Axis] = {
    "vocab": "model",
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "lora": None,
    "layers": None,
}

# Activation logical axes.
DEFAULT_ACT_RULES: Dict[str, Axis] = {
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_experts": "model",
    "act_group": "data",       # MoE dispatch groups
    "act_cache_seq": None,
    "act_vocab": "model",
}


@dataclass(frozen=True)
class KernelConfig:
    """Tuned kernel dispatch knobs.

    ``ParallelConfig.kernel is None`` (the default) keeps every model path on
    the plain PyTorch implementations. Block sizes come from the kernel
    tuning cells in ``repro_torch.kernels.tuning``. The defaults are blocks
    the CUDA kernels run at every head dim they take (the reference's 512 /
    512 prefill default needs 256 KB of shared memory at head dim 256), and
    the kernel's fused combine for the cross-split merge (the reference
    defaults to its tensor-op merge). The reference's ``interpret`` field
    has no counterpart: a CPU tensor takes the plain version, a CUDA tensor
    launches the kernel.
    """

    use_flash: bool = False          # flash attention on prefill
    flash_block_q: int = 128
    flash_block_kv: int = 128
    use_decode: bool = False         # split-KV flash decode per token
    decode_block_kv: int = 512
    decode_num_splits: int = 1
    # cross-split merge: "kernel" = fused into the split kernel's launch
    # (the reference's combine kernel), "torch" = tensor ops
    # (the reference's "jax" strategy); a tuning dimension of the decode cell
    decode_combine: str = "kernel"

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution + performance knobs, the reference's fields and
    defaults (``scan_layers`` cut). Every field is BO-tunable."""

    param_rules: Mapping[str, Axis] = field(
        default_factory=lambda: dict(DEFAULT_PARAM_RULES))
    act_rules: Mapping[str, Axis] = field(
        default_factory=lambda: dict(DEFAULT_ACT_RULES))
    remat: str = "none"              # none | dots | full
    microbatches: int = 1
    attn_block_q: int = 1024         # flash q block (read by no model path)
    attn_block_kv: int = 1024        # blockwise attention's kv block
    attn_q_chunks: int = 1           # causal q-chunking (1 = off)
    capacity_factor: Optional[float] = None  # override ArchConfig.moe
    logits_chunk: int = 1024         # chunked-softmax xent chunk (0 = unchunked)
    opt_moment_dtype: str = "float32"
    grad_compression: str = "none"   # none | topk | int8 (pod axis)
    grad_compression_topk: float = 0.05
    flash_threshold: int = 2048      # blockwise attention when seq >= this
    # chunkwise-parallel mLSTM chunk length (0 = per-step scan)
    mlstm_chunk: int = 0
    mlstm_bf16_streams: bool = False  # bf16 intra-chunk streams (state fp32)
    moe_combine: str = "gather"       # gather | a2a (a mesh reshard)
    kernel: Optional[KernelConfig] = None

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 rules: Mapping[str, Axis], mesh) -> Tuple:
    """Map logical axes to a partition spec, dropping invalid assignments:
    a mesh axis the mesh lacks, one another dimension of the tensor took,
    or one that does not divide the dimension. ``mesh`` is anything with
    ``axis_names`` and ``devices.shape``; the result is the reference's
    ``PartitionSpec`` entries as a tuple (trailing ``None`` dropped)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        assign: Tuple[str, ...] = ()
        cand = rules.get(name) if name is not None else None
        if cand is not None:
            cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
            picked = []
            prod = 1
            for ax in cand_t:
                if ax not in sizes or ax in used:
                    continue
                if dim % (prod * sizes[ax]) != 0:
                    continue
                picked.append(ax)
                prod *= sizes[ax]
            assign = tuple(picked)
            used.update(assign)
        if len(assign) == 0:
            out.append(None)
        elif len(assign) == 1:
            out.append(assign[0])
        else:
            out.append(assign)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------------------
# kernel-residency arithmetic for HARD-constrained tuning grids
# ---------------------------------------------------------------------------
# Pure column arithmetic (ints or numpy arrays), the reference's, so the
# same expressions work as vectorized ``VectorConstraint`` predicates over a
# GenerativeSpace's candidate columns. They model the TPU (v5e) the
# reference's grids were built for, not the card: the hard space's
# fingerprint is the reference's only if its predicates are.

#: per-core on-chip vector memory (v5e)
VMEM_BYTES = 16 * 2 ** 20


def flash_vmem_bytes(block_q, block_kv, head_dim=128, *,
                     dtype_bytes=2, acc_bytes=4):
    """Per-grid-step VMEM residency of the blockwise flash-attention kernel:
    the bf16 Q/K/V tiles, the f32 logits tile, the f32 output accumulator,
    and the running max/denominator stats. Vectorizes over numpy columns."""
    q_tile = block_q * head_dim * dtype_bytes
    kv_tiles = 2 * block_kv * head_dim * dtype_bytes      # K and V
    logits = block_q * block_kv * acc_bytes
    acc = block_q * head_dim * acc_bytes
    stats = 2 * block_q * acc_bytes                       # rowmax + denom
    return q_tile + kv_tiles + logits + acc + stats


def attn_tile_occupancy(seq_len, block_q, block_kv, *, cores=8):
    """Grid steps per core of a (seq/block_q) x (seq/block_kv) attention
    tiling. Below 1.0 some cores idle every wave — the occupancy floor the
    hard grids enforce. Ceil-divides, so oversized blocks count as one."""
    q_steps = -(-seq_len // block_q)
    kv_steps = -(-seq_len // block_kv)
    return (q_steps * kv_steps) / cores
