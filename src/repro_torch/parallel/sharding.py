"""Kernel-dispatch, serving and training knobs.

Port of ``repro/parallel/sharding.py``, cut to ``KernelConfig`` and the
fields of ``ParallelConfig`` that change the function or its memory on one
card: ``kernel`` (the dispatch serving reads), ``capacity_factor`` (the MoE
expert capacity, which sets which routed copies are dropped), the
blockwise attention's ``flash_threshold``, ``attn_block_kv`` and
``attn_q_chunks``, the mLSTM's ``mlstm_chunk`` and ``mlstm_bf16_streams``,
and the training fields ``remat`` (per-layer activation checkpointing),
``microbatches`` (gradient accumulation), ``logits_chunk`` (the chunked
cross-entropy) and ``opt_moment_dtype`` (the AdamW moments), with the
reference's defaults. One card has no mesh, so the logical-axis rules,
``resolve_spec``, ``constrain`` and the VMEM residency arithmetic are cut;
the kernels' resource models live in ``kernels/ops.py``. ``moe_combine`` is
cut too: in the reference it only picks the mesh constraint around the
expert outputs (an all-to-all reshard or none), which does not exist on one
card; a stored value is logged as not applicable (``store/resolve.py``), as
are ``grad_compression`` and ``grad_compression_topk`` (gradient compression
over the pod/DCN axis, which belongs to the distribution tooling).
``scan_layers`` is a compile knob with no eager counterpart (the port loops
over layers); ``attn_block_q`` is read by no model path of the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


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
    """The fields of the reference's ParallelConfig that apply on one
    card."""

    remat: str = "none"              # none | dots | full
    microbatches: int = 1
    attn_block_kv: int = 1024        # blockwise attention's kv block
    attn_q_chunks: int = 1           # causal q-chunking (1 = off)
    capacity_factor: Optional[float] = None  # override ArchConfig.moe
    logits_chunk: int = 1024         # chunked-softmax xent chunk (0 = unchunked)
    opt_moment_dtype: str = "float32"
    flash_threshold: int = 2048      # blockwise attention when seq >= this
    # chunkwise-parallel mLSTM chunk length (0 = per-step scan)
    mlstm_chunk: int = 0
    mlstm_bf16_streams: bool = False  # bf16 intra-chunk streams (state fp32)
    kernel: Optional[KernelConfig] = None

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)
