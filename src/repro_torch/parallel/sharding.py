"""Kernel-dispatch and serving knobs.

Port of ``repro/parallel/sharding.py``, cut to ``KernelConfig`` and the
field of ``ParallelConfig`` that serving reads (``kernel``). One card has
no mesh, so the logical-axis rules, ``resolve_spec``, ``constrain`` and the
VMEM residency arithmetic are cut; the kernels' resource models live in
``kernels/ops.py``. ``flash_threshold`` is cut with the blockwise
``lax.scan`` attention it selects, which is not ported: a prefill the flash
kernel does not take runs the materialized-scores attention.
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
    """The serving field of the reference's ParallelConfig."""

    kernel: Optional[KernelConfig] = None

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)
