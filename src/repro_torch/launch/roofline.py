"""Hopper (NVIDIA H100) resource limits and peak rates for the port.

The kernels' resource models (``kernels.ops.*_valid``) check
configs against the per-block limits below, in place of the reference
package's TPU VMEM budget, which has no counterpart here. The peak rates
give a kernel's bound: the least time the card could take for its work.
"""
from __future__ import annotations

from typing import Tuple

#: Shared memory one block may use, opt-in above 48 KB as dynamic shared
#: memory (CUDA C++ Programming Guide, compute capability 9.0 table: 227 KB).
SMEM_PER_BLOCK = 232_448

#: Threads per block (CUDA C++ Programming Guide, compute capability 9.0).
MAX_THREADS_PER_BLOCK = 1024

#: 32-bit registers per SM, the pool a block's threads share (same table).
REGS_PER_SM = 65_536

#: Registers one thread may address (same table).
MAX_REGS_PER_THREAD = 255

#: fp32 peak outside the tensor cores, H100 SXM (NVIDIA H100 data sheet:
#: 67 TFLOP/s at the 700 W limit).
FP32_PEAK_FLOPS = 67e12

#: bf16 dense peak of the tensor cores, H100 SXM (NVIDIA H100 data sheet:
#: 989 TFLOP/s without sparsity at the 700 W limit). A bf16 product's least
#: time is taken against it, whether or not the kernel uses the tensor cores.
BF16_TC_PEAK_FLOPS = 989e12

#: TF32 dense peak of the tensor cores, H100 SXM (NVIDIA H100 data sheet:
#: 495 TFLOP/s without sparsity at the 700 W limit). A product computed as
#: 3xTF32 (fp32 accuracy from three TF32 products) does three times its
#: flops at this rate.
TF32_TC_PEAK_FLOPS = 495e12

#: HBM3 bandwidth, H100 SXM 80 GB (NVIDIA H100 data sheet: 3.35 TB/s).
HBM_BW = 3.35e12

#: The card the peaks above are for, as ``torch.cuda.get_device_name`` and
#: ``nvidia-smi`` name it.
CARD = "NVIDIA H100 80GB HBM3"


def peaks_for(card_name: str) -> Tuple[float, float]:
    """(fp32 FLOP/s, bytes/s) of the named card; ``ValueError`` for another
    card, rather than a bound against the wrong one."""
    if card_name != CARD:
        raise ValueError(f"no published peaks recorded for card "
                         f"{card_name!r} (only {CARD!r})")
    return FP32_PEAK_FLOPS, HBM_BW


def bound_ms(flops: float, nbytes: float, card_name: str,
             dtype: str = "float32") -> Tuple[float, str]:
    """Least time (ms) for ``flops`` operations of type ``dtype`` (fp32 on
    the CUDA cores, bf16 on the tensor cores, or "tf32x3": fp32 products as
    three TF32 products each on the tensor cores) moving ``nbytes`` of
    device memory on the named card, and which of the two bounds it."""
    peak_flops, bw = peaks_for(card_name)
    if dtype == "bfloat16":
        peak_flops = BF16_TC_PEAK_FLOPS
    elif dtype == "tf32x3":
        peak_flops = TF32_TC_PEAK_FLOPS / 3
    elif dtype != "float32":
        raise ValueError(f"no peak recorded for {dtype!r} operations")
    t_ops, t_bytes = flops / peak_flops, nbytes / bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
