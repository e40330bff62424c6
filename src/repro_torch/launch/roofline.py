"""Hopper (NVIDIA H100) resource limits, peak rates and the roofline.

The kernels' resource models (``kernels.ops.*_valid``) check
configs against the per-block limits below, in place of the reference
package's TPU VMEM budget, which has no counterpart here. The peak rates
give a kernel's bound: the least time the card could take for its work.

``Roofline`` and ``model_flops_for`` are ports of the reference's
(``repro/launch/roofline.py``): the compute term takes the peak of the
config's dtype (bf16 on the tensor cores, fp32 on the CUDA cores: the
port runs with TF32 off), the memory term the card's HBM rate, and on a
mesh of cards the collective term the interconnect's two tiers, NVLink
inside an 8-card node in place of the reference's ICI and InfiniBand
between nodes in place of its DCN (``links_for``). ``to_dict`` has the
reference's keys, so the dry-run's records read as the reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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

#: NVLink 4 rate of one card, one direction: 450 GB/s of the 900 GB/s
#: both directions together (NVIDIA H100 SXM data sheet; 18 links into the
#: node's NVSwitch fabric). A collective's bytes are the operand bytes a
#: card contributes (the reference's count); they leave the card on its
#: egress while the peers' arrive on its ingress at the same time, so one
#: direction's rate is what a ring or a switch-reduced collective runs at.
NVLINK_BW = 450e9

#: InfiniBand rate of one card between nodes, one direction: one
#: ConnectX-7 NDR port of 400 Gb/s a card (NVIDIA DGX H100 system: eight
#: such ports, one a card), 50 GB/s each way; one direction for the reason
#: given at ``NVLINK_BW``.
IB_BW = 400e9 / 8

#: cards a node joins over NVLink (DGX H100 / HGX H100 8-GPU): ranks
#: ``8k .. 8k+7`` share node k, so a collective whose group holds ranks of
#: two nodes crosses InfiniBand
NODE_CARDS = 8

#: The card the peaks above are for, as ``torch.cuda.get_device_name`` and
#: ``nvidia-smi`` name it.
CARD = "NVIDIA H100 80GB HBM3"


#: Device memory of the card, bytes, as
#: ``torch.cuda.get_device_properties(0).total_memory`` reports it (81,079
#: MiB, read on an H100 80GB HBM3 with torch 2.11 and CUDA 12.8);
#: ``chip_smoke.py`` holds it against the card's own report. The dry-run
#: judges a cell against it when no card is present.
CARD_MEMORY = {CARD: 85_017_493_504}


def card_memory(card_name: str) -> int:
    """Device memory of the named card; ``ValueError`` for another."""
    if card_name not in CARD_MEMORY:
        raise ValueError(f"no memory size recorded for card {card_name!r} "
                         f"(only {sorted(CARD_MEMORY)})")
    return CARD_MEMORY[card_name]


def peaks_for(card_name: str) -> Tuple[float, float]:
    """(fp32 FLOP/s, bytes/s) of the named card; ``ValueError`` for another
    card, rather than a bound against the wrong one."""
    if card_name != CARD:
        raise ValueError(f"no published peaks recorded for card "
                         f"{card_name!r} (only {CARD!r})")
    return FP32_PEAK_FLOPS, HBM_BW


def links_for(card_name: str) -> Tuple[float, float]:
    """(NVLink bytes/s, InfiniBand bytes/s) of one card of the named kind,
    one direction each; ``ValueError`` for another card."""
    peaks_for(card_name)
    return NVLINK_BW, IB_BW


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


def dtype_peak_flops(dtype: str, card_name: str = CARD) -> float:
    """Peak FLOP/s of the named card for a model of ``dtype``: bf16 on the
    tensor cores, fp32 on the CUDA cores (TF32 is off in the port)."""
    fp32, _ = peaks_for(card_name)
    if dtype == "bfloat16":
        return BF16_TC_PEAK_FLOPS
    if dtype == "float32":
        return fp32
    raise ValueError(f"no peak recorded for {dtype!r} operations")


@dataclass
class Roofline:
    """Roofline terms of one step on ``chips`` cards, each count the sum
    over the cards (the reference's: a card's count x chips):
    compute = flops / (chips x peak_flops), memory = hbm_bytes / (chips x
    hbm_bw), collective = (coll_bytes - dcn_bytes) / (chips x ici_bw) +
    dcn_bytes / (chips x dcn_bw). On a mesh of H100s the reference's ICI
    tier is NVLink inside a node and its DCN tier InfiniBand between nodes:
    ``dcn_bytes`` are the collective bytes whose group spans nodes. On one
    card collective bytes raise rather than be timed against an
    interconnect the card has none of."""

    flops: float
    hbm_bytes: float
    coll_bytes: float = 0.0
    dcn_bytes: float = 0.0
    chips: int = 1
    model_flops: float = 0.0
    peak_flops: float = BF16_TC_PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = NVLINK_BW
    dcn_bw: float = IB_BW

    def __post_init__(self):
        if self.chips < 1:
            raise ValueError(f"chips must be at least 1, got {self.chips}")
        if self.chips == 1 and (self.coll_bytes or self.dcn_bytes):
            raise ValueError("one card has no interconnect: no collective "
                             "bytes at chips 1")
        if not 0 <= self.dcn_bytes <= self.coll_bytes:
            raise ValueError("dcn_bytes must lie in [0, coll_bytes]")

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        ici = (self.coll_bytes - self.dcn_bytes) / (self.chips * self.ici_bw)
        return ici + self.dcn_bytes / (self.chips * self.dcn_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """The roofline step time: the largest term (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops and self.flops:
            return self.model_flops / self.flops
        return None

    @property
    def roofline_fraction(self) -> Optional[float]:
        """MODEL_FLOPS-based MFU bound at the roofline step time."""
        if not self.model_flops:
            return None
        t = self.step_time
        if t <= 0:
            return None
        return self.model_flops / (t * self.chips * self.peak_flops)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "dcn_bytes": self.dcn_bytes,
            "chips": self.chips, "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "step_time": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N·D for inference."""
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens
