"""The yardstick's family-blind arithmetic: the H100's published peaks,
the least time of one product, and a closed-loop batch's shape. The work a
family's step needs is counted in its module (``families/<family>.py``),
from shapes alone.

Nothing here reads a block size, a split count or anything the program
chose: a later change that replaces a kernel leaves these counts as they
are. Operations are multiply-adds counted as two; bytes count each input
read once and each output written once, in the model's dtype (bf16, two
bytes), whatever a kernel reads again.
"""
from __future__ import annotations

from dataclasses import dataclass

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def product_bound_s(rows: int, k: int, n: int) -> float:
    """Least time of a (rows, k) x (k, n) bf16 product: its operations at
    the bf16 peak or its bytes (both operands and the result once) at the
    HBM rate, whichever is longer."""
    flops = 2 * rows * k * n
    nbytes = BF16_BYTES * (rows * k + k * n + rows * n)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


@dataclass(frozen=True)
class Batch:
    """One closed-loop batch: ``batch`` prompts of ``prompt`` tokens, each
    answered with ``output`` tokens (the prefill gives the first, each of
    ``output - 1`` decode steps one more)."""

    batch: int
    prompt: int
    output: int

    def decode_contexts(self) -> range:
        """The valid cache slots a row attends over at each decode step:
        the prompt and the tokens fed so far, the step's own included."""
        return range(self.prompt + 1, self.prompt + self.output)


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal prefill of ``s`` positions scores."""
    return s * (s + 1) // 2
