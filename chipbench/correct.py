"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed, goes through the
reference (its family's ``reference``, such as ``reference/decoder.py``):
each prompt with the tokens the
program served for it, read whole. At each position that chose a served
token, the gap is the reference's best logit less the reference's logit of
that token: 0 where the program chose the reference's token, small where
rounding made it choose a near tie, large where it served a token the
model would not. The number compared is the widest gap over the sample;
the cell's file (``cells/<cell>.json``) holds its limit and the readings
the limit was set from. The served tokens are greedy, so the gap is
defined at every position.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from chipbench.weights import seeds


def sample_requests(n_batches: int, batch: int, n: int, seed: int
                    ) -> List[Tuple[int, int]]:
    """``n`` of the finished requests as (batch, row), drawn from the seed's
    own stream; all of them where no more finished. The j-th comes from
    the j-th of ``n`` equal slices of a batch's rows, in a batch drawn at
    random, so that every part of a batch is compared however few are
    drawn: a fault in the second half of every batch fails with two.
    Every request of a cell has the same length, so any is among the
    longest."""
    if n_batches * batch <= n:
        return [(b, r) for b in range(n_batches) for r in range(batch)]
    rng = np.random.default_rng(seeds(seed)["sample"])
    pick = set()
    for j in range(n):
        lo = j * batch // n
        hi = max(lo + 1, (j + 1) * batch // n)
        while True:                 # a slice holds more requests than j's
            p = (int(rng.integers(n_batches)), int(rng.integers(lo, hi)))
            if p not in pick:
                break
        pick.add(p)
    return sorted(pick)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(R, n) gaps of ``tokens`` (R, n) under ``ref_logits`` (R, n, V)."""
    chosen = torch.gather(ref_logits, -1, tokens[..., None])[..., 0]
    return ref_logits.amax(-1) - chosen


def compare(cell, weights: Dict, finished: List[Tuple], n_sample: int,
            seed: int, *, control: bool = False) -> Dict[str, float]:
    """The widest gap over the sample (``max_gap``) and the number of
    served tokens it covers, under the reference of the cell's family over
    its configuration (``cell`` a ``harness.Cell``). ``finished`` holds
    (prompts (B, S), served (B, n)) of each finished batch, in order.
    ``control``: also the widest gap of the tokens that the fp8 reference
    puts first at the same positions (``control_gap``)."""
    batch = finished[0][0].shape[0] if finished else 0
    pick = sample_requests(len(finished), batch, n_sample, seed)
    if not pick:
        return {"max_gap": float("inf"), "tokens": 0}
    prompts = torch.stack([finished[b][0][r] for b, r in pick])
    served = torch.stack([finished[b][1][r] for b, r in pick])
    family, c = cell.family, cell.config
    ref = family.reference(c, weights).served_logits(prompts, served)
    out = {"max_gap": float(gaps(ref, served).max()),
           "tokens": int(served.numel())}
    if control:
        low = family.reference(c, weights, fp8=True).served_logits(prompts,
                                                                   served)
        out["control_gap"] = float(gaps(ref, low.argmax(-1)).max())
        out["control_agree"] = float(
            (low.argmax(-1) == ref.argmax(-1)).float().mean())
    return out
