"""Initial sampling (paper §III-E): maximin Latin Hypercube + random repair.

LHS spreads the initial samples evenly; invalid/duplicate draws are replaced
by random valid samples so the initial sample is never skewed by invalidity.
"""
from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from repro_torch.core.searchspace import SearchSpace


def lhs_unit(n: int, d: int, rng: np.random.Generator,
             maximin_tries: int = 10) -> np.ndarray:
    """Maximin LHS in [0,1]^d: best of `maximin_tries` by min pairwise dist."""
    best, best_score = None, -1.0
    for _ in range(max(maximin_tries, 1)):
        pts = np.empty((n, d), np.float32)
        for j in range(d):
            perm = rng.permutation(n)
            pts[:, j] = (perm + rng.random(n)) / n
        if n > 1:
            diff = pts[:, None, :] - pts[None, :, :]
            d2 = np.sum(diff * diff, axis=-1)
            np.fill_diagonal(d2, np.inf)
            score = float(d2.min())
        else:
            score = 0.0
        if score > best_score:
            best, best_score = pts, score
    return best


#: Above this many configs, snapping falls back to one chunked batch pass
#: (duplicate snaps are dropped and repaired randomly, like invalid draws)
#: instead of n per-point full-space scans with exclusion. Set to the
#: pre-refactor max_enumeration cap: every space that was constructible
#: before the vectorized layer keeps its exact per-point path (and so its
#: seeded initial sample); only newly-reachable larger spaces batch-snap.
BATCH_SNAP_MIN_SIZE = 2_000_000


def initial_sample(space: SearchSpace, n: int, rng: np.random.Generator,
                   is_valid=None, maximin: bool = True) -> List[int]:
    """n distinct config indices: LHS-snapped, invalid repaired randomly."""
    pts = lhs_unit(n, space.dim, rng, maximin_tries=10 if maximin else 1)
    chosen: List[int] = []
    seen: Set[int] = set()
    if space.size > BATCH_SNAP_MIN_SIZE:
        for idx in space.nearest_indices(pts):
            idx = int(idx)
            if idx in seen or (is_valid is not None and not is_valid(idx)):
                continue
            seen.add(idx)
            chosen.append(idx)
    else:
        for row in pts:
            idx = space.nearest_index(row, exclude=seen)
            if idx in seen or (is_valid is not None and not is_valid(idx)):
                idx = None
            if idx is not None:
                seen.add(idx)
                chosen.append(idx)
    # random repair (paper: replace invalid samples with random samples
    # until all initial samples are valid)
    guard = 0
    while len(chosen) < n and guard < 100 * n:
        guard += 1
        idx = space.random_index(rng)
        if idx in seen:
            continue
        if is_valid is not None and not is_valid(idx):
            continue
        seen.add(idx)
        chosen.append(idx)
    return chosen
