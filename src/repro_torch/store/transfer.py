"""Transfer-aware warm-start matching (DESIGN.md §11).

Turns prior store records into ``WarmObservation``s for a new run:

  * exact matches — records under the SAME fingerprint digest (identical
    grid, restrictions, objective, context): positions come straight from
    the current space, no discount;
  * cross-size matches — records under a COMPATIBLE fingerprint (same
    parameter names in the same order, different grids/trim/objective — e.g.
    a 512-seq GEMM warm-starting the 4096-seq space): each record is
    renormalized under its OWN fingerprint's grids, nearest-neighbor matched
    into the current space, and discounted with an extra GP noise term that
    grows with the mapping distance, so far-fetched matches inform the
    surrogate weakly instead of poisoning it.

Only finite (valid) observations transfer — the paper never fits invalids to
the GP, and a prior invalid on a different problem size proves nothing here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.strategies.base import WarmObservation
from repro_torch.store.records import (SpaceFingerprint, TuningRecord,
                                 TuningRecordStore)

#: Base extra GP noise for any cross-fingerprint observation (the surfaces
#: differ even at a perfectly matched config).
CROSS_NOISE = 0.05

#: Additional noise per unit squared mapping distance in normalized space.
DIST_NOISE = 4.0

#: Default cap on transferred observations (GP cost grows with t²).
MAX_WARM = 256


def _finite(recs: Sequence[TuningRecord]) -> List[TuningRecord]:
    return [r for r in recs if np.isfinite(r.value) and r.config is not None]


def warm_matches(store: TuningRecordStore, fingerprint: SpaceFingerprint,
                 space: SearchSpace, *,
                 exclude_runs: Sequence[str] = (),
                 max_warm: int = MAX_WARM,
                 cross_noise: float = CROSS_NOISE,
                 dist_noise: float = DIST_NOISE) -> List[WarmObservation]:
    """Match prior records into ``space``. Exact matches first, then
    cross-size, deduplicated per target config (lowest discount wins).

    ``exclude_runs`` only filters SAME-fingerprint records: it exists so a
    resumed run doesn't warm-start from the very journal it is replaying.
    A run id recurring under a different fingerprint is a different problem
    (e.g. the same strategy/seed tag on another kernel) and transfers."""
    exclude = set(exclude_runs)
    out: List[WarmObservation] = []

    exact = [r for r in _finite(store.records(fp=fingerprint.digest))
             if r.run not in exclude]
    for r in exact:
        idx = r.idx if r.idx is not None else space.index_of(r.config)
        if idx is None or not (0 <= idx < space.size):
            continue
        out.append(WarmObservation(x=np.asarray(space.X_norm[int(idx)],
                                                np.float64),
                                   value=float(r.value), idx=int(idx),
                                   exact=True, noise=0.0,
                                   config=dict(r.config)))

    for digest, desc in store.fingerprints().items():
        if digest == fingerprint.digest or not fingerprint.compatible(desc):
            continue
        recs = _finite(store.records(fp=digest))
        if not recs:
            continue
        xs, kept = [], []
        for r in recs:
            x = desc.x_norm(r.config)
            if x is not None:
                xs.append(x)
                kept.append(r)
        if not xs:
            continue
        src = np.stack(xs)
        tgt = space.nearest_indices(src)          # NN parameter matching
        for r, x_src, i in zip(kept, src, tgt):
            x_tgt = np.asarray(space.X_norm[int(i)], np.float64)
            d2 = float(np.sum((x_src.astype(np.float64) - x_tgt) ** 2))
            out.append(WarmObservation(
                x=x_tgt, value=float(r.value), idx=int(i), exact=False,
                noise=cross_noise + dist_noise * d2, config=dict(r.config)))

    # dedupe per target config: exact beats cross, lower discount beats
    # higher, then better value — one observation per site keeps the GP
    # Cholesky well-conditioned
    by_idx: Dict[int, WarmObservation] = {}
    for w in out:
        prev = by_idx.get(w.idx)
        if (prev is None
                or (w.exact, -w.noise, -w.value)
                > (prev.exact, -prev.noise, -prev.value)):
            by_idx[w.idx] = w
    deduped = sorted(by_idx.values(),
                     key=lambda w: (not w.exact, w.noise, w.value))
    return deduped[:max_warm]
