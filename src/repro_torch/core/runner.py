"""Tuning runner: budget accounting, caching, checkpoint/resume, metrics.

Budget semantics follow the paper: a budget of UNIQUE function evaluations
(20 initial + 200 optimization by default). Re-visits are served from cache
and don't consume budget (Kernel Tuner reports averages per configuration, so
"there is little practical need to revisit"). Invalid evaluations DO consume
budget — they cost real compile/run time on hardware.

Fault tolerance: every observation streams, in acceptance order, into a
``repro_torch.store`` record stream when a checkpoint path (single-file store) or
a shared ``TuningRecordStore`` is given; ``resume`` replays the run's
records through the cache so a killed tuning run continues losslessly — the
same property the paper's simulation mode exploits, required here for
cluster-scale objectives (a dry-run compile job can take minutes). Journals
written in the pre-store whole-JSON format are migrated in place on resume
(``repro_torch.store.migrate``); resume rejects records whose fingerprint does not
match the current problem.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.objectives import Objective
from repro_torch.store.migrate import is_legacy_checkpoint, migrate_checkpoint
from repro_torch.store.records import (SpaceFingerprint, TuningRecord,
                                 TuningRecordStore)


class BudgetExhausted(Exception):
    """Raised by TuningRun's direct-evaluation API when the budget or the
    total-call cap is hit. The ask/tell engine (repro_torch.core.engine) never
    raises it — it simply stops asking — but the exception remains for code
    that drives a TuningRun by hand."""


@dataclass
class Observation:
    idx: Optional[int]          # None for configs outside the space
    key: str                    # unique key (space idx or config repr)
    value: float                # NaN = invalid
    af: Optional[str] = None    # acquisition function that proposed it
    t: float = 0.0
    worker: str = "main"        # engine worker that ran the evaluation
    dur: float = 0.0            # seconds spent in the objective call


class TuningRun:
    def __init__(self, objective: Objective, budget: int,
                 max_total_calls: Optional[int] = None,
                 checkpoint_path: Optional[str] = None,
                 store: Optional[TuningRecordStore] = None,
                 run_id: Optional[str] = None, context: str = "",
                 run_meta: Optional[Dict[str, Any]] = None):
        self.objective = objective
        self.space = objective.space
        self.budget = budget
        self.max_total_calls = max_total_calls or budget * 50
        self.checkpoint_path = checkpoint_path
        self.store = store          # opened lazily when only a path is given
        self.run_id = run_id or "journal"
        self.run_meta = run_meta or {}
        self.fingerprint = SpaceFingerprint.of(
            self.space, objective=objective.name, context=context)
        self.cache: Dict[str, float] = {}
        self.journal: List[Observation] = []
        self.evaluated_idx: Dict[int, float] = {}
        self.total_calls = 0
        self.t0 = time.time()

    # -- core evaluation ----------------------------------------------------
    @property
    def unique_evals(self) -> int:
        return len(self.cache)

    def _record(self, key: str, idx: Optional[int], value: float,
                af: Optional[str], worker: str = "main", dur: float = 0.0):
        self.cache[key] = value
        if idx is not None:
            self.evaluated_idx[idx] = value
        obs = Observation(idx, key, value, af, time.time() - self.t0,
                          worker=worker, dur=dur)
        self.journal.append(obs)
        store = self._open_store()
        if store is not None:
            store.append(self._to_record(obs, len(self.journal) - 1),
                         fingerprint=self.fingerprint)

    def evaluate(self, idx: int, af: Optional[str] = None) -> float:
        key = str(int(idx))
        self.total_calls += 1
        if key in self.cache:
            if self.total_calls > self.max_total_calls:
                raise BudgetExhausted
            return self.cache[key]
        if self.unique_evals >= self.budget:
            raise BudgetExhausted
        value = self.objective(int(idx))
        self._record(key, int(idx), value, af)
        return value

    def evaluate_config(self, cfg: Dict[str, Any], af: Optional[str] = None) -> float:
        """For constraint-unaware baselines proposing raw config dicts."""
        idx = self.space.index_of(cfg)
        if idx is not None:
            return self.evaluate(idx, af)
        key = "cfg:" + json.dumps(cfg, sort_keys=True, default=str)
        self.total_calls += 1
        if key in self.cache:
            if self.total_calls > self.max_total_calls:
                raise BudgetExhausted
            return self.cache[key]
        if self.unique_evals >= self.budget:
            raise BudgetExhausted
        self._record(key, None, math.nan, af)   # outside restricted space
        return math.nan

    # -- results ------------------------------------------------------------
    def best(self) -> Tuple[Optional[int], float]:
        best_idx, best_val = None, math.inf
        for idx, v in self.evaluated_idx.items():
            if math.isfinite(v) and v < best_val:
                best_idx, best_val = idx, v
        return best_idx, best_val

    def best_trace(self) -> np.ndarray:
        """best-so-far value after each unique evaluation (inf until a valid)."""
        out = np.empty(len(self.journal))
        cur = math.inf
        for i, o in enumerate(self.journal):
            if math.isfinite(o.value) and o.value < cur:
                cur = o.value
            out[i] = cur
        return out

    # -- fault tolerance (store-backed journal) -----------------------------
    def _open_store(self) -> Optional[TuningRecordStore]:
        if self.store is None and self.checkpoint_path:
            self.store = TuningRecordStore(self.checkpoint_path)
        return self.store

    def _config_of(self, idx: Optional[int], key: str) -> Optional[Dict]:
        if idx is not None:
            return self.space.config(int(idx))
        if key.startswith("cfg:"):
            return json.loads(key[4:])
        return None

    def _to_record(self, o: Observation, seq: int) -> TuningRecord:
        return TuningRecord(
            fp=self.fingerprint.digest, run=self.run_id, seq=seq, key=o.key,
            idx=o.idx, value=o.value, af=o.af,
            config=self._config_of(o.idx, o.key), worker=o.worker, dur=o.dur,
            t=o.t, meta=self.run_meta)

    def resume(self) -> int:
        """Replay this run's record stream from the store (migrating a
        pre-store whole-JSON checkpoint in place first). Returns #replayed.
        Records under a different fingerprint are rejected: resuming a journal
        against the wrong space/objective corrupted runs silently before."""
        if self.checkpoint_path and is_legacy_checkpoint(self.checkpoint_path):
            migrate_checkpoint(self.checkpoint_path, self.fingerprint,
                               self.space, run_id=self.run_id)
        store = self._open_store()
        if store is None:
            return 0
        if store.single_file:
            # a journal file IS one run: any foreign fingerprint in it means
            # the space/objective changed under the checkpoint path
            recs = store.records(run=self.run_id)
            bad = [r for r in recs if r.fp != self.fingerprint.digest]
            if bad:
                raise ValueError(
                    f"run {self.run_id!r}: {len(bad)} stored records carry "
                    f"fingerprint {bad[0].fp}, current problem is "
                    f"{self.fingerprint.digest} ({self.fingerprint.objective})"
                    " — refusing to resume across space/objective changes")
        else:
            # shared store: the same run tag legitimately recurs under other
            # fingerprints (same strategy/seed on another kernel) — and
            # querying by digest keeps a lazy (indexed) open O(hot set)
            recs = store.records(fp=self.fingerprint.digest, run=self.run_id)
        # a twice-resumed run spans segments whose filename order need not
        # follow write order (new pid sorts before old) — seq is the truth
        recs.sort(key=lambda r: r.seq)
        for r in recs:
            self.cache[r.key] = r.value
            if r.idx is not None:
                self.evaluated_idx[r.idx] = r.value
            self.journal.append(Observation(r.idx, r.key, r.value, r.af,
                                            worker=r.worker, dur=r.dur))
        return len(recs)


@dataclass
class TuneResult:
    strategy: str
    objective: str
    best_idx: Optional[int]
    best_value: float
    trace: np.ndarray
    unique_evals: int
    wall_time_s: float
    journal: List[Observation] = field(default_factory=list)
    worker_stats: Dict[str, Dict] = field(default_factory=dict)


def run_strategy(strategy, objective: Objective, budget: int,
                 seed: int = 0, checkpoint_path: Optional[str] = None,
                 resume: bool = False, batch_size: int = 1, workers: int = 1,
                 max_in_flight: Optional[int] = None,
                 backend: str = "thread",
                 store=None, run_id: Optional[str] = None,
                 warm_start: bool = True) -> TuneResult:
    """Thin wrapper over the ask/tell engine (repro_torch.core.engine).

    The defaults (``batch_size=1, workers=1``) evaluate inline in this thread
    and reproduce the historical sequential runner bit-for-bit; raise
    ``workers``/``batch_size`` to parallelize the expensive compile-and-run
    step. ``store`` (a TuningRecordStore or path) persists the journal and
    warm-starts the strategy from matching prior records."""
    from repro_torch.core.engine import ParallelTuningEngine
    engine = ParallelTuningEngine(objective, budget, batch_size=batch_size,
                                  workers=workers, max_in_flight=max_in_flight,
                                  backend=backend,
                                  checkpoint_path=checkpoint_path,
                                  store=store, run_id=run_id,
                                  warm_start=warm_start)
    return engine.run(strategy, seed=seed, resume=resume)
