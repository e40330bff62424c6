"""Batched parallel evaluation engine for ask/tell strategies (DESIGN.md §5).

The engine owns the loop the strategies used to own: it asks a strategy for
up to ``batch_size`` proposals, evaluates them on a worker pool (thread or
process backend), and tells the strategy each result. Semantics are pinned
to the sequential seed implementation:

  * Budget counts UNIQUE evaluations; cache hits cost only ``total_calls``
    (capped at ``max_total_calls``); invalid configs and proposals outside
    the restricted space consume budget without an objective call.
  * In-flight dedup: a proposal for a config already being evaluated is not
    dispatched again — it is resolved with the first evaluation's result.
  * Ordered journal: observations are recorded (and checkpointed) in
    proposal-acceptance order, never completion order, so the journal is
    always a prefix of a deterministic sequence and ``TuningRun.resume``
    stays lossless even when a run is killed mid-batch.
  * Strategy tells arrive in the same acceptance order, which is what makes
    ``batch_size=1, workers=1`` reproduce the seed's sequential runs
    bit-for-bit (golden-trace tests).
  * Per-worker budget accounting: every dispatched evaluation is attributed
    to the worker that ran it (``TuneResult.worker_stats``).

With ``workers=1`` evaluations run inline in the caller's thread — no pool,
no overhead, identical to the seed runner. The process backend requires a
picklable objective (it is shipped once per worker via the pool initializer);
use it for objectives that hold the GIL, e.g. in-process compile jobs. An
objective that times a kernel on the card (``in_process_only``) refuses the
process backend and ``workers > 1``.
"""
from __future__ import annotations

import json
import math
import multiprocessing as mp
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional

import numpy as np

from repro_torch.core.objectives import Objective
from repro_torch.core.runner import TuneResult, TuningRun
from repro_torch.core.strategies.base import Proposal, Strategy, StrategyContext
from repro_torch.store.records import TuningRecordStore
from repro_torch.store.transfer import warm_matches

_PROC_OBJECTIVE: Optional[Objective] = None


@dataclass(frozen=True)
class RetuneRequest:
    """A serving-side ask for fresh tuning of one cell (DESIGN.md §12).

    Emitted by the online serve loop when observed prod latency diverges
    from the deployed config's stored roofline prediction; serviced by any
    tuner with access to the shared store (``run_retune``), whose journal
    the serving fleet then hot-reloads."""

    key: str                 # dedupe key: the cell, e.g. "dryrun[a×s×m]"
    objective: str = ""      # tuning-objective id of the cell
    observed: float = math.nan    # windowed median prod latency (s)
    predicted: float = math.nan   # stored roofline step time (s)
    reason: str = "drift"
    t: float = 0.0


class RetuneQueue:
    """Thread-safe IN-PROCESS intake for drift-triggered re-tune requests.

    One pending request per cell: a fleet of servers all observing the same
    drifted cell collapses to a single re-tune instead of a stampede. The
    key re-arms once the request is popped (taken by a tuner).

    This queue dies with its process; production serving uses the durable
    store-backed ``TuningJobQueue`` (``repro_torch.store.queue``; same
    ``submit`` interface), whose requests survive crashes and are claimed —
    under fenced, exactly-once leases — by a fleet of
    ``repro_torch.launch.retune`` daemons."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queue: Deque[RetuneRequest] = deque()
        self._pending: set = set()

    def submit(self, req: RetuneRequest) -> bool:
        """Enqueue unless the cell already has a pending request."""
        with self._lock:
            if req.key in self._pending:
                return False
            self._pending.add(req.key)
            self._queue.append(req)
            return True

    def pop(self) -> Optional[RetuneRequest]:
        with self._lock:
            if not self._queue:
                return None
            req = self._queue.popleft()
            self._pending.discard(req.key)
            return req

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


def run_retune(request: RetuneRequest, objective: Objective, strategy, *,
               store, budget: int, seed: int = 0, job_type: str = "retune",
               run_meta: Optional[Dict[str, Any]] = None, **engine_kw):
    """Service one tuning-job request: a warm-started engine run journaled
    into the shared ``store`` under a request-derived run id. Prior records
    for the cell — including the ``context="prod"`` telemetry that triggered
    the request — seed the strategy through the standard warm-start path, so
    a drift re-tune starts from everything serving has learned. The serving
    fleet picks the new records up by tailing the same store.

    ``job_type`` prefixes the run id (``retune`` keeps the historical ids);
    ``run_meta`` is stamped into every journaled record — the retune daemon
    passes its claim's fencing token here (``{"fence": {"key", "token"}}``)
    so consumers can reject a fenced-out claimant's late writes."""
    engine = ParallelTuningEngine(
        objective, budget, store=store,
        run_id=f"{job_type}[{request.key}]@{request.t:g}",
        run_meta=run_meta, **engine_kw)
    return engine.run(strategy, seed=seed)


def _proc_init(objective: Objective) -> None:
    global _PROC_OBJECTIVE
    _PROC_OBJECTIVE = objective


def _proc_eval(idx: int):
    t0 = time.time()
    v = _PROC_OBJECTIVE(idx)
    return v, time.time() - t0, f"pid-{os.getpid()}"


@dataclass
class WorkerStats:
    n_evals: int = 0
    busy_s: float = 0.0


@dataclass
class _Pending:
    """One accepted proposal awaiting record+tell, in acceptance order."""
    proposal: Proposal
    key: str
    idx: Optional[int]
    primary: bool                      # this entry owns the journal record
    future: Optional[Future] = None    # set when dispatched to the pool
    dup_of: Optional["_Pending"] = None  # in-flight dedup target
    resolved: bool = False
    value: float = math.nan
    dur: float = 0.0
    worker: str = "main"

    def ready(self) -> bool:
        if self.resolved:
            return True
        if self.future is not None:
            return self.future.done()
        if self.dup_of is not None:
            return self.dup_of.resolved
        return False


class ParallelTuningEngine:
    def __init__(self, objective: Objective, budget: int, *,
                 batch_size: int = 1, workers: int = 1,
                 max_in_flight: Optional[int] = None,
                 backend: str = "thread",
                 max_total_calls: Optional[int] = None,
                 checkpoint_path: Optional[str] = None,
                 store=None, run_id: Optional[str] = None,
                 context: str = "", warm_start: bool = True,
                 run_meta: Optional[Dict[str, Any]] = None):
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown backend {backend!r}")
        if getattr(objective, "in_process_only", False) and (
                backend == "process" or int(workers) > 1):
            # a kernel timed on the card: its CUDA context must not be
            # shipped to a worker process, and concurrent launches would
            # share the card and corrupt each other's timings
            raise ValueError(
                f"{objective.name}: a card objective runs in-process "
                f"(workers=1, thread backend), got workers={workers}, "
                f"backend={backend!r}")
        self.objective = objective
        self.budget = budget
        self.batch_size = max(int(batch_size), 1)
        self.workers = max(int(workers), 1)
        self.max_in_flight = max(max_in_flight or max(self.workers,
                                                      self.batch_size), 1)
        self.backend = backend
        self.max_total_calls = max_total_calls
        self.checkpoint_path = checkpoint_path
        # shared record store (repro_torch.store): journal persistence + transfer.
        # A path opens through the sidecar segment index (lazy=True): the
        # engine touches only this run's fingerprint and its warm-start
        # matches, so opening must stay O(hot set) on fleet-scale stores.
        self.store = (TuningRecordStore(store, lazy=True)
                      if isinstance(store, str) else store)
        self.run_id = run_id
        self.context = context
        self.warm_start = warm_start
        # extra meta stamped into every journaled record alongside the
        # strategy/seed/budget triple (e.g. the fencing token of the claim
        # this run services — the reference's repro.store.queue)
        self.run_meta = dict(run_meta) if run_meta else {}
        self.worker_stats: Dict[str, WorkerStats] = {}

    # ------------------------------------------------------------------
    def run(self, strategy: Strategy, seed: int = 0,
            resume: bool = False) -> TuneResult:
        run_id = self.run_id or f"{strategy.name}-s{seed}"
        if (not resume and self.store is None and self.checkpoint_path
                and os.path.isfile(self.checkpoint_path)):
            # a journal file is ONE run: a fresh (non-resume) run replaces a
            # stale journal, exactly as the pre-store whole-JSON rewrite did
            os.remove(self.checkpoint_path)
        run = TuningRun(self.objective, self.budget,
                        max_total_calls=self.max_total_calls,
                        checkpoint_path=self.checkpoint_path,
                        store=self.store, run_id=run_id, context=self.context,
                        run_meta={"strategy": strategy.name, "seed": seed,
                                  "budget": self.budget, **self.run_meta})
        if resume:
            run.resume()
        rng = np.random.default_rng(seed)
        strategy.reset(StrategyContext(
            space=run.space, budget=self.budget, rng=rng,
            replayed=tuple((o.idx, o.value) for o in run.journal)))
        if self.warm_start and self.store is not None and len(self.store) > 0:
            # transfer-aware warm start: prior records under this fingerprint
            # (other runs) or a compatible cross-size one. Only an explicitly
            # shared store transfers — a bare checkpoint journal keeps the
            # historical semantics (its records are for resume only). Cold
            # stores yield no matches and leave the run bit-for-bit identical.
            warm = warm_matches(self.store, run.fingerprint, run.space,
                                exclude_runs=(run_id,))
            if warm:
                strategy.warm_start(warm)
        self.worker_stats = {}
        t0 = time.time()
        pool = None
        if self.workers > 1:
            if self.backend == "thread":
                pool = ThreadPoolExecutor(self.workers,
                                          thread_name_prefix="tuner")
            else:
                # spawn, not fork: the parent holds torch's thread pools and
                # possibly a CUDA context, and a forked child inherits both
                pool = ProcessPoolExecutor(
                    self.workers, mp_context=mp.get_context("spawn"),
                    initializer=_proc_init, initargs=(self.objective,))
        try:
            self._loop(strategy, run, pool)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        best_idx, best_val = run.best()
        return TuneResult(strategy=strategy.name, objective=run.objective.name,
                          best_idx=best_idx, best_value=best_val,
                          trace=run.best_trace(),
                          unique_evals=run.unique_evals,
                          wall_time_s=time.time() - t0, journal=run.journal,
                          worker_stats={k: vars(v).copy() for k, v
                                        in self.worker_stats.items()})

    # ------------------------------------------------------------------
    def _loop(self, strategy: Strategy, run: TuningRun, pool) -> None:
        pending: Deque[_Pending] = deque()
        in_flight: Dict[str, _Pending] = {}
        stop = False
        while True:
            exhausted = False
            if not stop and len(pending) < self.max_in_flight:
                want = min(self.batch_size,
                           self.max_in_flight - len(pending))
                props = strategy.suggest(want)
                if not props:
                    exhausted = True
                for p in props:
                    if not self._accept(p, run, pool, pending, in_flight):
                        stop = True     # budget / total-call cap reached
                        break
            if not pending:
                # either the run is over (stop/exhausted) or every accept
                # above appended an entry — nothing to spin-wait on
                break
            # drain the head (blocking), then any already-finished successors,
            # so the journal and the tells stay in acceptance order
            self._settle(pending.popleft(), run, in_flight, strategy)
            while pending and pending[0].ready():
                self._settle(pending.popleft(), run, in_flight, strategy)

    # ------------------------------------------------------------------
    def _accept(self, p: Proposal, run: TuningRun, pool,
                pending: Deque[_Pending], in_flight: Dict[str, _Pending]) -> bool:
        """Replicates TuningRun.evaluate/evaluate_config bookkeeping. Returns
        False when the run must stop (budget or total-call cap)."""
        if p.config is not None:
            idx = run.space.index_of(p.config)
            key = (str(int(idx)) if idx is not None
                   else "cfg:" + json.dumps(p.config, sort_keys=True,
                                            default=str))
        else:
            idx, key = int(p.idx), str(int(p.idx))
        run.total_calls += 1
        if key in run.cache:
            if run.total_calls > run.max_total_calls:
                return False
            pending.append(_Pending(p, key, idx, primary=False, resolved=True,
                                    value=run.cache[key]))
            return True
        if key in in_flight:
            if run.total_calls > run.max_total_calls:
                return False
            pending.append(_Pending(p, key, idx, primary=False,
                                    dup_of=in_flight[key]))
            return True
        if run.unique_evals + len(in_flight) >= run.budget:
            return False
        entry = _Pending(p, key, idx, primary=True)
        if idx is None:
            # outside the restricted space: recorded invalid, no objective call
            entry.resolved, entry.value = True, math.nan
        elif pool is None:
            t_eval = time.time()
            entry.value = run.objective(idx)
            entry.dur = time.time() - t_eval
            entry.resolved = True
        else:
            entry.future = (pool.submit(self._eval_threaded, idx)
                            if self.backend == "thread"
                            else pool.submit(_proc_eval, idx))
        pending.append(entry)
        in_flight[key] = entry
        return True

    def _eval_threaded(self, idx: int):
        t0 = time.time()
        v = self.objective(idx)
        return v, time.time() - t0, threading.current_thread().name

    # ------------------------------------------------------------------
    def _settle(self, entry: _Pending, run: TuningRun,
                in_flight: Dict[str, _Pending], strategy: Strategy) -> None:
        if entry.future is not None:
            entry.value, entry.dur, entry.worker = entry.future.result()
            entry.resolved = True
        elif entry.dup_of is not None:
            # the primary was accepted earlier, so it settled earlier
            entry.value, entry.resolved = entry.dup_of.value, True
        if entry.primary:
            # worker/dur go in BEFORE _record serializes the observation to
            # the store — patched-after fields would never reach disk
            run._record(entry.key, entry.idx, entry.value, entry.proposal.af,
                        worker=entry.worker, dur=entry.dur)
            in_flight.pop(entry.key, None)
            ws = self.worker_stats.setdefault(entry.worker, WorkerStats())
            ws.n_evals += 1
            ws.busy_s += entry.dur
        strategy.observe(entry.proposal, entry.value)
