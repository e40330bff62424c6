"""Scheduled-job producer: submit tuning jobs into the durable queue on a
fixed interval.

    PYTHONPATH=src python -m repro_torch.launch.schedule --store DIR \
        --job "kernel[gemm×4096x4096x4096×cuda-NVIDIA_H100_80GB_HBM3]:bench_sweep:86400:80" \
        [--once] [--poll-every 5]

Port of ``repro/launch/schedule.py``, copied whole (pure host code).

The third leg of the fleet control plane (DESIGN.md §13): servers submit
drift-triggered jobs, ``repro_torch.launch.retune`` daemons claim and service
them — this process is the *cron* half, submitting ``scheduled_retune`` /
``bench_sweep`` jobs for configured keys every ``every_s`` seconds so cells
re-tune and bench curves refresh even when nothing drifts. The queue and
the daemons already speak these job types; this is one loop over
``TuningJobQueue.submit``.

Idempotence falls out of the queue's own semantics, not producer state:
``submit`` refuses a key that already has an open job (commit-then-check
group coalescing), so a restarted producer — or N producers racing on the
same store — cannot stack duplicates, and an interval shorter than the
fleet's service latency degrades to "submit as soon as the previous run
finishes". The in-memory ``_last`` stamp only spaces *successful* submits;
it deliberately does not persist (a restart submitting one interval early
is harmless for the same reason).

Job specs are ``key:job_type:every_s[:budget]`` — the key must be one the
retune daemons can resolve to an objective (``dryrun[...]``,
``kernel[...]``), ``job_type`` ∈ JOB_TYPES, ``every_s`` the submit period
in seconds, and the optional ``budget`` overrides the servicing daemon's
default unique-eval budget for this job.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.store.queue import JOB_TYPES, TuningJobQueue
from repro_torch.store.records import TuningRecordStore


@dataclass(frozen=True)
class JobSpec:
    """One scheduled submission: ``key`` every ``every_s`` seconds."""

    key: str
    job_type: str = "scheduled_retune"
    every_s: float = 3600.0
    budget: Optional[int] = None

    @classmethod
    def parse(cls, text: str) -> "JobSpec":
        """``key:job_type:every_s[:budget]`` — cell keys (``dryrun[...]``,
        ``kernel[...]``) never contain ``:``."""
        parts = text.split(":")
        if len(parts) == 4:
            key, job_type, every, budget = parts
            spec = cls(key, job_type, float(every), int(budget))
        elif len(parts) == 3:
            key, job_type, every = parts
            spec = cls(key, job_type, float(every))
        else:
            raise ValueError(
                f"job spec {text!r}: want key:job_type:every_s[:budget]")
        if spec.job_type not in JOB_TYPES:
            raise ValueError(f"job spec {text!r}: job_type must be one of "
                             f"{JOB_TYPES}")
        if spec.every_s <= 0:
            raise ValueError(f"job spec {text!r}: every_s must be > 0")
        return spec


class _ScheduledReq:
    """The submit payload: anything with the RetuneRequest fields."""

    def __init__(self, key: str, t: float):
        self.key = key
        self.objective = f"{key}@scheduled"
        self.observed = float("nan")
        self.predicted = float("nan")
        self.reason = "scheduled"
        self.t = t


class ScheduleProducer:
    """Submit each spec's job whenever its interval has elapsed since the
    last ACCEPTED submit. All durable state is the queue itself."""

    def __init__(self, store_path: str, specs: Sequence[JobSpec], *,
                 worker: Optional[str] = None, clock=time.time,
                 store=None, verbose: bool = False):
        self.specs = list(specs)
        self.clock = clock
        self.verbose = verbose
        self._owns_store = store is None
        self.store = (store if store is not None
                      else TuningRecordStore(store_path, load=False))
        self.queue = TuningJobQueue(store_path, worker=worker,
                                    clock=clock, appender=self.store)
        #: per-spec time of the last accepted submit (None = never: every
        #: spec fires on the first step, then spaces by its interval)
        self._last: Dict[JobSpec, Optional[float]] = {
            s: None for s in self.specs}
        self.submitted = 0
        #: submits the queue refused (an open job already holds the key —
        #: the fleet is still servicing the previous interval's run)
        self.coalesced = 0

    def step(self, now: Optional[float] = None) -> int:
        """Submit every spec whose interval has elapsed; returns how many
        submissions the queue ACCEPTED this step."""
        now = float(self.clock() if now is None else now)
        accepted = 0
        for spec in self.specs:
            last = self._last[spec]
            if last is not None and now - last < spec.every_s:
                continue
            ok = self.queue.submit(_ScheduledReq(spec.key, now),
                                   job_type=spec.job_type,
                                   budget=spec.budget)
            if ok:
                self._last[spec] = now
                self.submitted += 1
                accepted += 1
                if self.verbose:
                    print(f"[schedule] submitted {spec.job_type} for "
                          f"{spec.key} (every {spec.every_s:g}s)")
            else:
                self.coalesced += 1
                if self.verbose:
                    print(f"[schedule] {spec.key} already has an open job; "
                          "coalesced")
        return accepted

    def run(self, *, poll_every_s: float = 5.0,
            max_steps: Optional[int] = None) -> int:
        """Loop ``step`` until ``max_steps`` (None = forever); returns the
        total number of accepted submissions."""
        steps = 0
        while max_steps is None or steps < max_steps:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            time.sleep(poll_every_s)
        return self.submitted

    def close(self) -> None:
        if self._owns_store:
            self.store.close()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True,
                    help="shared tuning-record store (directory) holding "
                         "the durable job queue")
    ap.add_argument("--job", action="append", required=True,
                    metavar="KEY:TYPE:EVERY_S[:BUDGET]",
                    help="scheduled job spec; repeatable. TYPE is usually "
                         "scheduled_retune or bench_sweep")
    ap.add_argument("--once", action="store_true",
                    help="run one submission pass and exit")
    ap.add_argument("--poll-every", type=float, default=5.0,
                    help="seconds between interval checks")
    ap.add_argument("--worker", default=None,
                    help="producer name stamped into submit records")
    args = ap.parse_args(argv)
    specs = [JobSpec.parse(s) for s in args.job]
    prod = ScheduleProducer(args.store, specs, worker=args.worker,
                            verbose=True)
    try:
        if args.once:
            n = prod.step()
            print(f"[schedule] one pass: {n} job(s) submitted, "
                  f"{prod.coalesced} coalesced")
        else:
            prod.run(poll_every_s=args.poll_every)
    finally:
        prod.close()


if __name__ == "__main__":
    main()
