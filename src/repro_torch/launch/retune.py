"""Tuning-fleet daemon: service durable tuning jobs from the shared store.

    PYTHONPATH=src python -m repro_torch.launch.retune --store DIR \
        [--once] [--budget 40] [--strategy ei] [--poll-every 30] \
        [--worker daemon-a] [--device cpu]

Port of ``repro/launch/retune.py``. A ``kernel[name×shape×device]`` key
maps back to the port's cell factories (``kernels/tuning.py``) and is
tuned on the device it names: a ``cuda-*`` key on the card, and only when
it names the card that is present; a ``cpu`` key only under
``--device cpu``. The serve kernels' cells (flash, decode) are tuned in
bf16, the dtype the port serves in; gemm in fp32, the paper's sgemm. On
the card the BO surrogate runs on the GP kernel (``gp_backend="cuda"``).
A ``dryrun[arch×shape×<card>]`` key is serviced by
``core/tuning_targets.DryRunObjective`` (a meta-tensor trace of the cell,
``launch/dryrun.py``) when it names this daemon's card; a pod mesh of the
reference (``single``, ``multi``), the CPU or another card raises
``ValueError``: an unserviceable job should page, not rot.

The other half of the serve-side control plane (DESIGN.md §13): servers
running ``repro_torch.launch.serve --online`` enqueue ``kind="job"`` control
records into the store when observed latency drifts off the stored roofline
— this process tails the same store, claims each open job exactly once
under a fenced lease (``TuningJobQueue.claim``), and services it with a
warm-started tuning run (``repro_torch.core.engine.run_retune``) journaled back
into the store, which the serving fleet then hot-reloads. Submitters,
daemons, and servers share nothing but the store path: a request survives
the death of the process that raised it, and a daemon crash mid-run re-arms
after the claim TTL.

Run as MANY of these as you like against one store — claims are
exactly-once across the fleet (fencing tokens, ``repro_torch.store.fence``), and
a daemon that pauses past its TTL finds its ``done`` refused
(``FencedClaimError``, counted in ``self.fenced``) instead of corrupting
the job its peer re-claimed. Every journaled record of a serviced run
carries the claim's token in ``meta["fence"]``, so hot-reload consumers
drop a fenced-out daemon's late observations too.

Tests inject ``objective_for`` to service simulated cells instead.
"""
from __future__ import annotations

import argparse
import functools
import re
import time
from typing import Callable, Optional

import torch

from repro_torch.core.engine import RetuneRequest, run_retune
from repro_torch.store.fence import FencedClaimError
from repro_torch.store.queue import TuningJobQueue
from repro_torch.store.records import TuningRecordStore

_CELL_RE = re.compile(r"^dryrun\[(?P<arch>.+?)×(?P<shape>.+?)×(?P<mesh>.+?)\]$")
_KERNEL_RE = re.compile(
    r"^kernel\[(?P<name>.+?)×(?P<sig>.+?)×(?P<device>.+?)\]$")
#: shape-signature grammars of the kernel cell factories (kernels/tuning.py)
_GEMM_SIG = re.compile(r"^(?P<M>\d+)x(?P<N>\d+)x(?P<K>\d+)$")
_FLASH_SIG = re.compile(r"^B(?P<B>\d+)_S(?P<S>\d+)_H(?P<H>\d+)_hd(?P<hd>\d+)"
                        r"(?:_KV(?P<KV>\d+))?$")
_DECODE_SIG = re.compile(r"^B(?P<B>\d+)_S(?P<S>\d+)_H(?P<H>\d+)"
                         r"_KV(?P<KV>\d+)_hd(?P<hd>\d+)$")
_GP_SIG = re.compile(r"^N(?P<N>\d+)_T(?P<T>\d+)_d(?P<d>\d+)$")
#: the dtype the serve kernels' cells (flash, decode) are tuned in: the
#: one the port serves its models in
SERVE_DTYPE = torch.bfloat16


def dryrun_objective_for(key: str, device=None, card: Optional[str] = None,
                         cache_dir: str = "results/tune_cache"):
    """A sharding cell key back to its dry-run objective for this daemon's
    card (``card`` by name, else the card of ``device``, None: the card
    present): ``dryrun[arch×shape×<kind>]`` plans one card of that device
    kind, ``dryrun[arch×shape×<mesh>-<kind>]`` a production mesh of it
    (``single``, ``multi``). Raises for a pod mesh of the reference
    (``single``, ``multi`` alone: a record tuned for a TPU pod must not
    configure a card), for another card's key and with no card to plan
    for."""
    m = _CELL_RE.match(key)
    if m is None:
        raise ValueError(f"unrecognized retune cell key {key!r} — expected "
                         "a dryrun[arch×shape×mesh] tuning objective id")
    from repro_torch.core.tuning_targets import DryRunObjective
    from repro_torch.kernels import tuning as KT
    mesh = m.group("mesh")
    if mesh in ("single", "multi"):
        raise ValueError(f"cannot service {key!r}: {mesh!r} is a TPU pod mesh "
                         "of the reference's distribution tooling; this "
                         "daemon plans for one card (dryrun[arch×shape×"
                         "<card>])")
    if card is None:
        dev = KT.resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"cannot service {key!r} on the CPU: a dry-run "
                             "objective is keyed by the card it plans for")
        card = torch.cuda.get_device_name(dev)
    kind = KT.card_kind(card)
    prod = mesh.split("-", 1)[0]
    if prod in ("single", "multi") and mesh == f"{prod}-{kind}":
        return DryRunObjective(m.group("arch"), m.group("shape"), mesh=prod,
                               card=card, cache_dir=cache_dir, verbose=False)
    if mesh != kind:
        raise ValueError(f"{key!r} is keyed for {mesh!r}; this daemon plans "
                         f"for {kind!r} (one card, or its single/multi "
                         "meshes) and tunes only its own card's cells")
    return DryRunObjective(m.group("arch"), m.group("shape"), card=card,
                           cache_dir=cache_dir, verbose=False)


def kernel_objective_for(key: str, device=None):
    """A ``kernel[name×shape×device]`` cell key back to its in-process
    tuning objective: the shape signature is the cell factory's own format,
    so the daemon reconstructs the exact cell the server resolved blocks
    for. ``device`` is where this daemon runs (None: the card); the key
    must name that device's kind, so a job keyed for another card, or for
    the CPU, is refused rather than tuned here. Raises on malformed
    keys/signatures (same loud-failure policy as ``dryrun_objective_for``)."""
    m = _KERNEL_RE.match(key)
    if m is None:
        raise ValueError(f"unrecognized retune cell key {key!r} — expected "
                         "a kernel[name×shape×device] tuning objective id")
    from repro_torch.kernels import tuning as KT
    name, sig, kind = m.group("name"), m.group("sig"), m.group("device")
    dev = KT.resolve_device(device)
    here = KT.device_kind(dev)
    if kind != here:
        raise ValueError(f"{key!r} is keyed for device {kind!r}; this daemon "
                         f"runs on {here!r} and tunes only its own device's "
                         "cells")
    if name == "gemm":
        sm = _GEMM_SIG.match(sig)
        if sm:
            cell = KT.gemm_cell(int(sm.group("M")), int(sm.group("N")),
                                int(sm.group("K")), device=dev)
            return KT.KernelObjective(cell, device=dev)
    elif name == "flash":
        sm = _FLASH_SIG.match(sig)
        if sm:
            H = int(sm.group("H"))
            cell = KT.flash_cell(int(sm.group("B")), int(sm.group("S")), H,
                                 int(sm.group("hd")),
                                 KV=int(sm.group("KV") or H),
                                 dtype=SERVE_DTYPE, device=dev)
            return KT.KernelObjective(cell, device=dev)
    elif name == "decode":
        sm = _DECODE_SIG.match(sig)
        if sm:
            cell = KT.decode_cell(int(sm.group("B")), int(sm.group("S")),
                                  int(sm.group("H")), int(sm.group("KV")),
                                  int(sm.group("hd")), dtype=SERVE_DTYPE,
                                  device=dev)
            return KT.KernelObjective(cell, device=dev)
    elif name == "gp":
        sm = _GP_SIG.match(sig)
        if sm:
            cell = KT.gp_cell(int(sm.group("N")), int(sm.group("T")),
                              int(sm.group("d")), device=dev)
            return KT.KernelObjective(cell, device=dev)
    raise ValueError(f"unrecognized kernel cell signature in {key!r}")


def cell_objective_for(key: str, device=None):
    """Dispatch a retune cell key to its tuning objective — sharding cells
    (``dryrun[...]``) and kernel cells (``kernel[...]``) through one
    daemon."""
    if key.startswith("kernel["):
        return kernel_objective_for(key, device)
    return dryrun_objective_for(key)


def default_strategy(device=None, name: str = "ei"):
    """The reference's ``make_strategy(name)`` (``"ei"`` by default), its
    surrogate on the GP kernel when the daemon runs on the card."""
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels.tuning import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return make_strategy(name, gp_backend="cuda", gp_device=str(dev))
    return make_strategy(name)


class RetuneDaemon:
    """Claim-and-service loop over a store's durable tuning-job queue —
    one worker of a fleet of N."""

    def __init__(self, store_path: str, *,
                 objective_for: Optional[Callable] = None,
                 strategy_factory: Optional[Callable] = None,
                 budget: int = 40, seed: int = 0,
                 worker: Optional[str] = None, claim_ttl: float = 3600.0,
                 clock=time.time, verbose: bool = False, store=None,
                 quarantine_after: int = 0, device=None):
        # ``device``: where the default objective and strategy run (None:
        # the card); an injected ``objective_for`` brings its own
        if objective_for is None:
            objective_for = functools.partial(cell_objective_for,
                                              device=device)
        if strategy_factory is None:
            strategy_factory = functools.partial(default_strategy, device)
        self.store_path = store_path
        self.objective_for = objective_for
        self.strategy_factory = strategy_factory
        self.budget = int(budget)
        self.seed = int(seed)
        self.clock = clock
        self.verbose = verbose
        # ONE store instance for everything this process appends (queue
        # claims/dones AND the retune runs' journals): compaction judges
        # "sealed" per pid, so a second live append segment would be at
        # risk of being folded under us. Lazy: O(hot set) open, and
        # re-snapshotted per serviced request so warm starts see the
        # latest telemetry. In-process fleet simulations pass ``store=``
        # so every simulated daemon shares the ONE live appender the
        # sealed-per-pid rule allows.
        self.store = (store if store is not None
                      else TuningRecordStore(store_path, lazy=True))
        self.queue = TuningJobQueue(store_path, worker=worker,
                                    claim_ttl=claim_ttl, clock=clock,
                                    appender=self.store,
                                    quarantine_after=quarantine_after)
        self.worker = self.queue.worker
        self.serviced = 0
        #: ``done`` attempts refused because this daemon's lease was
        #: superseded while it serviced (paused past claim_ttl)
        self.fenced = 0

    @property
    def quarantined(self) -> int:
        """Jobs this daemon's queue fold saw quarantined: groups that
        burned ``quarantine_after`` consecutive claimants and were closed
        terminally instead of re-arming forever."""
        return self.queue.quarantined

    def step(self):
        """Claim and service at most one job; returns the TuneResult, or
        None when nothing was claimable (or our lease was fenced out
        mid-service — the work is journaled, the job stays with the
        claimant that superseded us)."""
        ticket = self.queue.claim()
        if ticket is None:
            return None
        if self.verbose:
            print(f"[retune] {self.worker} claimed {ticket.id} "
                  f"({ticket.job_type}, token {ticket.token})")
        req = RetuneRequest(key=ticket.key, objective=ticket.objective,
                            observed=ticket.observed,
                            predicted=ticket.predicted,
                            reason=ticket.reason, t=ticket.t)
        self.store.refresh()           # warm-start from the latest records
        result = run_retune(req, self.objective_for(ticket.key),
                            self.strategy_factory(),
                            store=self.store,
                            budget=ticket.budget or self.budget,
                            seed=self.seed, job_type=ticket.job_type,
                            run_meta={"fence": {"key": ticket.key,
                                                "token": ticket.token}})
        try:
            self.queue.done(ticket)
        except FencedClaimError:
            self.fenced += 1
            if self.verbose:
                print(f"[retune] {self.worker} fenced out of {ticket.id}: "
                      "another daemon re-claimed it; done refused")
            return None
        self.serviced += 1
        if self.verbose:
            print(f"[retune] {self.worker} serviced {ticket.key}: best "
                  f"{result.best_value:.4g} in {result.unique_evals} "
                  "unique evals — journaled to the store")
        return result

    def run(self, *, poll_every_s: float = 30.0,
            max_requests: Optional[int] = None) -> int:
        """Service requests until ``max_requests`` (None = forever)."""
        while max_requests is None or self.serviced < max_requests:
            if self.step() is None:
                if max_requests is not None:
                    break
                time.sleep(poll_every_s)
        return self.serviced


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True,
                    help="shared tuning-record store (directory) holding the "
                         "durable retune queue")
    ap.add_argument("--budget", type=int, default=40,
                    help="unique-evaluation budget per serviced request")
    ap.add_argument("--strategy", default="ei")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--once", action="store_true",
                    help="drain the currently open requests and exit")
    ap.add_argument("--poll-every", type=float, default=30.0,
                    help="seconds between queue polls when idle")
    ap.add_argument("--claim-ttl", type=float, default=3600.0,
                    help="seconds before an unfinished claim re-arms")
    ap.add_argument("--quarantine-after", type=int, default=5,
                    help="quarantine a job after this many consecutive "
                         "claimants die on it (terminal state instead of "
                         "re-arming forever; 0 disables)")
    ap.add_argument("--worker", default=None,
                    help="worker name in claim/done records (default: "
                         "proc-<pid>); name each daemon of a fleet")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: the device whose "
                         "kernel cells this daemon tunes")
    args = ap.parse_args(argv)
    from repro_torch.kernels.tuning import resolve_device
    dev = resolve_device(args.device)
    daemon = RetuneDaemon(args.store,
                          strategy_factory=functools.partial(
                              default_strategy, dev, args.strategy),
                          budget=args.budget, seed=args.seed,
                          worker=args.worker,
                          claim_ttl=args.claim_ttl,
                          quarantine_after=args.quarantine_after,
                          verbose=True, device=dev)
    if args.once:
        n = daemon.run(max_requests=len(daemon.queue))
        print(f"[retune] drained: {n} request(s) serviced")
    else:
        daemon.run(poll_every_s=args.poll_every)


if __name__ == "__main__":
    main()
