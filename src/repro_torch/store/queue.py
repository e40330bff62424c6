"""Durable tuning-job queue: the fleet control plane IN the store
(DESIGN.md §13).

Port of ``repro/store/queue.py``, copied whole: the record schema is the
reference's, so a job submitted through either package is claimed by
the other.

The in-process ``repro_torch.core.engine.RetuneQueue`` lives in one
process's memory — a drift request dies with the server that noticed it,
and a daemon on another host can never see it. This module keeps the queue in the record store
itself as append-only ``kind="job"`` control records, so it inherits every
durability property observations already have (per-record flush, torn-line
tolerance, segment rollover, compaction survival) — and, unlike the older
``kind="retune"`` queue it generalizes, it is **exactly-once under N racing
daemons** via fencing tokens (``repro_torch.store.fence``):

    {"kind": "job", "state": "submit", "id", "key", "job_type", "objective",
     "observed", "predicted", "reason", "t", "by"[, "budget"]}
    {"kind": "job", "state": "claim",      "id", "key", "by", "t", "token"}
    {"kind": "job", "state": "release",    "id", "key", "by", "t", "token"}
    {"kind": "job", "state": "done",       "id", "key", "by", "t", "token"}
    {"kind": "job", "state": "quarantine", "id", "key", "by", "t", "token"}

``job_type`` ∈ {"retune", "cold_tune", "scheduled_retune", "bench_sweep"}
(anything a fleet worker knows how to service); legacy ``kind="retune"``
records fold in as ``job_type="retune"`` with token-0 claims, so every
pre-existing store keeps working.

Protocol (the fold of a key's records is the truth):

  * **Groups.** All open submits for one ``key`` form one job group; the
    canonical ticket is the earliest ``(t, id)``. ``submit`` is
    commit-then-check: append, re-read, and report accepted only if your
    submit became the canonical one — racing duplicates coalesce into ONE
    open job instead of slipping through the old check-then-append window.
  * **Claims are fenced leases.** ``claim()`` snapshots the tokens it has
    seen, atomically obtains the next fencing token for the key
    (``FenceRegistry.issue`` — one winner per token value, monotone per
    key), appends the claim, re-reads, and keeps the lease only if no
    higher token appeared and no *unseen live* lower-token claim landed in
    the race window (in which case it appends a ``release`` and backs
    off). Exactly one claimant survives any interleaving — see the crash
    matrix below.
  * **Expiry is judged on the reader's clock.** Each claim is stamped
    ``seen`` with the reader's own clock when it first folds; a lease is
    expired when ``reader_now - seen > claim_ttl``. Append order is the
    only cross-host truth — writer wall-clock stamps never enter the
    arbitration, so cross-machine clock skew cannot shorten (steal a live
    lease) or extend (wedge the queue on) a TTL. The claimant itself folds
    its own claim earliest, so its own view expires first: it always
    observes itself fenced before any peer could have taken over.
  * **Writes are fenced.** ``done`` carries the claim's token; the fold
    rejects a ``done`` whose token is below the group's highest UNRELEASED
    claim token (a racer that backed off released its token — it must not
    fence the winner it deferred to), and ``done()`` itself raises
    ``FencedClaimError`` when the caller has been superseded — a daemon
    that paused past its TTL and woke mid-service cannot close a job
    another daemon re-claimed. The
    retune engine run stamps the same token into every journaled
    observation (``meta["fence"]``), which ``HotConfigSource`` checks.
  * **Poison jobs are quarantined, not re-armed forever.** With
    ``quarantine_after=K > 0``, a claimant that finds K or more *expired
    unreleased* leases on a group (K consecutive claimants took the job
    and died or stalled past ``claim_ttl`` — voluntary releases never
    count) does not claim it again: it obtains a fresh fencing token and
    appends a ``quarantine`` record per open submit id (coalescing like
    ``done``). The fold treats ``quarantine`` as a token-fenced terminal
    state — the group closes, ``open_tickets`` stops offering it, and the
    ``quarantined`` counter ticks. A NEW submit for the key re-arms it
    fresh (fresh ids, higher fence floor). ``quarantine_after=0``
    (default) disables the check: folds are byte-identical to the
    fold without quarantine.

Crash matrix:
  * submitter dies after ``submit`` — the job is on disk; any daemon
    claims and services it;
  * claimant dies before ``done`` — the lease expires after ``claim_ttl``
    (on each reader's own clock) and the job re-arms; the next claim takes
    a higher token, permanently fencing the dead claimant out;
  * claimant pauses and wakes after losing the lease — its ``done`` and
    its journaled observations are rejected by token comparison; the only
    residual window is a pause between ``done()``'s own fence check and
    its append landing, which closes a job the new claimant is (re)doing —
    the *work* of both is journaled and the later records win resolution;
  * claimant dies between token issue and claim append — the token is
    burned, never claimed; the next claimant's ``issue`` simply grants a
    higher one;
  * torn final line of any control record — invisible (incomplete lines
    are never consumed), state unchanged;
  * compaction — open jobs are copied verbatim; completed groups older
    than the retention window are folded away, with fenced (rejected)
    ``done`` records never counting as completion (``repro_torch.store.compact``,
    which also enforces the single-compactor lock on the same tokens).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.store.fence import FencedClaimError, FenceRegistry
from repro_torch.store.index import index_is_stale, load_index
from repro_torch.store.records import TuningRecordStore, _is_single_file, natural_key
from repro_torch.store.watch import StoreWatcher

JOB_TYPES = ("retune", "cold_tune", "scheduled_retune", "bench_sweep")


@dataclass
class _Claim:
    """One folded claim record. ``seen`` is the READER's clock at first
    fold — the only timestamp lease expiry ever consults; ``t`` (the
    writer's stamp) is carried for logs only."""

    token: int
    t: float
    by: str
    seen: float
    released: bool = False


@dataclass
class JobTicket:
    """Folded state of one submit id (``RetuneTicket`` in the legacy
    single-daemon queue)."""

    id: str
    key: str
    job_type: str = "retune"
    objective: str = ""
    observed: float = float("nan")
    predicted: float = float("nan")
    reason: str = "drift"
    t: float = 0.0
    submitted_by: str = ""
    budget: Optional[int] = None
    claims: List[_Claim] = field(default_factory=list)
    done: bool = False
    #: terminal without service: K consecutive claimants died on this job
    quarantined: bool = False
    #: the fencing token of the lease ``claim()`` granted the caller; 0 on
    #: tickets obtained any other way (``open_tickets``)
    token: int = 0
    #: other open submit ids coalesced into this canonical ticket
    dup_ids: List[str] = field(default_factory=list)

    @property
    def terminal(self) -> bool:
        """Closed for good: serviced (``done``) or poisoned
        (``quarantined``). Terminal tickets never re-arm."""
        return self.done or self.quarantined


#: legacy alias — callers of the single-daemon queue constructed these by name
RetuneTicket = JobTicket


class TuningJobQueue:
    """Store-backed job intake: drop-in for the in-process ``RetuneQueue``'s
    ``submit`` side of the online serve loop, plus fenced ``claim``/``done``
    for a fleet of daemons. All state is the store — a fresh instance on
    the same path sees everything prior processes did."""

    def __init__(self, path: str, *, worker: Optional[str] = None,
                 claim_ttl: float = 3600.0, clock=time.time, appender=None,
                 use_index: bool = True, quarantine_after: int = 0):
        """``appender`` shares an already-open ``TuningRecordStore`` for the
        control-record writes. Pass the process's existing appender (the
        serve loop passes its ``ProdRecorder``'s) — compaction judges
        "sealed" per pid, so a process must keep ONE live append segment,
        not one per component.

        Cold start is index-seeded when the sidecar index is present and
        fresh (``use_index=True``): only the ``kind="job"``/``kind="retune"``
        extents are read — O(control lines), not O(store) — and the watcher
        starts each indexed segment at its indexed frontier, so a daemon
        opening a million-record store folds a handful of lines instead of
        parsing every observation ever journaled. A missing/stale index
        falls back to the full replay."""
        self.path = path
        self.worker = worker or f"proc-{os.getpid()}"
        self.claim_ttl = float(claim_ttl)
        #: quarantine a job once this many consecutive claimants took its
        #: lease and expired without releasing or finishing (0 = never)
        self.quarantine_after = int(quarantine_after)
        self.clock = clock
        self._owns_store = appender is None
        self._store = (appender if appender is not None
                       else TuningRecordStore(path, load=False))
        self._fence = FenceRegistry(path, clock=clock)
        self._tickets: Dict[str, JobTicket] = {}
        #: highest claim token ever folded per key — the issuance floor
        #: (survives group completion; markers alone can be GC'd)
        self._token_floor: Dict[str, int] = {}
        #: fenced ``done`` records the fold refused (superseded claimants)
        self.rejected_writes = 0
        #: submit ids this instance folded into the quarantined state
        self.quarantined = 0
        self.seeded_from_index = False
        start_offsets = None
        if use_index:
            idx = load_index(path)
            if idx is not None and not index_is_stale(path, idx):
                single = _is_single_file(path)
                exts = [e for k in ("retune", "job")
                        for e in idx.controls.get(k, ())]
                # fold in store order: within one segment done-fencing is
                # order-sensitive, and retune/job extents may interleave
                exts.sort(key=lambda e: (natural_key(e.segment), e.offset))
                for ext in exts:
                    seg = (path if single
                           else os.path.join(path, ext.segment))
                    self._fold_extent(seg, ext.offset, ext.length)
                start_offsets = dict(idx.segments)
                self.seeded_from_index = True
        self._watcher = StoreWatcher(path, from_start=True,
                                     collect_controls=True,
                                     start_offsets=start_offsets)
        # fold the store's current control state NOW: the post-index tail
        # (or, unseeded, every segment) is replayed at construction, keeping
        # it off the serve loop's decode latency path (submit happens
        # between decode steps).
        self._refresh()

    def _fold_extent(self, seg: str, offset: int, length: int) -> None:
        """Fold the control lines of one indexed extent. Extents span whole
        lines by construction (and may include absorbed blank lines);
        folding is idempotent, so re-seeing a line — e.g. a compacted copy —
        is harmless."""
        try:
            with open(seg, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except OSError:
            return
        for line in data.split(b"\n"):
            text = line.decode("utf-8", errors="replace").strip()
            if not text:
                continue
            try:
                d = json.loads(text)
            except json.JSONDecodeError:
                continue
            if d.get("kind") in ("retune", "job"):
                self._fold(d)

    # -- folding ------------------------------------------------------------
    def _fold(self, d: dict) -> None:
        state, rid = d.get("state"), str(d.get("id", ""))
        if not rid:
            return
        if state == "submit":
            if rid not in self._tickets:
                budget = d.get("budget")
                self._tickets[rid] = JobTicket(
                    id=rid, key=str(d.get("key", "")),
                    job_type=str(d.get("job_type", "retune")),
                    objective=str(d.get("objective", "")),
                    observed=float(d.get("observed", float("nan"))),
                    predicted=float(d.get("predicted", float("nan"))),
                    reason=str(d.get("reason", "drift")),
                    t=float(d.get("t", 0.0)),
                    submitted_by=str(d.get("by", "")),
                    budget=None if budget is None else int(budget))
        elif state in ("claim", "release"):
            key = str(d.get("key", ""))
            token = int(d.get("token") or 0)
            if token > self._token_floor.get(key, 0):
                self._token_floor[key] = token
            tk = self._claim_target(rid, key)
            if tk is None:
                return
            entry = self._find_claim(tk, token, d)
            if state == "claim":
                if entry is None:
                    tk.claims.append(_Claim(
                        token=token, t=float(d.get("t", 0.0)),
                        by=str(d.get("by", "")),
                        seen=float(self.clock())))
            elif entry is not None:
                entry.released = True
        elif state in ("done", "quarantine"):
            token_floor = int(d.get("token") or 0)
            key = str(d.get("key", ""))
            if key and token_floor > self._token_floor.get(key, 0):
                self._token_floor[key] = token_floor
            tk = self._tickets.get(rid)
            if tk is None or tk.terminal:
                return
            token = d.get("token")
            if token is not None:
                # fence: a done/quarantine below the group's highest
                # UNRELEASED claim token is a superseded claimant's late
                # write — refuse to close the job. Released claims are
                # aborted racers that explicitly backed off; they must not
                # fence the winner.
                if int(token) < self._group_top(tk.key):
                    self.rejected_writes += 1
                    return
            if state == "quarantine":
                tk.quarantined = True
                self.quarantined += 1
            else:
                tk.done = True

    def _claim_target(self, rid: str, key: str) -> Optional[JobTicket]:
        """The open ticket a claim/release attaches to: its own id if still
        open, else dangling (a claim folding after its group closed belongs
        to no lease — the group it raced is already done)."""
        tk = self._tickets.get(rid)
        return tk if tk is not None and not tk.terminal else None

    @staticmethod
    def _find_claim(tk: JobTicket, token: int, d: dict) -> Optional[_Claim]:
        for c in tk.claims:
            if token > 0 and c.token == token:
                return c
            if token == 0 and c.token == 0 \
                    and (c.t, c.by) == (float(d.get("t", 0.0)),
                                        str(d.get("by", ""))):
                return c
        return None

    def _refresh(self) -> None:
        self._watcher.poll()            # observations are not our business
        for d in self._watcher.drain_controls():
            if d.get("kind") in ("retune", "job"):
                self._fold(d)

    # -- group / lease arbitration ------------------------------------------
    def _group(self, key: str) -> List[JobTicket]:
        """All open tickets of one key, canonical first."""
        return sorted((tk for tk in self._tickets.values()
                       if tk.key == key and not tk.terminal),
                      key=lambda tk: (tk.t, tk.id))

    def _canonical(self, key: str) -> Optional[JobTicket]:
        grp = self._group(key)
        return grp[0] if grp else None

    def _expired(self, c: _Claim, now: float) -> bool:
        return c.released or now - c.seen > self.claim_ttl

    def _group_top(self, key: str) -> int:
        """Highest UNRELEASED claim token of a key's group — the token a
        ``done`` must carry to be accepted. Released claims are aborted
        racers (they backed off in ``_try_claim``'s post-append check);
        they are transparent to arbitration, else a loser would fence out
        the very winner it deferred to."""
        return max((c.token for tk in self._group(key) for c in tk.claims
                    if not c.released), default=0)

    def _lease(self, key: str, now: float) -> Optional[_Claim]:
        """The claim currently holding ``key``, or None if claimable. The
        highest unreleased token rules; it being expired does NOT fall
        back to a lower one (lower tokens are fenced out forever), and
        released claims are transparent (aborted racers). Token-0 claims
        are the legacy queue's: earliest unexpired wins among them, and
        any tokened claim supersedes them all."""
        claims = [c for tk in self._group(key) for c in tk.claims
                  if not c.released]
        if not claims:
            return None
        top = max(c.token for c in claims)
        if top > 0:
            cand = next(c for c in claims if c.token == top)
            return None if self._expired(cand, now) else cand
        live = [c for c in claims if not self._expired(c, now)]
        return min(live, key=lambda c: (c.t, c.by)) if live else None

    # -- producer side (serve loop) -----------------------------------------
    def submit(self, req, *, job_type: str = "retune",
               budget: Optional[int] = None) -> bool:
        """Enqueue unless the key already has an open job. ``req`` is
        anything with the ``RetuneRequest`` fields (key/objective/observed/
        predicted/reason/t). Commit-then-check: the append happens first and
        acceptance is judged on the read-back, so two submitters racing
        within one flush latency yield ONE accepted (canonical) job — the
        loser's record folds in as a coalesced duplicate of the winner's.
        Durable once this returns True."""
        self._refresh()
        key = str(req.key)
        if self._canonical(key) is not None:
            return False
        t = float(getattr(req, "t", 0.0) or self.clock())
        # full-precision timestamp in the id: %g truncates to 6 significant
        # digits, which at wall-clock magnitudes collides within hours and
        # would fold a fresh submit into an old done ticket
        d = {"kind": "job", "state": "submit",
             "id": f"{key}@{t!r}/{self.worker}", "key": key,
             "job_type": str(job_type),
             "objective": str(getattr(req, "objective", "")),
             "observed": float(getattr(req, "observed", float("nan"))),
             "predicted": float(getattr(req, "predicted", float("nan"))),
             "reason": str(getattr(req, "reason", "drift")),
             "t": t, "by": self.worker}
        if budget is not None:
            d["budget"] = int(budget)
        self._store.append_control(d)
        self._fold(d)
        self._refresh()                 # absorb racing submits
        canon = self._canonical(key)
        return canon is not None and canon.id == d["id"]

    # -- consumer side (daemons) --------------------------------------------
    def claim(self) -> Optional[JobTicket]:
        """Claim the oldest claimable job under a fenced lease. Returns the
        canonical ticket with ``ticket.token`` set, or None when nothing is
        claimable (or every race this round was lost)."""
        self._refresh()
        now = self.clock()
        seen_keys: set = set()
        order: List[JobTicket] = []
        for tk in sorted((t for t in self._tickets.values()
                          if not t.terminal),
                         key=lambda t: (t.t, t.id)):
            if tk.key not in seen_keys:
                seen_keys.add(tk.key)
                order.append(tk)
        for canon in order:
            got = self._try_claim(canon, now)
            if got is not None:
                return got
        return None

    def _burned_claims(self, key: str, now: float) -> int:
        """Consecutive claimants this group has eaten: unreleased tokened
        claims whose leases expired without a ``done``. Voluntary releases
        (aborted racers, graceful shutdowns) never count — only leases
        that silently died."""
        return sum(1 for tk in self._group(key) for c in tk.claims
                   if c.token > 0 and not c.released
                   and now - c.seen > self.claim_ttl)

    def _try_claim(self, canon: JobTicket, now: float) -> Optional[JobTicket]:
        key = canon.key
        if self._lease(key, now) is not None:
            return None
        if self.quarantine_after > 0 \
                and self._burned_claims(key, now) >= self.quarantine_after:
            self._quarantine(canon, now)
            return None
        # tokens visible BEFORE our claim: the post-append check may only
        # back off for a lower-token claim that was NOT in this snapshot
        # (an unseen racer) — backing off for an already-expired one would
        # deadlock the key
        pre = {c.token for tk in self._group(key) for c in tk.claims}
        floor = max(self._token_floor.get(key, 0), max(pre, default=0))
        token = self._fence.issue(key, floor=floor, by=self.worker)
        if token is None:
            return None                 # lost the marker race this instant
        d = {"kind": "job", "state": "claim", "id": canon.id, "key": key,
             "by": self.worker, "t": float(now), "token": token}
        self._store.append_control(d)
        self._fold(d)
        self._refresh()                 # absorb racing claims
        claims = [c for tk in self._group(key) for c in tk.claims]
        top = max((c.token for c in claims), default=token)
        check_now = self.clock()
        stolen = any(c.token < token and c.token not in pre
                     and not self._expired(c, check_now) for c in claims)
        if top > token or self._fence.highest(key) > token or stolen:
            # superseded (a higher token exists) or we fenced out a live
            # claim we never saw: release so arbitration need not wait out
            # our TTL, and back off. In every interleaving at most one
            # contender passes this check (see module docstring).
            self._release(canon.id, key, token)
            return None
        tk = self._tickets.get(canon.id)
        if tk is None or tk.done:
            self._release(canon.id, key, token)
            return None
        tk.token = token
        tk.dup_ids = [g.id for g in self._group(key) if g.id != tk.id]
        return tk

    def _quarantine(self, canon: JobTicket, now: float) -> None:
        """Close a poison group terminally: take a FRESH fencing token
        (permanently fencing every dead claimant out, exactly as a new
        claim would) and append a ``quarantine`` record per open submit id,
        coalescing like ``done``. Losing the token race is fine — the
        winner either services the job or reaches this same verdict."""
        key = canon.key
        pre = {c.token for tk in self._group(key) for c in tk.claims}
        floor = max(self._token_floor.get(key, 0), max(pre, default=0))
        token = self._fence.issue(key, floor=floor, by=self.worker)
        if token is None:
            return
        for cid in [g.id for g in self._group(key)]:
            d = {"kind": "job", "state": "quarantine", "id": cid,
                 "key": key, "by": self.worker, "t": float(now),
                 "token": token}
            self._store.append_control(d)
            self._fold(d)

    def _release(self, rid: str, key: str, token: int) -> None:
        self._fence.release(key, token)
        d = {"kind": "job", "state": "release", "id": rid, "key": key,
             "by": self.worker, "t": float(self.clock()), "token": token}
        self._store.append_control(d)
        self._fold(d)

    def release(self, ticket) -> None:
        """Voluntarily give a claimed job back (service failed, shutting
        down): the lease drops immediately instead of waiting out the TTL."""
        if ticket is None or not getattr(ticket, "token", 0):
            return
        self._release(ticket.id, ticket.key, int(ticket.token))

    def done(self, ticket) -> None:
        """Mark a claimed job serviced; the key re-arms for new submissions.
        ``ticket`` is a JobTicket or an id string.

        Fenced: if the caller's lease token has been superseded (the daemon
        paused past ``claim_ttl`` and another claimed the job), raises
        ``FencedClaimError`` — and even a done append that slips through is
        rejected by every fold (queue instances, compaction GC).

        Coalesces: every open duplicate submit of the same key is closed
        too — one service satisfies them all (drift after the swap re-arms
        fresh)."""
        rid = ticket if isinstance(ticket, str) else ticket.id
        token = 0 if isinstance(ticket, str) else int(
            getattr(ticket, "token", 0) or 0)
        self._refresh()
        tk = self._tickets.get(rid)
        if tk is None or tk.terminal:
            # idempotent no-op: the group this ticket belonged to is already
            # closed (or GC'd by compaction). Critically, do NOT fall through
            # to the coalescing append — the key may have re-armed with a NEW
            # generation of submits this stale ticket must not close.
            return
        key = tk.key
        group = self._group(key)
        top = self._group_top(key)
        now = float(self.clock())
        if token:
            if top > token:
                raise FencedClaimError(
                    f"done({rid!r}) under token {token} but the lease moved "
                    f"to token {top}: this claimant was fenced out "
                    f"(claim_ttl={self.claim_ttl:g}s elapsed on a reader's "
                    "clock and the job was re-claimed)")
        elif top > 0:
            holder = next((c for g in group for c in g.claims
                           if c.token == top), None)
            if holder is not None and holder.by != self.worker \
                    and not self._expired(holder, now):
                raise FencedClaimError(
                    f"done({rid!r}) without a token while {holder.by!r} "
                    f"holds the live lease (token {top})")
            token = top if holder is not None \
                and holder.by == self.worker else 0
        close = [rid] + [g.id for g in group if g.id != rid]
        for cid in close:
            d = {"kind": "job", "state": "done", "id": cid, "key": key,
                 "by": self.worker, "t": now}
            if token:
                d["token"] = token
            self._store.append_control(d)
            self._fold(d)

    # -- introspection ------------------------------------------------------
    def open_tickets(self) -> List[JobTicket]:
        """Canonical open ticket per key (duplicates coalesced into
        ``dup_ids``), oldest first."""
        self._refresh()
        out: List[JobTicket] = []
        for key in {tk.key for tk in self._tickets.values()
                    if not tk.terminal}:
            grp = self._group(key)
            if grp:
                grp[0].dup_ids = [g.id for g in grp[1:]]
                out.append(grp[0])
        return sorted(out, key=lambda tk: (tk.t, tk.id))

    def __len__(self) -> int:
        return len(self.open_tickets())

    def close(self) -> None:
        if self._owns_store:               # never close a shared appender
            self._store.close()


#: legacy alias — the single-daemon queue, now fleet-safe
DurableRetuneQueue = TuningJobQueue
