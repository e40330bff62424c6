"""Segment compaction / GC: rewrite-and-swap that keeps live tails honest
(DESIGN.md §13).

Port of ``repro/store/compact.py``, copied whole.

An append-only store only ever grows; compaction folds the *sealed*
segments of a directory store — every segment except each writer pid's
highest-numbered one, which may still be held open by a live appender —
into a single ``segment-0-<gen>.jsonl``, dropping what retention allows:

  * superseded ``context="prod"`` telemetry past the retention window
    (a later measurement of the same (fingerprint, config) exists), so
    serving writeback is bounded by the number of distinct configs served
    rather than the number of decode steps;
  * completed tuning-job control groups (``kind="job"`` — and legacy
    ``kind="retune"`` — submit/claim/done groups whose *accepted* ``done``
    landed before the window; a ``done`` from a fenced-out claimant never
    counts as completion).

Everything else — tuning observations, fingerprint descriptors, open
job requests — survives verbatim, so resolution (``best_sharding_config``,
``HotConfigSource``) is identical before and after.

The swap is crash-safe and watcher-safe:

  1. the compacted segment is written complete to a temp name and renamed
     into place (atomic; its first line is a ``kind="compact"`` header
     naming the folded sources, and every copied record carries a
     ``src=[[segment, byte_offset], ...]`` provenance chain — one hop per
     compaction it has survived);
  2. only then are the source files unlinked.

A concurrent ``StoreWatcher`` keeps exactly-once delivery through the swap:
``segment-0-*`` sorts before every live segment, so a watcher meets the
header before it could touch a folded source again, retires those tails,
and checks the ``src`` hops against each incarnation's consumed byte
frontier to deliver precisely the records it had not yet seen. A crash between rename
and unlink leaves records duplicated on disk but NOT double-delivered to
watchers (the header retires the sources first); re-running compaction
converges. Single-file stores have no sealed segments and cannot be
compacted.

"Sealed" is judged per writer pid (everything below the pid's
highest-numbered segment), so it assumes at most one LIVE appender per
process: a process holding several open appenders on one store must close
(seal) all but its newest before compaction may run — the loop-sim's
``seal_segment`` models exactly that.

One-compactor-at-a-time is ENFORCED, not assumed: the compactor takes a
fencing-token lock on the reserved key ``__compactor__``
(``repro_torch.store.fence``) before scanning, re-validates it immediately before
the swap, and releases it when done. A second compactor raises
``CompactionLocked`` while the lock is fresh; a compactor that died holding
the lock is taken over once its holder stamp is older than ``lock_ttl`` —
takeover issues the NEXT token (markers are never deleted and re-created),
so a taken-over zombie that wakes finds its token superseded at the
pre-swap check and aborts instead of double-swapping.
"""
from __future__ import annotations

import json
import math
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.store.fence import FenceRegistry
from repro_torch.store.index import build_index, iter_complete_lines, write_index
from repro_torch.store.records import (_is_single_file, _segment_high_water,
                                 list_segments)

_SEG_RE = re.compile(r"segment-(\d+)-(\d+)\.jsonl$")

#: reserved fence key of the store-wide compaction lock
COMPACT_LOCK_KEY = "__compactor__"


class CompactionLocked(RuntimeError):
    """Another compactor holds (or just took over) the compaction lock."""


def _acquire_compact_lock(reg: FenceRegistry, t_now: float,
                          lock_ttl: float) -> int:
    """Take the compaction lock or raise ``CompactionLocked``. A live lock
    is one whose token is unreleased and whose holder stamp is younger than
    ``lock_ttl``; anything else is stale and taken over by issuing the next
    token (never by deleting the old marker — the unlink/recreate race
    would let a second taker remove a FRESH lock)."""
    cur = reg.highest(COMPACT_LOCK_KEY)
    if cur and not reg.released(COMPACT_LOCK_KEY, cur):
        holder = reg.holder(COMPACT_LOCK_KEY, cur) or {}
        age = t_now - float(holder.get("t", -math.inf))
        if age <= lock_ttl:
            raise CompactionLocked(
                f"compaction lock (token {cur}) held by "
                f"{holder.get('by', '?')!r}, {age:.0f}s old "
                f"(lock_ttl={lock_ttl:g}s)")
    token = reg.issue(COMPACT_LOCK_KEY, floor=cur,
                      by=f"compactor-{os.getpid()}")
    if token is None:
        raise CompactionLocked("lost the compaction-lock takeover race")
    return token


@dataclass
class CompactionStats:
    """What one ``compact_store`` call did."""

    sources: List[str] = field(default_factory=list)
    output: Optional[str] = None
    records_in: int = 0
    records_kept: int = 0
    dropped_prod: int = 0
    dropped_retune: int = 0
    bytes_before: int = 0
    bytes_after: int = 0

    @property
    def folded(self) -> bool:
        return self.output is not None


def _parse_seg(name: str) -> Optional[Tuple[int, int]]:
    m = _SEG_RE.match(name)
    return (int(m.group(1)), int(m.group(2))) if m else None


def compact_store(path: str, *, retention_s: float = math.inf,
                  now: Optional[float] = None,
                  clock=time.time, lock_ttl: float = 3600.0
                  ) -> CompactionStats:
    """Fold the sealed segments of a directory store. ``retention_s`` bounds
    the GC window (default: keep everything — pure folding); ``now`` pins
    the window edge for deterministic tests. One compactor at a time,
    enforced: raises ``CompactionLocked`` while another holds the lock
    (stale holders — older than ``lock_ttl`` — are taken over)."""
    if _is_single_file(path):
        raise ValueError("compaction requires a directory store "
                         "(a single-file journal is one live segment)")
    t_now = clock() if now is None else float(now)
    reg = FenceRegistry(path, clock=lambda: t_now)
    lock = _acquire_compact_lock(reg, t_now, float(lock_ttl))
    try:
        return _compact_locked(path, retention_s, t_now, reg, lock)
    finally:
        reg.release(COMPACT_LOCK_KEY, lock)


def _compact_locked(path: str, retention_s: float, t_now: float,
                    reg: FenceRegistry, lock: int) -> CompactionStats:
    stats = CompactionStats()
    segs = [(seg, _parse_seg(os.path.basename(seg)))
            for seg in list_segments(path, False)]
    active: Dict[int, int] = {}
    for _, parsed in segs:
        if parsed and parsed[0] != 0:
            active[parsed[0]] = max(active.get(parsed[0], -1), parsed[1])
    sources = [seg for seg, parsed in segs
               if parsed and (parsed[0] == 0 or parsed[1] < active[parsed[0]])]
    if not sources:
        return stats
    stats.sources = [os.path.basename(s) for s in sources]

    # -- scan the sources: descriptors, surviving candidates, high water ----
    high_water: Dict[int, int] = {}
    fps: Dict[str, dict] = {}
    entries: List[Tuple[str, int, dict]] = []     # (src_name, line_no, dict)
    for seg in sources:
        name = os.path.basename(seg)
        pid, k = _parse_seg(name)
        high_water[pid] = max(high_water.get(pid, -1), k)
        stats.bytes_before += os.path.getsize(seg)
        for offset, nbytes, raw in iter_complete_lines(seg):
            text = raw.decode("utf-8").strip()
            if not text:
                continue
            d = json.loads(text)
            kind = d.get("kind")
            if kind == "compact":
                for p, hk in d.get("high_water", {}).items():
                    p = int(p)
                    high_water[p] = max(high_water.get(p, -1), int(hk))
            elif kind == "fp":
                fps.setdefault(d["digest"], d)
            else:
                entries.append((name, offset, d))
    stats.records_in = len(entries)

    # -- GC decisions -------------------------------------------------------
    prod_digests = {dg for dg, d in fps.items()
                    if d.get("context") == "prod"}
    # superseded = a LATER record for the same (fingerprint, config index)
    # exists among the folded sources (idx None — configless telemetry —
    # supersedes per fingerprint, bounding defaults journaling too)
    last_at: Dict[Tuple[str, Optional[int]], int] = {}
    # job/retune groups are replayed with the queue's own fencing fold: a
    # ``done`` only closes its id if its token is not below the group's
    # highest UNRELEASED claim token at that point — a fenced-out
    # claimant's late ``done`` must not let GC fold away a job another
    # daemon is servicing, while a racer that backed off (claim + release)
    # must not fence the winner it deferred to
    job_done_t: Dict[str, float] = {}
    open_ids: Dict[str, Set[str]] = {}       # key -> open submit ids
    group_claims: Dict[str, Set[int]] = {}   # key -> unreleased claim tokens
    for i, (_, _, d) in enumerate(entries):
        kind = d.get("kind")
        if kind == "obs" and d.get("fp") in prod_digests:
            last_at[(d["fp"], d.get("idx"))] = i
            continue
        if kind not in ("retune", "job"):
            continue
        state, rid = d.get("state"), str(d.get("id", ""))
        key = str(d.get("key", ""))
        if state == "submit":
            open_ids.setdefault(key, set()).add(rid)
        elif state == "claim":
            if rid in open_ids.get(key, ()):
                group_claims.setdefault(key, set()).add(
                    int(d.get("token") or 0))
        elif state == "release":
            group_claims.get(key, set()).discard(int(d.get("token") or 0))
        elif state in ("done", "quarantine"):
            # quarantine is terminal exactly like done (a fresh-token close
            # of a poison group) — same fencing, same retention folding
            token = d.get("token")
            if token is not None \
                    and int(token) < max(group_claims.get(key, ()),
                                         default=0):
                continue                     # fenced: does not close the job
            if rid in open_ids.get(key, ()):
                open_ids[key].discard(rid)
                if not open_ids[key]:
                    group_claims.pop(key, None)  # group closed: fresh fences
            job_done_t[rid] = max(job_done_t.get(rid, 0.0),
                                  float(d.get("t", 0.0)))
    dead_jobs = {rid for rid, t in job_done_t.items()
                 if t < t_now - retention_s}
    kept: List[Tuple[str, int, dict]] = []
    for i, (src, offset, d) in enumerate(entries):
        kind = d.get("kind")
        if kind == "obs" and d.get("fp") in prod_digests \
                and last_at[(d["fp"], d.get("idx"))] != i \
                and float(d.get("t", 0.0)) < t_now - retention_s:
            stats.dropped_prod += 1
            continue
        if kind in ("retune", "job") and d.get("id", "") in dead_jobs:
            stats.dropped_retune += 1
            continue
        kept.append((src, offset, d))
    stats.records_kept = len(kept)

    # -- rewrite and swap ---------------------------------------------------
    hw_disk = _segment_high_water(path)
    gen = max(high_water.get(0, -1), hw_disk.get(0, -1)) + 1
    out_name = f"segment-0-{gen}.jsonl"
    out_path = os.path.join(path, out_name)
    tmp = out_path + ".tmp"
    merged_hw = dict(hw_disk)
    for p, hk in high_water.items():
        merged_hw[p] = max(merged_hw.get(p, -1), hk)
    with open(tmp, "w") as f:
        f.write(json.dumps({
            "kind": "compact", "v": 1, "gen": gen, "t": t_now,
            "lock": lock, "sources": stats.sources,
            "high_water": {str(p): hk for p, hk in
                           sorted(merged_hw.items())}}) + "\n")
        for digest in sorted(fps):
            f.write(json.dumps(fps[digest]) + "\n")
        for src, offset, d in kept:
            d = dict(d)
            # provenance CHAIN, one hop per survived compaction: a watcher
            # skips a record if ANY prior incarnation was already consumed
            # — a single hop is not enough when a compacted segment is
            # folded again before some watcher ever read it
            prior = d.get("src") or []
            d["src"] = list(prior) + [[src, offset]]
            f.write(json.dumps(d) + "\n")
        f.flush()
        os.fsync(f.fileno())
    # pre-swap revalidation: if a peer judged us stale and took the lock
    # over while we scanned, OUR view of the sources is the stale one —
    # abort rather than race the new holder's swap
    if reg.highest(COMPACT_LOCK_KEY) != lock \
            or reg.released(COMPACT_LOCK_KEY, lock):
        os.unlink(tmp)
        raise CompactionLocked(
            f"compaction lock token {lock} superseded mid-compaction "
            "(this compactor was presumed dead and taken over)")
    os.replace(tmp, out_path)          # the swap: compacted data is visible
    for seg in sources:                # only now may the sources disappear
        os.unlink(seg)
    stats.output = out_name
    stats.bytes_after = os.path.getsize(out_path)
    write_index(path, build_index(path))   # keep lazy opens O(hot set)
    return stats
