"""Persistent tuning-record store (DESIGN.md §11).

One schema for every observation the system produces — engine journals,
benchmark runs, golden traces, dry-run compile tunings. Records are
append-only JSONL, keyed by a ``SpaceFingerprint``: the identity of a tuning
problem (parameter grid, restriction signature, objective id, device
context). The store is the substrate for checkpoint/resume (a run's journal
is the ordered record stream of its ``run`` id) and for transfer-aware
warm starts (``repro_torch.store.transfer`` matches prior records — exact
fingerprint or compatible-dims cross-size — into a new run).

Layout:
  * directory mode — ``<path>/segment-*.jsonl``, one segment per writer;
    shared store across runs/benchmarks;
  * single-file mode — ``<path>`` ends in ``.json``/``.jsonl``: the whole
    store is one segment. This is what a per-run checkpoint path becomes
    (the legacy whole-journal-rewrite JSON format is migrated in place by
    ``repro_torch.store.migrate``).

Each line is either a fingerprint descriptor (``kind: fp`` — written once
per digest per segment, making segments self-contained) or an observation
(``kind: obs``). Appends are flushed per record, so a killed run leaves a
valid record-stream prefix; a torn final line is tolerated on load. Two
further kinds are control plane, not observations: ``kind: compact``
(compaction headers, the reference's ``repro.store.compact``) and
``kind: job`` / ``kind: retune`` (the durable tuning-job queue,
``repro.store.queue``; ``retune`` is the queue's legacy single-daemon
spelling) — the loader skips all of them, so stores the reference's fleet
tooling wrote stay readable here.

Open modes:
  * ``load=True`` (default) — parse every segment into memory; right for
    small stores and for whole-store consumers;
  * ``load=False`` — write-only appender, O(1) startup;
  * ``lazy=True`` — read only the sidecar segment index
    (``repro_torch.store.index``, rebuilt on demand when stale or missing) plus
    any bytes appended past it, and materialize a fingerprint's records
    only when a caller touches that digest: O(hot set) opens on
    fleet-scale stores. Queries answer from the open-time snapshot, the
    same visibility ``load=True`` gives.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.searchspace import SearchSpace

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class SpaceFingerprint:
    """Identity of a tuning problem: dims + restrictions + objective + device.

    ``params`` stores each parameter's ordered value grid as strings, so a
    fingerprint is JSON-stable and can renormalize configs from *its own*
    grid without reconstructing a SearchSpace — which is what makes
    cross-size transfer possible from records alone.
    """

    params: Tuple[Tuple[str, Tuple[str, ...]], ...]
    size: int                    # kept configs (captures the filter effect)
    cartesian: int
    restrictions: Tuple[str, ...]
    objective: str               # objective id, e.g. "expdist@a100"
    context: str = ""            # device/deployment context

    @cached_property
    def digest(self) -> str:
        blob = json.dumps([list(map(list, self.params)), self.size,
                           self.cartesian, list(self.restrictions),
                           self.objective, self.context])
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    @classmethod
    def of(cls, space: SearchSpace, objective: str = "",
           context: str = "") -> "SpaceFingerprint":
        return cls(
            params=tuple((p.name, tuple(str(v) for v in p.values))
                         for p in space.params),
            size=int(space.size), cartesian=int(space.cartesian_size),
            restrictions=tuple(
                getattr(c, "name", getattr(c, "__name__", "<restriction>"))
                for c in space.constraints),
            objective=str(objective), context=str(context))

    def compatible(self, other: "SpaceFingerprint") -> bool:
        """Cross-size transferable: same parameter names in the same order
        (the value grids — and so the space sizes — may differ)."""
        return (self.param_names == other.param_names
                and len(self.params) > 0)

    @property
    def param_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.params)

    def x_norm(self, config: Dict[str, Any]) -> Optional[np.ndarray]:
        """Ordinal-normalized position of ``config`` under THIS fingerprint's
        grids (value j of n -> j/(n-1), n==1 -> 0.5); None when a value is
        not on the grid."""
        out = np.empty(len(self.params), np.float32)
        for j, (name, values) in enumerate(self.params):
            if name not in config:
                return None
            try:
                k = values.index(str(config[name]))
            except ValueError:
                return None
            out[j] = 0.5 if len(values) == 1 else k / (len(values) - 1)
        return out

    def to_json(self) -> Dict[str, Any]:
        return {"kind": "fp", "v": SCHEMA_VERSION, "digest": self.digest,
                "params": [[n, list(vs)] for n, vs in self.params],
                "size": self.size, "cartesian": self.cartesian,
                "restrictions": list(self.restrictions),
                "objective": self.objective, "context": self.context}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SpaceFingerprint":
        return cls(params=tuple((n, tuple(vs)) for n, vs in d["params"]),
                   size=int(d["size"]), cartesian=int(d["cartesian"]),
                   restrictions=tuple(d["restrictions"]),
                   objective=d["objective"], context=d.get("context", ""))


@dataclass
class TuningRecord:
    """One observation: what was evaluated, under which problem identity."""

    fp: str                      # SpaceFingerprint digest
    run: str                     # journal stream id (strategy/seed/run tag)
    seq: int                     # acceptance-order position within the run
    key: str                     # unique evaluation key (space idx or cfg:)
    idx: Optional[int]           # config index (None outside the space)
    value: float                 # objective value, NaN = invalid
    af: Optional[str] = None
    config: Optional[Dict[str, Any]] = None
    worker: str = "main"
    dur: float = 0.0
    t: float = 0.0
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "kind": "obs", "fp": self.fp, "run": self.run, "seq": self.seq,
            "key": self.key, "idx": self.idx,
            "value": None if not math.isfinite(self.value) else self.value,
            "af": self.af}
        if self.config is not None:
            d["config"] = self.config
        if self.worker != "main":
            d["worker"] = self.worker
        if self.dur:
            d["dur"] = self.dur
        if self.t:
            d["t"] = self.t
        if self.meta:
            d["meta"] = self.meta
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TuningRecord":
        v = d.get("value")
        return cls(fp=d["fp"], run=d["run"], seq=int(d.get("seq", 0)),
                   key=d["key"],
                   idx=None if d.get("idx") is None else int(d["idx"]),
                   value=math.nan if v is None else float(v),
                   af=d.get("af"), config=d.get("config"),
                   worker=d.get("worker", "main"),
                   dur=float(d.get("dur", 0.0)), t=float(d.get("t", 0.0)),
                   meta=d.get("meta", {}))


def _is_single_file(path: str) -> bool:
    return path.endswith((".json", ".jsonl"))


def natural_key(name: str) -> Tuple:
    """Digit-aware sort key: ``segment-<pid>-10`` after ``segment-<pid>-2``
    (plain lexicographic order breaks past ten rollovers of one writer)."""
    return tuple(int(tok) if tok.isdigit() else tok
                 for tok in re.split(r"(\d+)", name))


def list_segments(path: str, single_file: bool) -> List[str]:
    """A store's segment files in rollover order — the one definition both
    the loader and the live watcher must agree on."""
    if single_file:
        return [path] if os.path.exists(path) else []
    if not os.path.isdir(path):
        return []
    names = sorted((f for f in os.listdir(path) if f.endswith(".jsonl")),
                   key=natural_key)
    return [os.path.join(path, f) for f in names]


def _segment_high_water(path: str) -> Dict[int, int]:
    """Highest segment number ever FOLDED per writer pid, read from the
    compaction headers of ``segment-0-*.jsonl`` outputs. Compaction deletes
    its source files; a writer that restarted its numbering below the high
    water would reuse a deleted name and corrupt concurrent watcher tails,
    so ``_handle`` starts new segments past it. Headers carry the merged
    high water of everything they transitively folded, so one header level
    is enough."""
    hw: Dict[int, int] = {}
    if not os.path.isdir(path):
        return hw
    for name in os.listdir(path):
        if not re.match(r"segment-0-\d+\.jsonl$", name):
            continue
        try:
            with open(os.path.join(path, name)) as f:
                d = json.loads(f.readline())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(d, dict) or d.get("kind") != "compact":
            continue
        for pid, k in d.get("high_water", {}).items():
            try:
                pid = int(pid)
            except ValueError:
                continue
            hw[pid] = max(hw.get(pid, -1), int(k))
    return hw


class TuningRecordStore:
    """Append-only JSONL segments + in-memory index by fingerprint digest."""

    def __init__(self, path: str, *, load: bool = True, lazy: bool = False):
        """``load=False`` opens a write-only appender: no segment parse, no
        in-memory index — O(1) startup however large the store has grown.
        For producers that only ever ``append`` (serving telemetry); queries
        on such an instance see only its own appends. ``lazy=True`` opens
        through the sidecar segment index instead (``repro_torch.store.index``):
        O(index + un-indexed tail) startup, per-digest materialization on
        first touch, identical query results on an unchanged store."""
        self.path = path
        self.single_file = _is_single_file(path)
        self.lazy = bool(lazy)
        self.bytes_read = 0                # data-plane bytes this instance read
        self._records: List[TuningRecord] = []
        self._by_fp: Dict[str, List[int]] = {}
        self._fps: Dict[str, SpaceFingerprint] = {}
        self._fh = None                    # lazy append handle
        self._written_fps: set = set()     # descriptors this handle has written
        # lazy-mode state: sidecar index, open-time tail scan, per-digest
        # materialization cache, and this instance's own appends
        self._index = None
        self._tail: Dict[str, Dict[str, List[TuningRecord]]] = {}
        self._tail_total = 0
        self._mat: Dict[str, List[TuningRecord]] = {}
        self._appended_by_fp: Dict[str, List[TuningRecord]] = {}
        self._appended_total = 0
        if self.lazy:
            self._open_lazy()
        elif load:
            self._load()

    # -- loading ------------------------------------------------------------
    def _segments(self) -> List[str]:
        return list_segments(self.path, self.single_file)

    def _load(self) -> None:
        for seg in self._segments():
            with open(seg) as f:
                data = f.read()
            self.bytes_read += len(data)
            lines = data.splitlines()
            for k, line in enumerate(lines):
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    if k == len(lines) - 1:
                        break   # torn final line from a killed writer
                    raise ValueError(
                        f"{seg}:{k + 1}: corrupt record line — if this is a "
                        "legacy engine checkpoint, migrate it with "
                        "repro_torch.store.migrate.migrate_checkpoint")
                self._ingest(d, seg, k)

    def _ingest(self, d: Dict[str, Any], seg: str, lineno: int) -> None:
        kind = d.get("kind")
        if kind == "fp":
            fp = SpaceFingerprint.from_json(d)
            self._fps.setdefault(fp.digest, fp)
        elif kind == "obs":
            rec = TuningRecord.from_json(d)
            self._by_fp.setdefault(rec.fp, []).append(len(self._records))
            self._records.append(rec)
        elif kind in ("compact", "retune", "job"):
            pass    # control plane: compaction headers / durable job queue
        else:
            raise ValueError(
                f"{seg}:{lineno + 1}: unknown record kind {kind!r} — if this "
                "is a legacy engine checkpoint, migrate it with "
                "repro_torch.store.migrate.migrate_checkpoint")

    # -- lazy (indexed) loading ---------------------------------------------
    def _open_lazy(self) -> None:
        """Load the sidecar index (rebuilding it when stale/missing), then
        scan only the bytes appended past each segment's indexed frontier.
        A freshly indexed store opens by reading the index alone."""
        from repro_torch.store import index as sidx
        idx = sidx.load_index(self.path)
        if idx is not None:
            try:
                self.bytes_read += os.path.getsize(sidx.index_path(self.path))
            except OSError:
                pass
        if idx is None or sidx.index_is_stale(self.path, idx):
            idx = sidx.build_index(self.path)
            for seg in self._segments():
                self.bytes_read += idx.segments.get(os.path.basename(seg), 0)
            sidx.write_index(self.path, idx)    # best-effort sidecar refresh
            self._index = idx
            self._fps = {**idx.fps, **self._fps}
            return
        self._index = idx
        self._fps = {**idx.fps, **self._fps}
        for seg in self._segments():
            name = os.path.basename(seg)
            start = idx.segments.get(name, 0)
            if os.path.getsize(seg) <= start:
                continue
            per_fp = self._tail.setdefault(name, {})
            for offset, nbytes, raw in sidx.iter_complete_lines(seg, start):
                self.bytes_read += nbytes
                text = raw.decode("utf-8").strip()
                if not text:
                    continue
                d = json.loads(text)
                kind = d.get("kind")
                if kind == "fp":
                    fp = SpaceFingerprint.from_json(d)
                    self._fps.setdefault(fp.digest, fp)
                elif kind == "obs":
                    rec = TuningRecord.from_json(d)
                    per_fp.setdefault(rec.fp, []).append(rec)
                    self._tail_total += 1

    def _segment_path(self, name: str) -> str:
        return self.path if self.single_file else os.path.join(self.path,
                                                               name)

    def _read_extent(self, extent, digest: str) -> List[TuningRecord]:
        seg = self._segment_path(extent.segment)
        with open(seg, "rb") as f:
            f.seek(extent.offset)
            data = f.read(extent.length)
        self.bytes_read += len(data)
        out: List[TuningRecord] = []
        for raw in data.split(b"\n"):
            text = raw.decode("utf-8").strip()
            if not text:
                continue
            d = json.loads(text)
            if d.get("kind") == "obs" and d.get("fp") == digest:
                out.append(TuningRecord.from_json(d))
        return out

    def _materialize(self, digest: str) -> List[TuningRecord]:
        """This digest's records from disk (indexed extents + open-time tail),
        in global append order; cached. Own appends are tracked separately
        (``_appended_by_fp``) so they are never double-counted. If a
        compaction swapped segments out from under this snapshot, the open
        is redone against the rewritten store and the read retried —
        compaction preserves every non-GC'd record, so the answer is the
        same."""
        if digest in self._mat:
            return self._mat[digest]
        try:
            return self._materialize_uncached(digest)
        except FileNotFoundError:
            self._reopen_lazy()
            return self._materialize_uncached(digest)

    def _reopen_lazy(self) -> None:
        """Drop the open-time snapshot and re-open against the rewritten
        store. Own appends were flushed, so the fresh snapshot covers them
        from disk — the append-side bookkeeping must reset with the rest or
        they would be counted twice."""
        self._tail, self._tail_total, self._mat = {}, 0, {}
        self._appended_by_fp, self._appended_total = {}, 0
        self._open_lazy()

    def refresh(self) -> None:
        """Re-snapshot a lazy store: appends landed by other processes
        since open become visible and a concurrent compaction is absorbed.
        Long-lived lazy consumers (the retune daemon) call this between
        units of work; no-op in the other modes."""
        if self.lazy:
            self._reopen_lazy()

    def _materialize_uncached(self, digest: str) -> List[TuningRecord]:
        ext_by_seg: Dict[str, list] = {}
        for e in self._index.extents.get(digest, ()):
            ext_by_seg.setdefault(e.segment, []).append(e)
        names = sorted(set(ext_by_seg) | set(self._tail), key=natural_key)
        rows: List[TuningRecord] = []
        for name in names:
            for e in ext_by_seg.get(name, ()):
                rows.extend(self._read_extent(e, digest))
            rows.extend(self._tail.get(name, {}).get(digest, ()))
        self._mat[digest] = rows
        return rows

    def _scan_all(self) -> List[TuningRecord]:
        """Every observation on disk right now, in full-load order — the
        lazy store's fallback for whole-store queries (``records()`` with no
        digest). Own appends were flushed, so they are on disk too."""
        from repro_torch.store import index as sidx
        rows: List[TuningRecord] = []
        for seg in self._segments():
            for offset, nbytes, raw in sidx.iter_complete_lines(seg):
                self.bytes_read += nbytes
                text = raw.decode("utf-8").strip()
                if not text:
                    continue
                d = json.loads(text)
                if d.get("kind") == "obs":
                    rows.append(TuningRecord.from_json(d))
        return rows

    # -- appending ----------------------------------------------------------
    def _handle(self):
        if self._fh is None:
            if self.single_file:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._fh = open(self.path, "a")
            else:
                os.makedirs(self.path, exist_ok=True)
                # start past both the segments on disk AND any compaction
                # high water: reusing a folded (deleted) segment name would
                # corrupt concurrent watcher tails
                k = _segment_high_water(self.path).get(os.getpid(), -1) + 1
                while True:
                    seg = os.path.join(self.path,
                                       f"segment-{os.getpid()}-{k}.jsonl")
                    if not os.path.exists(seg):
                        break
                    k += 1
                self._fh = open(seg, "a")
        return self._fh

    def register(self, fp: SpaceFingerprint) -> str:
        """Record a fingerprint descriptor (idempotent). Returns the digest."""
        if fp.digest not in self._written_fps:
            self._handle().write(json.dumps(fp.to_json()) + "\n")
            self._handle().flush()
            self._written_fps.add(fp.digest)
        self._fps.setdefault(fp.digest, fp)
        return fp.digest

    def append(self, rec: TuningRecord,
               fingerprint: Optional[SpaceFingerprint] = None) -> None:
        """Append one observation; flushes so crashes leave a valid prefix."""
        if fingerprint is not None:
            if rec.fp and rec.fp != fingerprint.digest:
                raise ValueError(f"record fp {rec.fp} != fingerprint "
                                 f"{fingerprint.digest}")
            rec.fp = fingerprint.digest
            self.register(fingerprint)
        if rec.fp not in self._fps:
            raise ValueError(f"unknown fingerprint {rec.fp!r}: register the "
                             "descriptor first (append(rec, fingerprint=...))")
        if rec.fp not in self._written_fps:
            self.register(self._fps[rec.fp])
        fh = self._handle()
        fh.write(json.dumps(rec.to_json()) + "\n")
        fh.flush()
        if self.lazy:
            self._appended_by_fp.setdefault(rec.fp, []).append(rec)
            self._appended_total += 1
        else:
            self._by_fp.setdefault(rec.fp, []).append(len(self._records))
            self._records.append(rec)

    def append_control(self, d: Dict[str, Any]) -> None:
        """Append one raw control record (``kind`` other than fp/obs) —
        the durable queue's write path. Flushed like observations."""
        fh = self._handle()
        fh.write(json.dumps(d) + "\n")
        fh.flush()

    def extend(self, recs: Iterable[TuningRecord],
               fingerprint: Optional[SpaceFingerprint] = None) -> None:
        for rec in recs:
            self.append(rec, fingerprint=fingerprint)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            self._written_fps = set()

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        if self.lazy:
            return self._index.total + self._tail_total + self._appended_total
        return len(self._records)

    def fingerprints(self) -> Dict[str, SpaceFingerprint]:
        return dict(self._fps)

    def fingerprint_info(self, digest: str) -> Optional[SpaceFingerprint]:
        return self._fps.get(digest)

    def records(self, fp: Optional[str] = None,
                run: Optional[str] = None) -> List[TuningRecord]:
        """Records in append order, optionally filtered by digest and/or run.
        On a lazy store, passing a digest reads only that digest's extents;
        ``fp=None`` falls back to a full segment scan (preserving the same
        global order a ``load=True`` open returns) — whole-store consumers
        should open with ``load=True`` instead."""
        if fp is not None:
            if self.lazy:
                rows: Sequence[TuningRecord] = (
                    self._materialize(fp) + self._appended_by_fp.get(fp, []))
            else:
                rows = [self._records[i] for i in self._by_fp.get(fp, ())]
        elif self.lazy:
            rows = self._scan_all()
        else:
            rows = self._records
        if run is not None:
            rows = [r for r in rows if r.run == run]
        return list(rows)

    def runs(self, fp: Optional[str] = None) -> List[str]:
        seen: Dict[str, None] = {}
        for r in self.records(fp=fp):
            seen.setdefault(r.run, None)
        return list(seen)

    def best(self, fp: str) -> Optional[TuningRecord]:
        """Best (lowest finite value) record for an exact fingerprint; the
        first record achieving the minimum wins, matching full-load order.
        On a lazy store whose digest has no un-indexed tail or own appends,
        this reads ONE extent: the first whose cached best equals the
        digest's minimum — earlier extents all have strictly worse bests,
        so their records cannot be the first achiever."""
        if self.lazy:
            return self._lazy_best(fp)
        best: Optional[TuningRecord] = None
        for i in self._by_fp.get(fp, ()):
            r = self._records[i]
            if math.isfinite(r.value) and (best is None
                                           or r.value < best.value):
                best = r
        return best

    @staticmethod
    def _first_min(rows: Sequence[TuningRecord]) -> Optional[TuningRecord]:
        best: Optional[TuningRecord] = None
        for r in rows:
            if math.isfinite(r.value) and (best is None
                                           or r.value < best.value):
                best = r
        return best

    def _lazy_best(self, fp: str) -> Optional[TuningRecord]:
        tail_or_appended = (fp in self._appended_by_fp or any(
            fp in per_fp for per_fp in self._tail.values()))
        if fp in self._mat or tail_or_appended:
            return self._first_min(self.records(fp=fp))
        exts = self._index.extents.get(fp, ())
        bests = [e.best for e in exts if e.best is not None]
        if not bests:
            return None
        m = min(bests)
        for e in exts:
            if e.best == m:
                try:
                    rows = self._read_extent(e, fp)
                except FileNotFoundError:
                    # compaction swapped the snapshot: reopen and fall back
                    self._reopen_lazy()
                    return self._lazy_best(fp)
                return self._first_min(rows)
        return None

    def best_config(self, fp) -> Optional[Tuple[Dict[str, Any], float]]:
        """(config, value) of the best prior evaluation for this problem.
        ``fp`` may be a SpaceFingerprint or a digest string. The serve/launch
        layer calls this before falling back to built-in defaults."""
        digest = fp.digest if isinstance(fp, SpaceFingerprint) else fp
        rec = self.best(digest)
        if rec is None or rec.config is None:
            return None
        return dict(rec.config), rec.value
