"""Sidecar segment index: O(hot-set) store opens (DESIGN.md §13).

A fleet-scale store holds millions of records across many segments; loading
all of them to answer "best config for one cell" is the scaling wall the
ROADMAP flags. The index is a JSON sidecar (``index.json`` inside a
directory store, ``<file>.index.json`` beside a single-file store) mapping

    digest -> [(segment, byte_offset, length, count, best_value), ...]

— contiguous byte extents of one fingerprint's lines within each segment —
plus per-segment indexed sizes and the fingerprint descriptors themselves.
``TuningRecordStore(path, lazy=True)`` opens by reading only the index,
scans just the bytes appended past each segment's indexed size (zero on a
freshly indexed store), and materializes a fingerprint's records only when
a caller touches that digest.

The index is a *cache*, never the truth: it is rebuilt from the segments on
demand when it is missing, unparsable (torn write), from a different
version, or references a segment that shrank or disappeared (compaction ran
without refreshing it). A segment that merely *grew* does not invalidate the
index — append-only writers extend segments, so the indexed prefix stays
valid and only the tail needs scanning. Writes are atomic
(tmp + ``os.replace``) and best-effort: a read-only store directory simply
keeps the index in memory.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.store.records import (SpaceFingerprint, _is_single_file,
                                 list_segments)

INDEX_VERSION = 1

#: record kinds that carry no observations: compaction headers and durable
#: control records (the tuning-job queue; ``retune`` is its legacy
#: single-daemon spelling) — cataloged separately or skipped
CONTROL_KINDS = ("compact", "retune", "job")


def index_path(store_path: str) -> str:
    """Where the sidecar lives. Inside a directory store it must not match
    the ``*.jsonl`` segment glob; beside a single-file store it must not
    itself look like a store."""
    if _is_single_file(store_path):
        return store_path + ".index.json"
    return os.path.join(store_path, "index.json")


def iter_complete_lines(seg: str, start: int = 0
                        ) -> Iterator[Tuple[int, int, bytes]]:
    """Yield ``(offset, nbytes, raw)`` for every COMPLETE (newline-terminated)
    line of ``seg`` from byte ``start``; a torn final line is not yielded —
    the same tolerance the loader and the watcher apply."""
    with open(seg, "rb") as f:
        f.seek(start)
        data = f.read()
    offset = start
    lines = data.split(b"\n")
    lines.pop()                        # b"" when data ends in a newline
    for raw in lines:
        yield offset, len(raw) + 1, raw
        offset += len(raw) + 1


@dataclass
class Extent:
    """A contiguous byte run of one digest's lines within one segment
    (descriptor + observation lines; ``count``/``best`` cover observations
    only). Runs of one tuning run's journal coalesce into a single extent;
    pathologically interleaved writers degrade to per-record extents, which
    is still correct, just a bigger sidecar."""

    segment: str                 # segment basename
    offset: int
    length: int
    count: int = 0
    best: Optional[float] = None     # min finite obs value, None if none

    def to_json(self) -> list:
        return [self.segment, self.offset, self.length, self.count, self.best]

    @classmethod
    def from_json(cls, row: list) -> "Extent":
        seg, offset, length, count, best = row
        return cls(segment=seg, offset=int(offset), length=int(length),
                   count=int(count),
                   best=None if best is None else float(best))


@dataclass
class StoreIndex:
    """Parsed sidecar: segment frontier + per-digest extents."""

    segments: Dict[str, int] = field(default_factory=dict)  # name -> bytes
    fps: Dict[str, SpaceFingerprint] = field(default_factory=dict)
    extents: Dict[str, List[Extent]] = field(default_factory=dict)
    controls: Dict[str, List[Extent]] = field(default_factory=dict)
    total: int = 0               # observation count over all extents

    def to_json(self) -> dict:
        return {"kind": "index", "v": INDEX_VERSION,
                "segments": self.segments,
                "fps": {d: fp.to_json() for d, fp in self.fps.items()},
                "extents": {d: [e.to_json() for e in exts]
                            for d, exts in self.extents.items()},
                "controls": {k: [e.to_json() for e in exts]
                             for k, exts in self.controls.items()},
                "total": self.total}

    @classmethod
    def from_json(cls, d: dict) -> "StoreIndex":
        return cls(
            segments={k: int(v) for k, v in d["segments"].items()},
            fps={dg: SpaceFingerprint.from_json(fd)
                 for dg, fd in d["fps"].items()},
            extents={dg: [Extent.from_json(r) for r in rows]
                     for dg, rows in d["extents"].items()},
            controls={k: [Extent.from_json(r) for r in rows]
                      for k, rows in d.get("controls", {}).items()},
            total=int(d["total"]))

    def best_value(self, digest: str) -> Optional[float]:
        vals = [e.best for e in self.extents.get(digest, ()) if
                e.best is not None]
        return min(vals) if vals else None


class _ExtentBuilder:
    """Coalesces consecutive same-key lines of one segment into extents."""

    def __init__(self, segment_name: str):
        self.segment = segment_name
        self.key: Optional[Tuple[str, str]] = None   # ("fp"|"ctl", id)
        self.cur: Optional[Extent] = None
        self.out: List[Tuple[Tuple[str, str], Extent]] = []

    def add(self, key: Tuple[str, str], offset: int, nbytes: int,
            value: Optional[float] = None, is_obs: bool = False) -> None:
        if self.cur is not None and key == self.key \
                and offset == self.cur.offset + self.cur.length:
            self.cur.length += nbytes
        else:
            self.flush()
            self.key = key
            self.cur = Extent(self.segment, offset, nbytes)
        if is_obs:
            self.cur.count += 1
            if value is not None and math.isfinite(value) \
                    and (self.cur.best is None or value < self.cur.best):
                self.cur.best = value

    def flush(self) -> None:
        if self.cur is not None:
            self.out.append((self.key, self.cur))
            self.cur, self.key = None, None


def scan_segment(seg: str, idx: StoreIndex, start: int = 0) -> int:
    """Index one segment's complete lines from ``start``; returns the byte
    frontier reached (the offset past the last complete line)."""
    name = os.path.basename(seg)
    builder = _ExtentBuilder(name)
    frontier = start
    for offset, nbytes, raw in iter_complete_lines(seg, start):
        frontier = offset + nbytes
        text = raw.decode("utf-8").strip()
        if not text:
            if builder.cur is not None:     # blank inside a run: absorb
                builder.cur.length += nbytes
            continue
        try:
            d = json.loads(text)
        except json.JSONDecodeError:
            raise ValueError(
                f"{seg}:@{offset}: corrupt record line — if this is a "
                "legacy engine checkpoint, migrate it with "
                "repro_torch.store.migrate.migrate_checkpoint")
        kind = d.get("kind")
        if kind == "fp":
            fp = SpaceFingerprint.from_json(d)
            idx.fps.setdefault(fp.digest, fp)
            builder.add(("fp", fp.digest), offset, nbytes)
        elif kind == "obs":
            v = d.get("value")
            builder.add(("fp", d["fp"]), offset, nbytes,
                        value=None if v is None else float(v), is_obs=True)
            idx.total += 1
        elif kind == "compact":
            builder.flush()                 # header: no extent
        elif kind in ("retune", "job"):
            builder.add(("ctl", kind), offset, nbytes, is_obs=True)
        else:
            raise ValueError(
                f"{seg}:@{offset}: unknown record kind {kind!r} — if this "
                "is a legacy engine checkpoint, migrate it with "
                "repro_torch.store.migrate.migrate_checkpoint")
    builder.flush()
    for (group, key), extent in builder.out:
        target = idx.extents if group == "fp" else idx.controls
        target.setdefault(key, []).append(extent)
    return frontier


def build_index(store_path: str) -> StoreIndex:
    """Full scan of every segment — the rebuild path."""
    idx = StoreIndex()
    for seg in list_segments(store_path, _is_single_file(store_path)):
        idx.segments[os.path.basename(seg)] = scan_segment(seg, idx, 0)
    return idx


def load_index(store_path: str) -> Optional[StoreIndex]:
    """The sidecar, or None when missing/torn/foreign-version — any of which
    means "rebuild"."""
    path = index_path(store_path)
    try:
        with open(path) as f:
            d = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    if not isinstance(d, dict) or d.get("kind") != "index" \
            or d.get("v") != INDEX_VERSION:
        return None
    try:
        return StoreIndex.from_json(d)
    except (KeyError, TypeError, ValueError):
        return None


def write_index(store_path: str, idx: StoreIndex) -> bool:
    """Atomic best-effort sidecar write (a reader on a read-only filesystem
    keeps its index in memory instead of failing the open)."""
    path = index_path(store_path)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(idx.to_json(), f)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def index_is_stale(store_path: str, idx: StoreIndex) -> bool:
    """True when a segment the index references shrank or vanished —
    something rewrote the store (compaction without an index refresh), so
    every recorded offset is suspect. Growth is NOT staleness: appends only
    extend segments, the indexed prefix stays valid."""
    single = _is_single_file(store_path)
    on_disk = {os.path.basename(s): s
               for s in list_segments(store_path, single)}
    for name, nbytes in idx.segments.items():
        seg = on_disk.get(name)
        if seg is None:
            return True
        if os.path.getsize(seg) < nbytes:
            return True
    return False
