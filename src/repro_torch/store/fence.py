"""Fencing tokens for the store control plane (DESIGN.md §13).

Port of ``repro/store/fence.py``, copied whole.

The append-only log gives durability but not mutual exclusion: two daemons
can both append a claim for one job and each read a view in which it won.
This module supplies the one atomic primitive the filesystem actually
guarantees — ``open(..., O_CREAT | O_EXCL)`` creates a file exactly once —
and builds per-key **monotonically increasing fencing tokens** on it:

    <store>/fence/<key-id>.<N>             token marker (holder JSON inside)
    <store>/fence/<key-id>.<N>.released    holder gave the token up

``issue(key)`` computes the next token above everything on disk (and above
an explicit ``floor`` the caller folded from claim records) and tries to
create its marker; exactly one contender can succeed per token value, so a
successful ``issue`` is a unique, totally ordered grant. Tokens are never
reused or deleted-and-recreated — takeover of a stale holder is "issue the
next token", never "remove the old marker", which closes the classic
unlink/recreate race where a second taker deletes a *fresh* lock.

Consumers enforce the fence: any record written while servicing a claim
carries the claim's token, and folds/readers reject a record whose token is
below the highest token they have seen for that key (``repro_torch.store.queue``
for ``done`` records, ``repro_torch.store.watch.HotConfigSource`` for journaled
observations, ``repro_torch.store.compact`` for the compactor lock). A paused
claimant that wakes after losing its lease therefore cannot corrupt state —
its writes are fenced out by token comparison, no matter how late they land.

Markers are tiny and GC'd opportunistically: a successful ``issue`` removes
markers more than ``_KEEP_BEHIND`` tokens below the one it just granted
(the highest marker must survive — it IS the monotonicity floor)."""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, Optional

from repro_torch.store.records import _is_single_file

#: how many superseded markers to keep behind the newest (debuggability —
#: the crash matrix is easier to read with the last few holders on disk)
_KEEP_BEHIND = 4


class FencedClaimError(RuntimeError):
    """A write was attempted under a token another claimant superseded."""


def fence_dir(store_path: str) -> str:
    """Where a store's fence markers live: a ``fence/`` subdir of a
    directory store (``list_segments`` only matches ``*.jsonl`` files, so
    the subdir is invisible to every reader), or ``<file>.fence`` beside a
    single-file store."""
    if _is_single_file(store_path):
        return store_path + ".fence"
    return os.path.join(store_path, "fence")


def _key_id(key: str) -> str:
    """Filesystem-safe stable id for an arbitrary key (cell keys contain
    ``×``, ``[``, ``/``...)."""
    return hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]


class FenceRegistry:
    """Token issuance + holder metadata for one store's keys."""

    def __init__(self, store_path: str, *, clock=time.time):
        self.dir = fence_dir(store_path)
        self.clock = clock

    # -- reads --------------------------------------------------------------
    def _tokens(self, key: str) -> Dict[int, str]:
        """token -> marker filename, for every marker of ``key`` on disk."""
        kid = _key_id(key)
        out: Dict[int, str] = {}
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return out
        prefix = kid + "."
        for name in names:
            if not name.startswith(prefix) or name.endswith(".released"):
                continue
            try:
                out[int(name[len(prefix):])] = name
            except ValueError:
                continue
        return out

    def highest(self, key: str) -> int:
        """Highest token ever issued for ``key`` (0 = none)."""
        toks = self._tokens(key)
        return max(toks) if toks else 0

    def released(self, key: str, token: int) -> bool:
        return os.path.exists(os.path.join(
            self.dir, f"{_key_id(key)}.{int(token)}.released"))

    def holder(self, key: str, token: int) -> Optional[Dict[str, Any]]:
        """The marker's holder JSON (``{"key", "by", "t"}``), or None if the
        marker is missing/torn."""
        path = os.path.join(self.dir, f"{_key_id(key)}.{int(token)}")
        try:
            with open(path) as f:
                d = json.load(f)
            return d if isinstance(d, dict) else None
        except (OSError, json.JSONDecodeError):
            return None

    # -- writes -------------------------------------------------------------
    def issue(self, key: str, *, floor: int = 0,
              by: str = "") -> Optional[int]:
        """Atomically grant the next token above both the on-disk markers
        and ``floor`` (the highest token the caller has *folded* — markers
        alone are not enough once old ones are GC'd). Returns the token, or
        None if another contender created the same marker first (the caller
        lost this round; re-read and retry if still appropriate)."""
        os.makedirs(self.dir, exist_ok=True)
        token = max(self.highest(key), int(floor)) + 1
        path = os.path.join(self.dir, f"{_key_id(key)}.{token}")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return None
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps({"key": key, "by": by,
                                "t": float(self.clock())}))
            f.flush()
        self._gc(key, token)
        return token

    def release(self, key: str, token: int) -> None:
        """Voluntarily give the token up (claim aborted, compactor done):
        the marker stays — monotonicity — but a ``.released`` flag tells
        arbitration not to wait out the holder's TTL."""
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir,
                            f"{_key_id(key)}.{int(token)}.released")
        try:
            with open(path, "w") as f:
                f.write("")
        except OSError:
            pass

    def _gc(self, key: str, newest: int) -> None:
        for token, name in self._tokens(key).items():
            if token < newest - _KEEP_BEHIND:
                for victim in (name, name + ".released"):
                    try:
                        os.unlink(os.path.join(self.dir, victim))
                    except OSError:
                        pass
