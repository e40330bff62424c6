"""Migration shims: the three ad-hoc JSON shapes -> one store schema.

Before the store existed, observations lived in

  1. bespoke engine checkpoints — ``{"objective", "budget", "journal":
     [[idx, key, value, af], ...]}`` rewritten wholesale per evaluation;
  2. golden traces — ``tests/golden/seed_traces.json``:
     ``{case: {"journal": [[key, value|null, af], ...], ...}}``;
  3. benchmark matrices — best-so-far traces only (no journals), written by
     ``benchmarks/common.py`` (which now records journals into the store
     directly, so those need no migration).

``migrate_checkpoint`` rewrites (1) in place as a single-file store segment,
so ``TuningRun.resume`` keeps working on journals written before this
refactor; ``ingest_golden`` lifts (2) into any store.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.searchspace import SearchSpace
from repro_torch.store.records import (SpaceFingerprint, TuningRecord,
                                 TuningRecordStore)


def _config_for(space: SearchSpace, idx: Optional[int],
                key: str) -> Optional[Dict[str, Any]]:
    if idx is not None and 0 <= int(idx) < space.size:
        return space.config(int(idx))
    if key.startswith("cfg:"):
        try:
            return json.loads(key[4:])
        except json.JSONDecodeError:
            return None
    return None


def is_legacy_checkpoint(path: str) -> bool:
    """The bespoke pre-store engine checkpoint: one JSON object holding the
    whole journal (rewritten per evaluation). Written by ``json.dump`` with
    no indent, so the whole object is the file's first line — reading that
    line sniffs files of any size without truncating mid-object."""
    if not os.path.isfile(path):
        return False
    with open(path) as f:
        first = f.readline()
    try:
        data = json.loads(first)
    except json.JSONDecodeError:
        return False
    return isinstance(data, dict) and "journal" in data and "kind" not in data


def migrate_checkpoint(path: str, fingerprint: SpaceFingerprint,
                       space: SearchSpace, run_id: str = "journal") -> int:
    """Rewrite a legacy checkpoint file in place as store records.

    The legacy format carried no fingerprint; the caller asserts the problem
    identity (as the legacy resume silently did). Returns #migrated."""
    with open(path) as f:
        data = json.load(f)
    if data.get("objective") and fingerprint.objective \
            and data["objective"] != fingerprint.objective:
        raise ValueError(
            f"legacy checkpoint {path} was written for objective "
            f"{data['objective']!r}, not {fingerprint.objective!r}")
    tmp = path + ".migrate.jsonl"      # suffix keeps single-file store mode
    if os.path.exists(tmp):
        os.remove(tmp)
    store = TuningRecordStore(tmp)
    for seq, (idx, key, value, af) in enumerate(data["journal"]):
        store.append(TuningRecord(
            fp=fingerprint.digest, run=run_id, seq=seq, key=key,
            idx=None if idx is None else int(idx),
            value=math.nan if value is None else float(value), af=af,
            config=_config_for(space, idx, key),
            meta={"migrated_from": "engine_checkpoint"}),
            fingerprint=fingerprint)
    store.close()
    os.replace(tmp, path)
    # the rewrite invalidated any sidecar index byte offsets; refresh it so
    # the next lazy open reads the index instead of rebuilding from scratch
    from repro_torch.store import index as sidx
    if os.path.exists(sidx.index_path(path)):
        sidx.write_index(path, sidx.build_index(path))
    return len(data["journal"])


def ingest_golden(path: str, objective, store: TuningRecordStore,
                  context: str = "golden") -> int:
    """Lift seed golden traces into the store schema. ``objective`` must be
    the objective the traces were captured on (it provides the space for
    config resolution and the fingerprint identity)."""
    with open(path) as f:
        golden = json.load(f)
    fp = SpaceFingerprint.of(objective.space, objective=objective.name,
                             context=context)
    n = 0
    for case, payload in sorted(golden.items()):
        for seq, (key, value, af) in enumerate(payload["journal"]):
            idx: Optional[int] = None
            if not key.startswith("cfg:"):
                idx = int(key)
            store.append(TuningRecord(
                fp=fp.digest, run=f"golden:{case}", seq=seq, key=key, idx=idx,
                value=math.nan if value is None else float(value), af=af,
                config=_config_for(objective.space, idx, key),
                meta={"migrated_from": "golden_traces"}), fingerprint=fp)
            n += 1
    return n
