"""Persistent tuning-record store + transfer-aware warm starts.

The JSONL schema and ``SpaceFingerprint.digest`` are byte-identical to the
reference package's, so a store written by either package is read by the
other. Cut from this port: serve-side resolution, the live watcher, segment
compaction, fencing and the durable tuning-job queue.
"""
from repro_torch.store.records import (SpaceFingerprint, TuningRecord,
                                       TuningRecordStore)
from repro_torch.store.transfer import warm_matches
from repro_torch.store.migrate import (ingest_golden, is_legacy_checkpoint,
                                       migrate_checkpoint)
from repro_torch.store.index import (StoreIndex, build_index, index_path,
                                     load_index, write_index)

__all__ = ["SpaceFingerprint", "TuningRecord", "TuningRecordStore",
           "warm_matches", "ingest_golden", "is_legacy_checkpoint",
           "migrate_checkpoint", "StoreIndex", "build_index", "index_path",
           "load_index", "write_index"]
