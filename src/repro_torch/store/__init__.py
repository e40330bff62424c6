"""Persistent tuning-record store + transfer-aware warm starts.

The observation/results subsystem: every layer produces into and consumes
from one append-only record store keyed by search-space fingerprints —
engine journals (checkpoint/resume), the kernel tuning cells, and the
serve-time best-config lookup. The fleet-scale pieces: the sidecar segment
index behind ``lazy=True`` opens, fence-locked segment compaction/GC, and
the durable store-backed tuning-job queue (exactly-once under N racing
daemons via fencing tokens). The JSONL schema and
``SpaceFingerprint.digest`` are byte-identical to the reference package's,
so a store written by either package is read by the other.
"""
from repro_torch.store.records import (SpaceFingerprint, TuningRecord,
                                       TuningRecordStore)
from repro_torch.store.transfer import warm_matches
from repro_torch.store.migrate import (ingest_golden, is_legacy_checkpoint,
                                       migrate_checkpoint)
from repro_torch.store.resolve import (apply_kernel_config,
                                       apply_sharding_config,
                                       best_sharding_config, cell_objective)
from repro_torch.store.watch import (DriftMonitor, HotConfigSource,
                                     OnlineServeLoop, ProdRecorder,
                                     ServeStats, StoreWatcher,
                                     latency_summary, prod_objective)
from repro_torch.store.index import (StoreIndex, build_index, index_path,
                                     load_index, write_index)
from repro_torch.store.compact import (CompactionLocked, CompactionStats,
                                       compact_store)
from repro_torch.store.fence import FencedClaimError, FenceRegistry
from repro_torch.store.queue import (JOB_TYPES, DurableRetuneQueue,
                                     JobTicket, RetuneTicket, TuningJobQueue)

__all__ = ["SpaceFingerprint", "TuningRecord", "TuningRecordStore",
           "warm_matches", "ingest_golden", "is_legacy_checkpoint",
           "migrate_checkpoint", "apply_kernel_config",
           "apply_sharding_config",
           "best_sharding_config", "cell_objective", "prod_objective",
           "StoreWatcher", "HotConfigSource", "ProdRecorder", "DriftMonitor",
           "OnlineServeLoop", "ServeStats", "latency_summary",
           "StoreIndex", "build_index", "index_path", "load_index",
           "write_index", "CompactionLocked", "CompactionStats",
           "compact_store", "FencedClaimError", "FenceRegistry",
           "JOB_TYPES", "TuningJobQueue", "JobTicket",
           "DurableRetuneQueue", "RetuneTicket"]
