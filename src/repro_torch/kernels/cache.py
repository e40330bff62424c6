"""Per-device compiled-kernel cache (DESIGN.md §14).

Port of ``repro/kernels/cache.py``, copied whole. The port's
``DecodeServer`` memoizes one captured CUDA graph of its decode step per
kernel config here, where the reference memoizes jitted step functions:
swapping back to a config replays a graph already captured.

Hot-swapping a tuned kernel config between decode steps means re-deriving
jit'd step functions. jax's own compilation cache keys on traced HLO, but a
serve process also wants (a) an explicit hit/miss ledger so the loop-sim
can pin "re-applying a previously-seen config does not re-jit", and (b)
eviction keyed on *our* terms — store fingerprint digest + block config —
so a store compaction or retune invalidates exactly the entries it should.

The cache is deliberately dumb: ``get(key, build)`` memoizes ``build()``
under a hashable key. DecodeServer keys derived step-fn bundles by
``(arch_digest, kernel-config tuple)``; the kernel-tuning benchmark keys
compiled kernels by ``(fingerprint, config items)``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Tuple


def config_key(cfg: Optional[Dict[str, Any]]) -> Tuple:
    """Canonical hashable form of a (possibly-None) config dict."""
    if cfg is None:
        return ()
    return tuple(sorted(cfg.items()))


class CompiledKernelCache:
    """Thread-safe memo of compiled artifacts with LRU eviction + stats."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
        # Build OUTSIDE the lock: jit compilation can take seconds and must
        # not block concurrent lookups of already-cached configs.
        value = build()
        with self._lock:
            if key in self._entries:          # lost a build race: keep first
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            self.misses += 1
            self._entries[key] = value
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
            return value

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def invalidate(self, predicate: Optional[Callable[[Hashable], bool]] = None) -> int:
        """Drop entries whose key matches ``predicate`` (all when None).
        Returns the number dropped. Used when a store compaction/retune
        changes the fingerprint an entry was keyed under."""
        with self._lock:
            if predicate is None:
                n = len(self._entries)
                self._entries.clear()
                return n
            doomed = [k for k in self._entries if predicate(k)]
            for k in doomed:
                del self._entries[k]
            return len(doomed)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "entries": len(self._entries)}
