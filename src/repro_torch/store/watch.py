"""Online store layer: live tail, prod-latency writeback, drift (DESIGN.md §12).

Port of ``repro/store/watch.py``, copied whole but for two points. The
decode-dispatch count: ``OnlineServeLoop.run`` counts a step as a kernel
step when the data plane's ``decode_kernel`` is true (the port's
``DecodeServer`` says whether its decode attention runs the CUDA kernel),
where the reference compares ``decode_dispatch`` with ``"pallas"``; so
``ServeStats`` counts ``decode_steps_kernel`` and ``decode_steps_plain``.
And ``HotConfigSource.for_kernel_cell`` reads the device from the port's
cell, which carries it.

The record store made tuning knowledge persistent; this module closes the
loop at serve time:

  * ``StoreWatcher`` tail-follows a store's segments by (mtime, byte offset)
    and yields records appended since the last poll — every record exactly
    once, in write order, tolerating a torn (partially flushed) final line
    and segment rollover, without ever re-reading consumed bytes;
  * ``HotConfigSource`` folds the watched stream into "best tuning config
    for one serving cell" and tells the server when a strictly better record
    has landed, so a fleet re-resolves mid-flight instead of at startup only;
  * ``ProdRecorder`` writes measured per-step serving latencies back into
    the store as ``context="prod"`` records under the cell's parameter
    family, so subsequent tuning runs warm-start from real telemetry via the
    existing ``repro_torch.store.transfer.warm_matches`` cross-fingerprint path;
  * ``DriftMonitor`` flags when observed prod latency diverges from the
    stored roofline prediction by a configurable factor, and
    ``OnlineServeLoop`` turns that into a ``RetuneRequest`` on the intake
    queue (the in-process ``repro_torch.core.engine.RetuneQueue`` or the durable
    fleet-wide ``repro_torch.store.queue.TuningJobQueue``).

Everything here is control plane: no torch, no threads, no wall-clock sleeps.
Time enters only through an injectable ``clock`` and latencies measured by
the caller, which is what makes the full store → serve → store cycle
drivable by the deterministic simulation harness (tests/loop_sim.py).
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.store.records import (SpaceFingerprint, TuningRecord,
                                 TuningRecordStore, _is_single_file,
                                 list_segments, natural_key)
from repro_torch.store.resolve import cell_objective


def prod_objective(arch: str, shape: str, mesh: str = "single") -> str:
    """Objective id for serving-telemetry records of a cell. Distinct from
    the tuning id (``cell_objective``) so measured latencies never win a
    ``best_sharding_config`` resolution — they transfer only through the
    warm-start cross-fingerprint path, discounted by the GP."""
    return f"prod[{arch}×{shape}×{mesh}]"


#: How long a directory mtime must have been stable before the watcher
#: trusts its segment-discovery cache: filesystems with coarse timestamp
#: granularity (1-2 s) can create a segment without advancing the mtime.
_DIR_SETTLE_NS = 2_000_000_000


@dataclass
class _Tail:
    """Read position in one segment: only COMPLETE lines are consumed, so a
    torn final line (killed or mid-flush writer) is left for the next poll.
    ``offset`` doubles as the consumed frontier compaction provenance is
    checked against: a record stamped with a source byte offset below it
    was already consumed under that incarnation (delivered, or skipped as
    pre-open history by a ``from_start=False`` tail)."""
    offset: int = 0
    mtime: float = -1.0


class StoreWatcher:
    """Incremental reader over a live store's segments.

    ``poll()`` returns the observations appended since the last call (and
    absorbs fingerprint descriptors into ``fingerprints()``). With
    ``from_start=True`` the first poll replays the whole store — that is how
    a serving process does its initial resolution and its hot reloads
    through one code path.

    Compaction-safe: a ``kind="compact"`` header retires the folded source
    segments before this poll could touch them again (the compacted segment
    sorts first), and each copied record's ``src=[[segment, byte_offset],
    ...]`` provenance chain is checked against the consumed byte frontier
    of every prior incarnation — so a rewrite-and-swap mid-tail re-delivers
    nothing and loses nothing.

    ``collect_controls=True`` additionally retains ``kind="job"`` /
    ``kind="retune"`` control records for ``drain_controls()`` (the durable
    job queue's read path); otherwise they are skipped.

    ``start_offsets`` (basename -> byte offset) seeds per-segment read
    positions: a caller that already consumed a segment's prefix through a
    side channel — the durable queue folding the sidecar index's control
    extents — starts each named segment at its indexed frontier instead of
    replaying it. Unnamed segments keep the ``from_start`` behavior, and the
    pre-frontier bytes count as consumed for compaction provenance (their
    content was delivered, just not through ``poll``).
    """

    def __init__(self, path: str, *, from_start: bool = True,
                 collect_controls: bool = False,
                 start_offsets: Optional[Dict[str, int]] = None):
        self.path = path
        self.single_file = _is_single_file(path)
        self.collect_controls = bool(collect_controls)
        self._tails: Dict[str, _Tail] = {}
        self._fps: Dict[str, SpaceFingerprint] = {}
        self._dead: set = set()       # folded source segments (full paths)
        self._folded: Dict[str, float] = {}   # basename -> consumed lines
        self._controls: List[Dict[str, Any]] = []
        self._dir_mtime_ns = -1       # segment-discovery cache (dir mode)
        if not from_start:
            for seg in self._segments():
                try:
                    st = os.stat(seg)
                except FileNotFoundError:
                    continue
                self._tails[seg] = _Tail(offset=st.st_size, mtime=st.st_mtime)
        elif start_offsets:
            for name, off in start_offsets.items():
                seg = (self.path if self.single_file
                       else os.path.join(self.path, name))
                try:
                    size = os.path.getsize(seg)
                except FileNotFoundError:
                    continue
                # clamp: an offset past the current size (segment rewritten
                # shorter than the index claims) must not wedge the tail
                self._tails[seg] = _Tail(offset=min(int(off), size),
                                         mtime=-1.0)

    def _segments(self) -> List[str]:
        return list_segments(self.path, self.single_file)

    def fingerprints(self) -> Dict[str, SpaceFingerprint]:
        return dict(self._fps)

    def drain_controls(self) -> List[Dict[str, Any]]:
        out, self._controls = self._controls, []
        return out

    def _retire(self, basename: str) -> None:
        """A compaction header folded this source: never read it again, and
        remember its consumed byte frontier — records resurfacing from the
        compacted copy below that offset are already consumed."""
        path = (self.path if self.single_file
                else os.path.join(self.path, basename))
        consumed = self._consumed_bytes(basename)
        prior = self._folded.get(basename)
        self._folded[basename] = (consumed if prior is None
                                  else max(prior, consumed))
        self._dead.add(path)

    def _consumed_bytes(self, basename: str) -> float:
        """Consumed byte frontier of a segment under any incarnation:
        retired frontier if folded, live tail offset otherwise (which for a
        ``from_start=False`` tail starts at the open-time size — pre-open
        history counts consumed, post-open appends do not)."""
        if basename in self._folded:
            return self._folded[basename]
        path = (self.path if self.single_file
                else os.path.join(self.path, basename))
        tail = self._tails.get(path)
        return float(tail.offset) if tail is not None else 0.0

    def _already_delivered(self, chain) -> bool:
        """True if any hop of a compacted record's provenance chain lies
        below the consumed frontier of that incarnation."""
        return any(int(offset) < self._consumed_bytes(name)
                   for name, offset in chain)

    def poll(self) -> List[TuningRecord]:
        """New complete observations, in write order (per segment; segments
        in rollover order — the same natural-numeric order the loader uses,
        which also puts a fresh compacted segment, holding the oldest
        records, ahead of every live one)."""
        out: List[TuningRecord] = []
        known = list(self._tails)
        fresh: List[str] = []
        if self.single_file:
            fresh = [s for s in self._segments() if s not in self._tails]
        else:
            # appends don't touch the directory mtime, segment creation
            # does: skip the listdir on the quiet path (the per-decode-step
            # poll tax is a handful of stats, not a directory scan). An
            # mtime still inside the filesystem's granularity window is
            # never trusted — a segment created in the same timestamp tick
            # as the cached value would otherwise be missed forever.
            try:
                dir_mtime_ns = os.stat(self.path).st_mtime_ns
            except FileNotFoundError:
                dir_mtime_ns = -1
            if (dir_mtime_ns != self._dir_mtime_ns
                    or time.time_ns() - dir_mtime_ns < _DIR_SETTLE_NS):
                fresh = [s for s in self._segments()
                         if s not in self._tails]
                self._dir_mtime_ns = dir_mtime_ns
        order = sorted(set(known) | set(fresh),
                       key=lambda p: natural_key(os.path.basename(p)))
        for seg in order:
            if seg in self._dead:
                continue
            tail = self._tails.setdefault(seg, _Tail())
            try:
                st = os.stat(seg)
            except FileNotFoundError:
                continue
            if st.st_size <= tail.offset and st.st_mtime == tail.mtime:
                continue
            tail.mtime = st.st_mtime
            if st.st_size <= tail.offset:
                continue
            with open(seg, "rb") as f:
                f.seek(tail.offset)
                data = f.read()
            lines = data.split(b"\n")
            partial = lines.pop()          # b"" when data ends in a newline
            for line in lines:
                tail.offset += len(line) + 1
                text = line.decode("utf-8").strip()
                if not text:
                    continue
                d = json.loads(text)
                kind = d.get("kind")
                if kind == "fp":
                    fp = SpaceFingerprint.from_json(d)
                    self._fps.setdefault(fp.digest, fp)
                elif kind == "obs":
                    src = d.get("src")
                    if src is not None and self._already_delivered(src):
                        continue    # delivered under a prior incarnation
                    out.append(TuningRecord.from_json(d))
                elif kind == "compact":
                    for name in d.get("sources", ()):
                        self._retire(name)
                elif kind in ("retune", "job"):
                    src = d.get("src")
                    if self.collect_controls and (
                            src is None
                            or not self._already_delivered(src)):
                        self._controls.append(d)
                else:
                    raise ValueError(f"{seg}:@{tail.offset}: unknown record "
                                     f"kind {kind!r}")
            del partial  # torn tail stays unconsumed until its newline lands
        return out


class HotConfigSource:
    """Best stored tuning config for one serving cell, live.

    Resolution mirrors ``repro_torch.store.resolve.best_sharding_config``: the
    cell's exact fingerprint wins; any compatible fingerprint with the same
    tuning objective id is the cross-digest fallback (minimum over all of
    them). ``refresh()`` folds newly landed records in and returns the
    ``(config, value)`` to deploy when it is strictly better than what is
    currently deployed — the atomic-swap decision point for the serve loop.
    """

    def __init__(self, path: str, arch: str, shape: str,
                 mesh: str = "single", *, wide: bool = False,
                 swap_margin: float = 0.0, space=None,
                 objective_id: Optional[str] = None):
        if space is None:
            from repro_torch.core.tuning_targets import sharding_space
            space = sharding_space(arch, shape, wide=wide)
        self.objective_id = objective_id or cell_objective(arch, shape, mesh)
        self.fp = SpaceFingerprint.of(space, objective=self.objective_id)
        # controls are collected too: job-claim records carry the fencing
        # tokens observation fencing is judged against (see _fold)
        self.watcher = StoreWatcher(path, from_start=True,
                                    collect_controls=True)
        #: highest job-claim fencing token seen per key: an observation
        #: journaled under a LOWER token is a fenced-out (superseded)
        #: claimant's late write and must not steer the hot path
        self._fence_top: Dict[str, int] = {}
        self.fenced_obs_rejected = 0
        #: swap hysteresis (seconds of roofline step time): a same-tier
        #: improvement must beat the deployed value by MORE than this to be
        #: worth the graph capture a swap costs. 0.0 = historical always-swap.
        self.swap_margin = float(swap_margin)
        self._best_exact: Optional[Tuple[Dict[str, Any], float]] = None
        self._best_cross: Optional[Tuple[Dict[str, Any], float]] = None
        self.current: Optional[Tuple[Dict[str, Any], float]] = None
        self._current_tier = 1        # 0 = exact fingerprint, 1 = fallback

    @classmethod
    def for_kernel_cell(cls, path: str, cell, *,
                        device: Optional[str] = None,
                        swap_margin: float = 0.0) -> "HotConfigSource":
        """A live source over a kernel-tuning cell (DESIGN.md §14): same
        tier/hysteresis semantics as sharding cells, keyed under the cell's
        ``kernel[name×shape×device]`` objective id. ``cell`` is a
        ``repro_torch.kernels.tuning.KernelCell``; ``device`` (a device
        kind) overrides the one its tensors lie on."""
        objective_id = (cell.objective_id() if device is None else
                        f"kernel[{cell.kernel}×{cell.shape_sig}×{device}]")
        return cls(path, "", "", space=cell.space,
                   objective_id=objective_id, swap_margin=swap_margin)

    @property
    def stale(self) -> bool:
        """No exact-fingerprint record has ever landed: the cell serves a
        cross-digest fallback (or built-in defaults) — its own measured
        problem was never tuned, which makes it a retune candidate."""
        return self._best_exact is None

    def _fold(self, rec: TuningRecord) -> None:
        fence = (rec.meta or {}).get("fence")
        if fence and int(fence.get("token") or 0) < \
                self._fence_top.get(str(fence.get("key", "")), 0):
            # the key's lease moved past this record's token: the writer
            # was fenced out mid-service; the new claimant's run re-journals
            # the cell under the current token
            self.fenced_obs_rejected += 1
            return
        if rec.config is None or not math.isfinite(rec.value):
            return
        if rec.fp == self.fp.digest:
            if self._best_exact is None or rec.value < self._best_exact[1]:
                self._best_exact = (dict(rec.config), rec.value)
            return
        desc = self.watcher.fingerprints().get(rec.fp)
        if desc is not None and desc.objective == self.objective_id:
            if self._best_cross is None or rec.value < self._best_cross[1]:
                self._best_cross = (dict(rec.config), rec.value)

    def refresh(self) -> Optional[Tuple[Dict[str, Any], float]]:
        """Poll the store; return the new (config, value) iff the server
        should swap. Precedence matches a restarting server's resolution,
        so a fleet converges on one config regardless of restart history:
        an exact-fingerprint record outranks any cross-digest fallback
        (even a lower-valued one — exact is the cell's own measured
        problem); within a tier, only a strictly lower roofline value
        swaps, and only by more than ``swap_margin`` — a sub-margin delta
        never pays back the capture. A tier upgrade always swaps (it is what
        a restarting server would deploy; the fleet must converge on it).
        Returns None when nothing should change."""
        recs = self.watcher.poll()
        # fold this batch's claim tokens FIRST: a fenced-out claimant's
        # late observations sort after the superseding claim in append
        # order, so token state must lead the observation fold
        for d in self.watcher.drain_controls():
            if d.get("state") == "claim":
                key, tok = str(d.get("key", "")), int(d.get("token") or 0)
                if tok > self._fence_top.get(key, 0):
                    self._fence_top[key] = tok
        for rec in recs:
            self._fold(rec)
        if self._best_exact is not None:
            cand, tier = self._best_exact, 0
        elif self._best_cross is not None:
            cand, tier = self._best_cross, 1
        else:
            return None
        if self.current is not None:
            if (tier, cand[1]) >= (self._current_tier, self.current[1]):
                return None
            if cand[0] == self.current[0]:
                # same config, re-ranked (better value or exact record for
                # the deployed fallback): no swap, no capture
                self.current, self._current_tier = cand, tier
                return None
            if tier == self._current_tier \
                    and self.current[1] - cand[1] <= self.swap_margin:
                return None     # better, but not worth a capture
        self.current, self._current_tier = cand, tier
        return cand


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated quantile of an ascending list (numpy 'linear')."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    return sorted_vals[lo] + (pos - lo) * (sorted_vals[hi] - sorted_vals[lo])


def latency_summary(window: List[float]) -> Dict[str, float]:
    """Windowed distribution summary journaled alongside each prod record:
    the mean plus the p50/p99 tail — drift policies can key off the tail a
    user actually feels instead of the median. Schema-additive (lives in
    ``meta``); records without it still parse."""
    s = sorted(window)
    return {"p50": _quantile(s, 0.50), "p99": _quantile(s, 0.99),
            "mean": sum(s) / len(s), "n": len(s)}


class ProdRecorder:
    """Serving telemetry → store: measured latencies as ``context="prod"``
    records under the cell's parameter family (same grids as the tuning
    space, ``prod_objective`` id), so ``warm_matches`` transfers them into
    future tuning runs as discounted cross-fingerprint priors. Each decode
    record additionally journals a windowed p50/p99/mean summary of the
    last ``summary_window`` measurements (``meta``, schema-additive)."""

    def __init__(self, store, arch: str, shape: str, mesh: str = "single", *,
                 wide: bool = False, run_id: Optional[str] = None,
                 clock=time.time, summary_window: int = 16):
        from repro_torch.core.tuning_targets import sharding_space
        # a path opens write-only: the recorder only ever appends, and a
        # fleet-scale store must not be parsed into memory per server
        self.store = (TuningRecordStore(store, load=False)
                      if isinstance(store, str) else store)
        self.space = sharding_space(arch, shape, wide=wide)
        self.fp = SpaceFingerprint.of(
            self.space, objective=prod_objective(arch, shape, mesh),
            context="prod")
        self.run_id = run_id or f"serve-{os.getpid()}"
        self.clock = clock
        self.summary_window = max(int(summary_window), 1)
        self._window: List[float] = []
        self._seq = 0

    @property
    def count(self) -> int:
        """Records journaled by this recorder."""
        return self._seq

    def record(self, config: Optional[Dict[str, Any]], latency_s: float, *,
               phase: str = "decode") -> TuningRecord:
        """One measured step. ``config=None`` (built-in defaults, nothing
        resolved) is still journaled — telemetry — but carries no config and
        so never transfers."""
        idx = (self.space.index_of(config) if config is not None else None)
        key = (str(int(idx)) if idx is not None else
               "cfg:" + json.dumps(config, sort_keys=True, default=str)
               if config is not None else f"default:{self._seq}")
        meta: Dict[str, Any] = {"phase": phase}
        if phase == "decode":
            # prefill is in different units and would poison the window
            self._window = (self._window
                            + [float(latency_s)])[-self.summary_window:]
            meta.update(latency_summary(self._window))
        rec = TuningRecord(
            fp=self.fp.digest, run=self.run_id, seq=self._seq, key=key,
            idx=None if idx is None else int(idx), value=float(latency_s),
            config=None if config is None else dict(config),
            dur=float(latency_s), t=float(self.clock()),
            meta=meta)
        self._seq += 1
        self.store.append(rec, fingerprint=self.fp)
        return rec


class DriftMonitor:
    """Windowed divergence of observed latency from the stored prediction.

    Triggers when the chosen window statistic (``stat``: the median by
    default; ``"p99"`` keys the alarm off the tail users actually feel,
    ``"mean"`` off throughput) of the last ``window`` observations is off
    the roofline prediction by more than ``factor`` in either direction
    (slower: the stored config is stale for this hardware/load; faster: the
    roofline itself is stale and tuning is mis-ranking). Every ``observe``
    surfaces the full windowed summary (``last_p50``/``last_p99``/
    ``last_mean``) regardless of which statistic triggers. Re-arms by
    clearing the window, so one drifted regime yields one trigger, not one
    per step."""

    STATS = ("median", "p50", "p99", "mean")

    def __init__(self, predicted: Optional[float] = None, *,
                 factor: float = 1.5, window: int = 8,
                 stat: str = "median"):
        if factor <= 1.0:
            raise ValueError(f"drift factor must be > 1, got {factor}")
        if stat not in self.STATS:
            raise ValueError(f"drift stat must be one of {self.STATS}, "
                             f"got {stat!r}")
        self.predicted = predicted
        self.factor = factor
        self.window = max(int(window), 1)
        self.stat = stat
        self._obs: List[float] = []
        self.last_median: float = math.nan
        self.last_p50: float = math.nan
        self.last_p99: float = math.nan
        self.last_mean: float = math.nan

    @property
    def last_stat(self) -> float:
        """The triggering statistic's latest windowed value."""
        return {"median": self.last_median, "p50": self.last_p50,
                "p99": self.last_p99, "mean": self.last_mean}[self.stat]

    def rebase(self, predicted: Optional[float]) -> None:
        """New config deployed: new prediction, fresh window."""
        self.predicted = predicted
        self._obs = []

    def observe(self, latency_s: float) -> bool:
        if self.predicted is None or self.predicted <= 0:
            return False
        self._obs.append(float(latency_s))
        if len(self._obs) < self.window:
            return False
        self._obs = self._obs[-self.window:]
        summary = latency_summary(self._obs)
        self.last_median = self.last_p50 = summary["p50"]
        self.last_p99 = summary["p99"]
        self.last_mean = summary["mean"]
        ratio = self.last_stat / self.predicted
        if ratio > self.factor or ratio < 1.0 / self.factor:
            self._obs = []
            return True
        return False



@dataclass
class ServeStats:
    """What one ``OnlineServeLoop.run`` did, for tests and logs."""
    steps: int = 0
    latencies: List[float] = field(default_factory=list)
    swaps: List[Tuple[int, Dict[str, Any], float]] = field(
        default_factory=list)          # (global step, config, roofline value)
    kernel_swaps: List[Tuple[int, Dict[str, Any], float]] = field(
        default_factory=list)          # (global step, block config, step time)
    retunes_requested: int = 0
    kernel_retunes_requested: int = 0
    #: decode steps served by the flash-decode kernel vs the plain decode
    #: attention (servers expose ``decode_kernel``; a data plane without
    #: the attribute counts as plain — it IS the fallback)
    decode_steps_kernel: int = 0
    decode_steps_plain: int = 0


class OnlineServeLoop:
    """The serve-side control loop: between decode steps, poll the store and
    atomically swap in a strictly better config (no restart — the server
    keeps its params/cache and only re-derives its step functions); after
    each step, write the measured latency back as prod telemetry and check
    it against the deployed config's roofline prediction, enqueuing a
    ``RetuneRequest`` on drift.

    ``server`` is the data plane: ``decode_step() -> latency_s`` and
    ``apply_config(config_dict)``. The real one lives in
    ``repro_torch.launch.serve.DecodeServer``; the simulation harness substitutes
    an in-process stub driven by a virtual clock.
    """

    def __init__(self, server, source: Optional[HotConfigSource] = None, *,
                 recorder: Optional[ProdRecorder] = None,
                 monitor: Optional[DriftMonitor] = None,
                 retune_queue=None, cell_key: str = "",
                 poll_every: int = 1, clock=time.time,
                 first_step_warmup: bool = False,
                 kernel_source: Optional[HotConfigSource] = None,
                 kernel_sources: Optional[List[HotConfigSource]] = None):
        self.server = server
        self.source = source
        # one loop can watch several kernel cells (flash + decode), each
        # hot-swapping and stale-enqueuing independently; ``kernel_source``
        # (singular) is the original single-cell spelling
        self.kernel_sources: List[HotConfigSource] = list(kernel_sources or ())
        if kernel_source is not None:
            self.kernel_sources.insert(0, kernel_source)
        self.kernel_source = (self.kernel_sources[0]
                              if self.kernel_sources else None)
        self.recorder = recorder
        self.monitor = monitor
        self.retune_queue = retune_queue
        self.cell_key = cell_key
        self.poll_every = max(int(poll_every), 1)
        self.clock = clock
        self.config: Optional[Dict[str, Any]] = (
            source.current[0] if source is not None and source.current
            else None)
        self.step = 0          # global decode-step counter across run() calls
        # first step after a swap pays the capture; a real (graph-captured)
        # data plane also pays it on its very first step, before any swap —
        # the launcher passes first_step_warmup=True for that
        self._warmup = bool(first_step_warmup)

    def _maybe_swap(self, stats: ServeStats) -> None:
        hit = self.source.refresh() if self.source is not None else None
        if hit is None:
            # the deployed config can be re-ranked in place (an exact record
            # landing for it, or a better measurement): no swap, but the
            # drift monitor must judge against the CURRENT roofline
            if (self.monitor is not None and self.source is not None
                    and self.source.current is not None
                    and self.monitor.predicted != self.source.current[1]):
                self.monitor.rebase(self.source.current[1])
            return
        cfg, value = hit
        self.server.apply_config(cfg)
        self.config = dict(cfg)
        self._warmup = True
        if self.monitor is not None:
            self.monitor.rebase(value)
        stats.swaps.append((self.step, dict(cfg), value))

    def _maybe_swap_kernel(self, stats: ServeStats) -> None:
        """Kernel hot-swap mirrors the sharding one (same tier/margin
        hysteresis inside the source) but does NOT rebase the drift monitor:
        the roofline prediction judges the *sharding* config, and a kernel
        block change doesn't invalidate it."""
        apply = getattr(self.server, "apply_kernel_config", None)
        for src in self.kernel_sources:
            hit = src.refresh()
            if hit is None:
                continue
            cfg, value = hit
            if apply is None:
                continue     # data plane has no kernel dispatch (e.g. old stub)
            apply(cfg)
            self._warmup = True    # first post-swap step pays the capture
            stats.kernel_swaps.append((self.step, dict(cfg), value))

    def _maybe_retune_kernel(self, stats: ServeStats) -> None:
        """Kernel-cell staleness → durable retune request: while no exact
        record exists for this cell's kernel fingerprint (serving a
        cross-shape fallback or pure-JAX defaults), ask the fleet to tune
        it. The durable queue dedupes per cell key, so re-checking every
        poll costs one open-ticket lookup, not duplicate work; after a
        daemon services the request, the tuned record lands, ``stale``
        flips, and submissions stop."""
        if self.retune_queue is None:
            return
        from repro_torch.core.engine import RetuneRequest
        for src in self.kernel_sources:
            if not src.stale:
                continue
            accepted = self.retune_queue.submit(RetuneRequest(
                key=src.objective_id, objective=src.objective_id,
                observed=math.nan, predicted=math.nan,
                reason="stale", t=float(self.clock())))
            stats.kernel_retunes_requested += int(accepted)

    def run(self, steps: int) -> ServeStats:
        stats = ServeStats()
        for _ in range(int(steps)):
            if self.step % self.poll_every == 0:
                self._maybe_swap(stats)
                self._maybe_swap_kernel(stats)
                self._maybe_retune_kernel(stats)
            dt = self.server.decode_step()
            stats.steps += 1
            stats.latencies.append(dt)
            if getattr(self.server, "decode_kernel", False):
                stats.decode_steps_kernel += 1
            else:
                stats.decode_steps_plain += 1
            if self._warmup:
                # the first post-swap step includes the capture: neither
                # telemetry the warm start should learn from nor a latency
                # the drift monitor should judge the new config by
                self._warmup = False
                self.step += 1
                continue
            if self.recorder is not None:
                self.recorder.record(self.config, dt, phase="decode")
            if self.monitor is not None and self.monitor.observe(dt):
                if self.retune_queue is not None:
                    from repro_torch.core.engine import RetuneRequest
                    accepted = self.retune_queue.submit(RetuneRequest(
                        key=self.cell_key or (
                            self.source.objective_id if self.source else ""),
                        objective=(self.source.objective_id
                                   if self.source else ""),
                        observed=self.monitor.last_stat,
                        predicted=self.monitor.predicted or math.nan,
                        t=float(self.clock())))
                    stats.retunes_requested += int(accepted)
            self.step += 1
        return stats
