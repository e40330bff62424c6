"""torch.profiler over one batch of the window, reduced to what the
per-layer metrics read: every device operation with its name and
interval, the device's busy and idle time, and the longest idle gaps by
the benchmark's own span that the host was in.

The benchmark marks the calls it makes into the serve layer with spans of
its own (``chipbench.prefill``, ``chipbench.decode_step``,
``chipbench.prompts``) and the traced window with ``chipbench.window``.
The program's own spans (``serve.*``, ``launch/spans.py``) are not read
from the profiler here: a traced run keeps them from the program's
recorder (``harness.Run.spans``).
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

WINDOW = "chipbench.window"
TOP = 10


@dataclass
class TraceWindow:
    """One traced window: its length, the device's busy time in it, each
    device operation as (name, start_ns, duration_ns), and the idle gaps
    summed by the span the host was in."""

    window_s: float
    busy_s: float
    ops: List[Tuple[str, int, int]]
    idle_by_span: List[Tuple[str, float]] = field(default_factory=list)

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(d for n, _, d in self.ops if match(n)) / 1e9

    def top_ops(self) -> List[List]:
        by: Dict[str, int] = {}
        for n, _, d in self.ops:
            by[n] = by.get(n, 0) + d
        return [[n[:160], d / 1e9] for n, d in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


class Tracer:
    """Spans always (a no-op while no profiler runs); the profiler over
    :meth:`window` only."""

    def __init__(self):
        self.prof = None
        self.result: Optional[TraceWindow] = None

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self.prof is None:
            yield
            return
        from torch.profiler import record_function
        with record_function(name):
            yield

    @contextlib.contextmanager
    def window(self, sync) -> Iterator[None]:
        """Profile the body, which ``sync`` brackets on the device."""
        from torch.profiler import ProfilerActivity, profile, record_function
        sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        try:
            with record_function(WINDOW):
                yield
                sync()
        finally:
            self.prof.__exit__(None, None, None)
        self.result = reduce(self.prof.profiler.kineto_results.events())
        self.prof = None


def reduce(events) -> TraceWindow:
    """The traced window from the profiler's events: its bounds from the
    ``chipbench.window`` span, the device operations inside it (kernels,
    copies and sets; not the device copies of the host's spans), their
    union as the busy time, and each idle gap named by the benchmark span
    covering its start (``host: other`` where none does)."""
    from torch.autograd import DeviceType
    spans, ops, window = [], [], None
    for e in events:
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():      # the spans' device copies
                ops.append((name, start, dur))
        elif name == WINDOW:
            window = (start, start + dur)
        elif name.startswith("chipbench."):
            spans.append((name, start, start + dur))
    if window is None:
        raise RuntimeError("the profiler lost the traced window's span")
    lo, hi = window
    ops = sorted(((n, max(s, lo), min(s + d, hi) - max(s, lo))
                  for n, s, d in ops if s < hi and s + d > lo),
                 key=lambda o: o[1])
    busy, gaps, at = 0, [], lo
    for _, s, d in ops:
        if s > at:
            gaps.append((at, s))
        end = s + d
        if end > at:
            busy += end - max(s, at)
            at = end
    if at < hi:
        gaps.append((at, hi))
    # the benchmark's spans follow one another, none inside another
    spans.sort(key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    by: Dict[str, float] = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        name = (spans[i][0] if i >= 0 and g0 < spans[i][2]
                else "host: other")
        by[name] = by.get(name, 0.0) + (g1 - g0) / 1e9
    idle = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceWindow(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9, ops=ops,
                       idle_by_span=[list(kv) for kv in idle])
