"""Spans and device intervals at the serve layer's boundaries.

``DecodeServer(..., trace=True)`` records a span at each boundary it
crosses (a prefill and its parts, a decode step and its parts, a graph
capture and its parts), each with its start and end on
``time.perf_counter_ns``'s clock, the span open around it, the prefill
serial of its batch and, inside a decode step, the step's index. On the
card the parts that run on the device carry a device interval timed with
CUDA events on the current stream (one pair of events a span name, made
once and reused), read after the synchronise that ends the prefill or the
decode step, so the recorder adds no synchronise of its own. While a
profiler runs, every span is also a ``torch.profiler.record_function``
range of the same name (without one a range records nothing, and entering
it costs ~13 us), and :attr:`SpanRecorder.offset_ns` maps the recorder's
clock onto the profiler's (Unix-epoch ns), so a span can be set against
the device operations of a trace. Spans stay in memory
(:attr:`SpanRecorder.spans`).

The spans, by parent:

- ``serve.prefill``: ``serve.prefill.step`` (the prefill step function),
  ``serve.prefill.cache_copy`` (its cache copied into the server's
  buffers), ``serve.prefill.sample`` (the argmax), each with a device
  interval, and ``serve.prefill.sync``;
- ``serve.decode_step``, with the device interval of its graph replay:
  ``serve.decode.issue`` (from the step's entry until the replay, or the
  eager step off the card, has returned: the token and position writes
  and the launch) and ``serve.decode.sync`` (the argmax's copy and the
  synchronise);
- ``serve.capture`` (inside the decode step that captures):
  ``serve.capture.warmup`` (the eager step on the capture stream and the
  cache's clone) and ``serve.capture.graph``.
"""
from __future__ import annotations

import bisect
import statistics
import time
from dataclasses import dataclass
from typing import Container, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function


@dataclass
class Span:
    """One boundary crossed: ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``'s clock, the index of the span open around it
    (``parent``; None at the top), the prefill serial of its batch and,
    inside a decode step, the step's index in its batch. ``device_ms`` is
    the device interval timed with CUDA events, where the span has one."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    batch: int
    step: Optional[int] = None
    device_ms: Optional[float] = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _uncovered(span: Span, kids: Sequence[Span]) -> int:
    covered, at = 0, span.start_ns
    for s, e in sorted((c.start_ns, c.end_ns) for c in kids):
        s, e = max(s, at), min(e, span.end_ns)
        if e > s:
            covered += e - s
            at = e
    return span.ns - covered


def self_ns(spans: Sequence[Span], i: int) -> int:
    """Span ``i``'s self time: its duration less the part of it that its
    children cover."""
    return _uncovered(spans[i], [c for c in spans if c.parent == i])


class SpanRecorder:
    """The spans of one server (see the module's docstring), every one it
    has recorded: a recorder that lives as long as its server grows with
    every step. ``batch`` is the prefill serial that new spans take (the
    server counts it up at each prefill; 0 before the first)."""

    def __init__(self, device: torch.device):
        self.spans: List[Span] = []
        self.batch = 0
        self._cuda = device.type == "cuda"
        self._open: List[int] = []
        self._ranges: List[Optional[record_function]] = []
        self._events: Dict[str, Tuple] = {}
        self._timing: Dict[int, Tuple] = {}       # started, not yet stopped
        self._stopped: List[Tuple[int, Tuple]] = []
        before = time.perf_counter_ns()
        wall = time.time_ns()
        after = time.perf_counter_ns()
        #: the profiler's clock (Unix-epoch ns) less the recorder's, read
        #: once here: a later step of the wall clock is not followed
        self.offset_ns = wall - (before + after) // 2

    def open(self, name: str, at: Optional[int] = None, *,
             device: bool = False, step: Optional[int] = None) -> int:
        """Open a span inside the innermost open one, at ``at`` (now when
        None), timing its device interval where ``device``; returns its
        index. A span without ``step`` takes its parent's."""
        parent = self._open[-1] if self._open else None
        if step is None and parent is not None:
            step = self.spans[parent].step
        i = len(self.spans)
        self.spans.append(Span(name, time.perf_counter_ns() if at is None
                               else at, -1, parent, self.batch, step))
        rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            rf = record_function(name)
            rf.__enter__()
        self._open.append(i)
        self._ranges.append(rf)
        if device:
            self.device_start(i)
        return i

    def then(self, name: str, *, device: bool = False) -> int:
        """Close the innermost open span and open its next sibling, at the
        same instant, after the closing span's device interval has ended
        (recording an event may wait for room in the launch queue)."""
        self.device_stop(self._open[-1])
        now = time.perf_counter_ns()
        self._close_innermost(now)
        return self.open(name, now, device=device)

    def close(self, i: int, at: Optional[int] = None) -> None:
        """Close the open spans from the innermost out to span ``i``, all at
        ``at`` (now when None). Where none stays open, the device intervals
        are read: a top span closes after the server's synchronise."""
        at = time.perf_counter_ns() if at is None else at
        while self._close_innermost(at) != i:
            pass
        if not self._open:
            for j, (e0, e1) in self._stopped:
                self.spans[j].device_ms = e0.elapsed_time(e1)
            self._stopped.clear()

    def _close_innermost(self, at: int) -> int:
        i = self._open.pop()
        rf = self._ranges.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        self.spans[i].end_ns = at
        if i in self._timing:
            self.device_stop(i)
        return i

    def device_start(self, i: int) -> None:
        """Record the start of span ``i``'s device interval on the current
        stream (nothing off the card)."""
        if not self._cuda:
            return
        name = self.spans[i].name
        if name not in self._events:
            self._events[name] = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
        pair = self._events[name]
        pair[0].record()
        self._timing[i] = pair

    def device_stop(self, i: int) -> None:
        """Record the end of span ``i``'s device interval."""
        pair = self._timing.pop(i, None)
        if pair is not None:
            pair[1].record()
            self._stopped.append((i, pair))


def _median(xs: List[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None


def self_ms(spans: Sequence[Span],
            batches: Optional[Container[int]] = None) -> Dict[str, float]:
    """The median self time (:func:`self_ns`, in ms) of each span name over
    the batches ``batches`` (every batch when None), names in the order
    they first appear."""
    kids: Dict[int, List[Span]] = {}
    for c in spans:
        if c.parent is not None:
            kids.setdefault(c.parent, []).append(c)
    by: Dict[str, List[float]] = {}
    for i, s in enumerate(spans):
        if batches is None or s.batch in batches:
            by.setdefault(s.name, []).append(
                _uncovered(s, kids.get(i, ())) / 1e6)
    return {name: statistics.median(xs) for name, xs in by.items()}


def readings(spans: Sequence[Span],
             batches: Optional[Container[int]] = None
             ) -> Dict[str, float]:
    """The serve layer's readings over the batches ``batches`` (every
    batch when None), each where the spans hold it:

    - ``decode_issue_ms``: median duration of ``serve.decode.issue``;
    - ``decode_device_ms``: median device interval of a graph replay;
    - ``prefill_copy_ms``: median device interval of
      ``serve.prefill.cache_copy``;
    - ``device_idle_pct``: 100 x (1 - the device intervals of the batches
      over their spans, each from its ``serve.prefill`` start to its last
      ``serve.decode_step`` end), summed over the batches.
    """
    ours = [s for s in spans if batches is None or s.batch in batches]
    out = {}
    for key, name, of in (
            ("decode_issue_ms", "serve.decode.issue", lambda s: s.ns / 1e6),
            ("decode_device_ms", "serve.decode_step",
             lambda s: s.device_ms),
            ("prefill_copy_ms", "serve.prefill.cache_copy",
             lambda s: s.device_ms)):
        value = _median([of(s) for s in ours
                         if s.name == name and of(s) is not None])
        if value is not None:
            out[key] = value
    device_ms, span_ns = 0.0, 0
    for b in sorted({s.batch for s in ours}):
        mine = [s for s in ours if s.batch == b]
        starts = [s.start_ns for s in mine if s.name == "serve.prefill"]
        ends = [s.end_ns for s in mine if s.name == "serve.decode_step"]
        timed = [s.device_ms for s in mine if s.device_ms is not None]
        if starts and ends and timed:
            device_ms += sum(timed)
            span_ns += max(ends) - min(starts)
    if span_ns:
        out["device_idle_pct"] = 100 * (1 - device_ms * 1e6 / span_ns)
    return out


def step_kernels(events) -> Optional[float]:
    """Median, over the ``serve.decode_step`` ranges among a profiler's
    events (``prof.profiler.kineto_results.events()``), of the device
    operations (kernels, copies, sets) that start inside each; a decode
    step synchronises at both ends, so nothing of another step falls
    inside. None where the events hold no decode step."""
    from torch.autograd import DeviceType
    steps, starts = [], []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name() == "serve.decode_step":
                steps.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif not e.is_user_annotation():
            starts.append(e.start_ns())
    starts.sort()
    return _median([bisect.bisect_left(starts, hi)
                    - bisect.bisect_left(starts, lo) for lo, hi in steps])
