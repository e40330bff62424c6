"""The serve layer's span recorder (``launch/spans.py``) inside
``DecodeServer``, on the CPU with the smoke config: off by default and
silent there; on, spans nested under their parents with the batch's
serial, self times, and starts that map onto ``torch.profiler``'s clock;
the CLI's printout of them. The readings are held on
made-up spans and events, since device intervals exist only on the card
(``tests/test_torch_cuda.py``)."""
import statistics

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import serve
from repro_torch.launch.spans import (Span, readings, self_ms, self_ns,
                                      step_kernels)
from repro_torch.models import params as P
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig

B, PROMPT, STEPS = 2, 16, 4
KC = KernelConfig(use_flash=True, flash_block_q=8, flash_block_kv=8,
                  use_decode=True, decode_block_kv=8, decode_num_splits=2)
PREFILL_PARTS = ["serve.prefill.step", "serve.prefill.cache_copy",
                 "serve.prefill.sample", "serve.prefill.sync"]


def _server(**kw):
    cfg = smoke_config("gemma-2b").replace(dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return serve.DecodeServer(cfg, ParallelConfig(kernel=KC), batch=B,
                              prompt_len=PROMPT, decode_steps=STEPS,
                              device="cpu", params=params, **kw)


def _serve(srv, steps=STEPS):
    """A prefill and ``steps`` decode steps; their returned seconds."""
    return [srv.prefill_batch(srv.input_batch())] + [
        srv.decode_step() for _ in range(steps)]


def _serve_events(srv):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(srv, 2)
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("serve.")]


def test_a_server_without_trace_records_nothing():
    srv = _server()
    assert srv.recorder is None
    assert _serve_events(srv) == []


def test_spans_nest_share_the_batch_and_time_themselves():
    srv = _server(trace=True)
    first = _serve(srv)
    second = _serve(srv, 2)
    spans = srv.recorder.spans
    tops = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in tops] == (
        ["serve.prefill"] + ["serve.decode_step"] * STEPS
        + ["serve.prefill"] + ["serve.decode_step"] * 2)
    # each top span is the server's own synchronised seconds
    assert [spans[i].ns / 1e9 for i in tops] == first + second
    for i in tops:
        kids = [j for j, s in enumerate(spans) if s.parent == i]
        want = (PREFILL_PARTS if spans[i].name == "serve.prefill"
                else ["serve.decode.issue", "serve.decode.sync"])
        assert [spans[j].name for j in kids] == want
        assert {spans[j].batch for j in kids} == {spans[i].batch}
        assert {spans[j].step for j in kids} == {spans[i].step}
        # siblings follow one another inside their parent, and its self
        # time is what they leave of it
        assert spans[kids[0]].start_ns == spans[i].start_ns
        assert spans[kids[-1]].end_ns == spans[i].end_ns
        for a, b in zip(kids, kids[1:]):
            assert spans[a].end_ns == spans[b].start_ns
        assert self_ns(spans, i) == spans[i].ns - sum(spans[j].ns
                                                      for j in kids)
        assert self_ns(spans, i) == 0
        assert all(self_ns(spans, j) == spans[j].ns for j in kids)
    assert [(spans[i].batch, spans[i].step) for i in tops] == (
        [(1, None)] + [(1, k) for k in range(STEPS)] + [(2, None)]
        + [(2, k) for k in range(2)])
    assert all(s.device_ms is None for s in spans)      # no card
    assert set(readings(spans)) == {"decode_issue_ms"}


def test_self_time_subtracts_the_union_of_the_children():
    spans = [Span("p", 0, 100, None, 1), Span("a", 10, 40, 0, 1),
             Span("b", 30, 60, 0, 1), Span("c", 90, 120, 0, 1),
             Span("p", 200, 260, None, 2), Span("a", 200, 220, 4, 2)]
    assert self_ns(spans, 0) == 100 - 50 - 10
    assert self_ns(spans, 1) == 30
    # medians by name, in ms, in the order the names first appear
    assert self_ms(spans) == pytest.approx(
        {"p": (40 + 40) / 2e6, "a": (30 + 20) / 2e6, "b": 30e-6,
         "c": 30e-6})
    assert list(self_ms(spans)) == ["p", "a", "b", "c"]
    assert self_ms(spans, batches={2}) == pytest.approx(
        {"p": 40e-6, "a": 20e-6})


def test_spans_map_onto_the_profilers_clock():
    srv = _server(trace=True)
    events = _serve_events(srv)
    rec = srv.recorder
    assert sorted(e.name() for e in events) == sorted(
        s.name for s in rec.spans)
    # a range opens just after its boundary, so every start lies after the
    # mapped one (up to the clocks' error); a worker that loses the CPU
    # between the two can delay one range by milliseconds, so the median
    # is held within 2 ms
    late = []
    for s in rec.spans:
        at = s.start_ns + rec.offset_ns
        late.append(min((e.start_ns() - at for e in events
                         if e.name() == s.name), key=abs))
    assert min(late) > -2e6, late
    assert statistics.median(late) < 2e6, late


def _span(name, start, end, parent, batch, device_ms=None, step=None):
    return Span(name, start, end, parent, batch, step, device_ms)


def made_up_batch(batch, at, spans):
    """A batch as the card records it: a 100 ms prefill (60 ms of step, 10
    of cache copy, 1 of argmax on the device) and two 20 ms decode steps,
    each with a 1 ms issue and a 19 ms replay; 1 ms apart."""
    ms = 1_000_000
    top = len(spans)
    spans.append(_span("serve.prefill", at, at + 100 * ms, None, batch))
    for name, d in (("serve.prefill.step", 60), ("serve.prefill.cache_copy",
                                                  10),
                    ("serve.prefill.sample", 1)):
        spans.append(_span(name, at, at + ms, top, batch, device_ms=d))
    at += 101 * ms
    for k in range(2):
        step = len(spans)
        spans.append(_span("serve.decode_step", at, at + 20 * ms, None,
                           batch, device_ms=19.0, step=k))
        spans.append(_span("serve.decode.issue", at, at + ms * (1 + k),
                           step, batch, step=k))
        at += 21 * ms
    return at


def test_readings_of_made_up_spans():
    spans = []
    at = made_up_batch(1, 0, spans)
    made_up_batch(2, at, spans)
    got = readings(spans, batches={2})
    assert got["decode_issue_ms"] == pytest.approx(1.5)
    assert got["decode_device_ms"] == pytest.approx(19.0)
    assert got["prefill_copy_ms"] == pytest.approx(10.0)
    # 71 + 2 x 19 ms of device intervals over 101 + 21 + 20 ms
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - 109 / 142))
    assert readings(spans) == pytest.approx(got)
    assert readings(spans, batches={3}) == {}


class Event:
    def __init__(self, name, start, dur, device=True, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._ann = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._ann


def test_step_kernels_counts_the_operations_a_step_starts():
    events = [Event("serve.decode_step", 0, 100, device=False),
              Event("serve.decode_step", 200, 100, device=False),
              Event("serve.decode_step", 0, 100, annotation=True),
              Event("serve.prefill", 400, 100, device=False),
              Event("k", 10, 5), Event("k", 20, 90), Event("k", 95, 30),
              Event("k", 110, 5),              # between the steps
              Event("k", 210, 5), Event("k", 220, 5),
              Event("k", 410, 5)]              # in the prefill
    assert step_kernels(events) == 2.5
    assert step_kernels(events[3:]) is None


def test_serve_cli_prints_the_trace(capsys):
    out = serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16",
                      "--decode-steps", "3", "--trace"])
    printed = capsys.readouterr().out.splitlines()
    launches = next(i for i, line in enumerate(printed)
                    if line.startswith("[serve] kernel launches"))
    trace = next(i for i, line in enumerate(printed)
                 if line.startswith("[serve] trace: decode issue"))
    assert trace > launches
    assert set(out["trace"]) == {"decode_issue_ms"}
    # the self time of each span kind of the batch read, which replays a
    # warm graph on the card (no capture off it)
    srv = out["server"]
    own = self_ms(srv.recorder.spans, batches={2})
    assert list(own) == ["serve.prefill"] + PREFILL_PARTS + [
        "serve.decode_step", "serve.decode.issue", "serve.decode.sync"]
    assert printed[trace + 1] == "[serve] self ms (median): " + "; ".join(
        f"{k} {v:.3f}" for k, v in own.items())
    # the counts by the spans, beside the port's own
    assert printed[trace + 2] == (
        f"[serve] counts: prefills 2, decode steps 6, replays 0; "
        f"decode kernel launches 0, of them with its K/V ring 0; "
        f"step functions {srv.kernel_cache.stats()}; kernels' library "
        f"build 0.0 s (0 where loaded or unused)")
    assert srv.captures == 0
