"""The trace's reduction and the metric readers, on made-up events, spans
and runs (no card): busy time is the union of the device's operations
inside the traced window, each idle gap is named by the benchmark span the
host was in, and the readers report nothing where they have nothing to
read."""
import json
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from chipbench import harness, work
from chipbench.families import dense
from chipbench.trace import TraceWindow, reduce

HERE = Path(__file__).resolve().parent


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


def test_busy_is_the_union_inside_the_window_and_gaps_are_named():
    events = [
        Event("chipbench.window", 100, 100, device=False),
        Event("chipbench.prefill", 100, 40, device=False),
        Event("chipbench.decode_step", 150, 50, device=False),
        Event("chipbench.decode_step", 150, 50, annotation=True),
        Event("k_before", 50, 60),          # 100..110 inside
        Event("k_a", 120, 20),              # 120..140
        Event("k_b", 130, 20),              # overlaps: union 120..150
        Event("k_c", 170, 50),              # 170..200 inside
    ]
    t = reduce(events)
    assert t.window_s == 100e-9
    assert t.busy_s == pytest.approx((10 + 30 + 30) * 1e-9)
    # gaps: 110..120 in the prefill span, 150..170 in a decode step
    assert dict(t.idle_by_span) == pytest.approx(
        {"chipbench.prefill": 10e-9, "chipbench.decode_step": 20e-9})
    assert "chipbench.decode_step" not in {n for n, _, _ in t.ops}
    assert t.device_s(lambda n: n.startswith("k_")) == pytest.approx(
        80e-9)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        reduce([Event("k", 0, 10)])


def run_with(trace=None, batch_s=(2.0, 2.0, 2.0)):
    dims = dict(num_hidden_layers=2, hidden_size=8, num_attention_heads=2,
                num_key_value_heads=1, head_dim=4, intermediate_size=8,
                vocab_size=16)
    cell = harness.Cell("c", dims, {"batch": 2, "prompt": 4, "output": 3},
                        {}, family=harness.family("dense"))
    return harness.Run(cell, window_s=6.0, batches=3, tokens=18,
                       ttft_s=[0.1] * 6, itl_s=[0.01] * 6,
                       prefill_s=[0.1] * 3, batch_s=list(batch_s),
                       trace=trace)


def test_readers():
    r = run_with()
    assert harness.reader("output_tok_s")(r) == 3.0
    assert harness.reader("ttft_p95_ms")(r) == pytest.approx(100.0)
    assert harness.reader("peak_mem_gib")(r) is None       # off the card
    assert harness.reader("serve.capture_s")(r) is None
    for name in ("products.roofline_pct", "flash_decode.roofline_pct",
                 "flash_attention.roofline_pct"):
        assert harness.reader(name)(r) is None, name
    flops = dense.model_flops(r.cell.dims, r.cell.batch)
    assert harness.reader("step.mfu_pct")(r) == pytest.approx(
        100 * 3 * flops / (6.0 * work.PEAK_BF16_FLOPS))
    # the profiled batch (the window's second) is left out of the MFU
    traced = run_with(TraceWindow(2.5, 2.0, [("nvjet_x", 0, 10**9)]),
                      batch_s=(2.0, 2.5, 2.0))
    assert harness.reader("step.mfu_pct")(traced) == pytest.approx(
        100 * 2 * flops / (4.0 * work.PEAK_BF16_FLOPS))
    assert harness.reader("products.roofline_pct")(traced) == pytest.approx(
        100 * dense.products_bound_s(r.cell.dims, r.cell.batch))
    assert harness.reader("flash_decode.roofline_pct")(traced) is None


def span(name, batch, device_ms=None):
    return {"name": name, "start_ns": 0, "end_ns": 1, "parent": None,
            "batch": batch, "step": 0, "device_ms": device_ms}


def test_decode_device_ms_reads_the_windows_unprofiled_replays():
    r = run_with()
    read = harness.reader("serve.decode_device_ms")
    assert read(r) is None                  # an untraced run keeps no spans
    # serial 2 is the warm-up's, 4 the profiled batch's
    r.window_batches = [(3, False), (4, True), (5, False)]
    r.spans = ([span("serve.decode_step", 2, 100.0)]
               + [span("serve.decode_step", 3, t) for t in (10.0, 12.0, 14.0)]
               + [span("serve.decode_step", 4, t) for t in (50.0, 60.0)]
               + [span("serve.decode_step", 5, t) for t in (11.0, 13.0)]
               + [span("serve.decode_step", 5),     # no device interval
                  span("serve.decode.issue", 3, 0.5),
                  span("serve.prefill.step", 5, 700.0)])
    assert read(r) == 12.0
    # off the card no span has a device interval
    r.spans = [span("serve.decode_step", 3), span("serve.decode_step", 5)]
    assert read(r) is None


def test_a_traced_run_keeps_the_programs_spans_of_its_window():
    """A ``--trace 1`` run's plumbing at the smoke size on the CPU: the
    server records its spans, the window's batches are the serials that
    their decode steps carry (the warm-up's two batches are not among
    them), the profiled one is marked, and the reader reads those spans:
    nothing off the card, where no span has a device interval."""
    with open(HERE / "testdata" / "smoke.json", encoding="utf-8") as f:
        c = json.load(f)
    out = 16
    cell = harness.Cell("smoke", c, {"batch": 4, "prompt": 64,
                                     "output": out}, {},
                        family=harness.family("dense"))
    run, _, _ = harness.serve(cell, 0, 0.0, device="cpu", t0=0.0,
                              trace=True, batches=3, log=lambda *a: None)
    serials = [b for b, _ in run.window_batches]
    assert [p for _, p in run.window_batches] == [
        i == harness.TRACED_BATCH for i in range(3)]
    assert run.trace is not None
    steps = {}
    for s in run.spans:
        if s["name"] == "serve.decode_step":
            steps.setdefault(s["batch"], []).append(s["step"])
    warm = sorted(set(steps) - set(serials))
    assert len(warm) == 2 and max(warm) < min(serials)
    assert all(steps[b] == [0] for b in warm)
    assert all(steps[b] == list(range(out - 1)) for b in serials)
    read = harness.reader("serve.decode_device_ms")
    assert all(s["device_ms"] is None for s in run.spans)
    assert read(run) is None
    # with a device interval on every step, the reader takes the window's
    # unprofiled batches' steps and no others
    for s in run.spans:
        if s["name"] == "serve.decode_step":
            s["device_ms"] = float(s["batch"])
    unprofiled = [b for b, p in run.window_batches if not p]
    assert read(run) == (min(unprofiled) + max(unprofiled)) / 2
