"""The trace's reduction and the metric readers, on made-up events and
runs (no card): busy time is the union of the device's operations inside
the traced window, each idle gap is named by the benchmark span the host
was in, and the readers report nothing where they have nothing to read."""
import pytest
from torch.autograd import DeviceType

from chipbench import harness, work
from chipbench.trace import TraceWindow, reduce


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
                        {})
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
    flops = work.model_flops(r.cell.dims, r.cell.batch)
    assert harness.reader("step.mfu_pct")(r) == pytest.approx(
        100 * 3 * flops / (6.0 * work.PEAK_BF16_FLOPS))
    # the profiled batch (the window's second) is left out of the MFU
    traced = run_with(TraceWindow(2.5, 2.0, [("nvjet_x", 0, 10**9)]),
                      batch_s=(2.0, 2.5, 2.0))
    assert harness.reader("step.mfu_pct")(traced) == pytest.approx(
        100 * 2 * flops / (4.0 * work.PEAK_BF16_FLOPS))
    assert harness.reader("products.roofline_pct")(traced) == pytest.approx(
        100 * work.products_bound_s(r.cell.dims, r.cell.batch))
    assert harness.reader("flash_decode.roofline_pct")(traced) is None
