"""Median device time of a decode step: the CUDA-event interval of the
graph replay that the program's ``serve.decode_step`` span carries
(``launch/spans.py``), over the window's batches that ran without the
profiler (the warm-up's batches and the profiled one left out), in ms.
None where no such span has a device interval, as off the card."""
import statistics


def read(run):
    batches = {b for b, profiled in run.window_batches if not profiled}
    times = [s["device_ms"] for s in run.spans
             if s["name"] == "serve.decode_step" and s["batch"] in batches
             and s["device_ms"] is not None]
    return statistics.median(times) if times else None
