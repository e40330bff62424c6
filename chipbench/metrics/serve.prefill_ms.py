"""Median of the benchmark's synchronised spans around
``DecodeServer.prefill_batch`` over the window's batches, in ms."""
import statistics


def read(run):
    return statistics.median(run.prefill_s) * 1e3
