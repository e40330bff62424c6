"""The decode kernel's share of its byte bound over the traced batch: K
and V of the valid slots, the query and the output of every layer and
decode step at the HBM rate (the family's ``decode_attention_bound_s``; a
dense decoder's from (B, valid length, KV, hd)), over the device time of
``decode_split_kernel`` (``csrc/flash_decode.cu``), in %."""
KERNEL = "decode_split_kernel"


def read(run):
    bound = getattr(run.cell.family, "decode_attention_bound_s", None)
    if run.trace is None or bound is None:
        return None
    t = run.trace.device_s(lambda name: KERNEL in name)
    if t <= 0:
        return None
    return 100 * bound(run.cell.dims, run.cell.batch) / t
