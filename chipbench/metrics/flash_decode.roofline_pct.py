"""The decode kernel's share of its byte bound over the traced batch: K
and V of the valid slots, the query and the output of every layer and
decode step (``work.decode_attention_bound_s``, from (B, valid length, KV,
hd)) at the HBM rate, over the device time of ``decode_split_kernel``
(``csrc/flash_decode.cu``), in %."""
from chipbench import work

KERNEL = "decode_split_kernel"


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(lambda name: KERNEL in name)
    if t <= 0:
        return None
    return 100 * work.decode_attention_bound_s(run.cell.dims,
                                               run.cell.batch) / t
