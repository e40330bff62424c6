"""The prefill kernel's share of its roofline over the traced batch: the
causal attention's operations at the bf16 peak or its bytes (q, k, v and
the output once) at the HBM rate, whichever is longer, counted from
(B, S, H, KV, hd) for every layer (``work.flash_attention_bound_s``), over
the device time of ``flash_tc_kernel`` / ``flash_cc_kernel``
(``csrc/flash_attention.cu``), in %."""
from chipbench import work

KERNELS = ("flash_tc_kernel", "flash_cc_kernel")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100 * work.flash_attention_bound_s(run.cell.dims,
                                              run.cell.batch) / t
