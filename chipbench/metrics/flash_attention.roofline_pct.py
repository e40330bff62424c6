"""The prefill kernel's share of its roofline over the traced batch: the
causal attention's operations at the bf16 peak or its bytes (q, k, v and
the output once) at the HBM rate, whichever is longer, for every layer
(the family's ``flash_attention_bound_s``; a dense decoder's from (B, S,
H, KV, hd)), over the device time of ``flash_tc_kernel`` /
``flash_cc_kernel`` (``csrc/flash_attention.cu``), in %."""
KERNELS = ("flash_tc_kernel", "flash_cc_kernel")


def read(run):
    bound = getattr(run.cell.family, "flash_attention_bound_s", None)
    if run.trace is None or bound is None:
        return None
    t = run.trace.device_s(lambda name: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100 * bound(run.cell.dims, run.cell.batch) / t
