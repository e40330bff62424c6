"""The dense products' share of their roofline over the traced batch: the
least time of every weight product (projections, MLP, head; operations at
the bf16 peak or bytes at the HBM rate, each operand and result once,
``work.products_bound_s``) over the device time of the cuBLAS kernels that
ran them, in %."""
import re

from chipbench import work

#: cuBLAS's and cuBLASLt's product kernels on Hopper (nvjet, sm90 xmma,
#: CUTLASS instances, matrix-vector kernels and the split-K reduction)
PRODUCT = re.compile(r"nvjet|gemm|gemv|xmma|cutlass|splitKreduce", re.I)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(PRODUCT.search)
    if t <= 0:
        return None
    return 100 * work.products_bound_s(run.cell.dims, run.cell.batch) / t
