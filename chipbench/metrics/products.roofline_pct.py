"""The weight products' share of their roofline over the traced batch: the
least time of every weight product of a batch (operations at the bf16 peak
or bytes at the HBM rate, each operand and result once; the family's
``products_bound_s``, for a dense decoder the projections, the MLP and the
head) over the device time of the cuBLAS kernels that ran them, in %."""
import re

#: cuBLAS's and cuBLASLt's product kernels on Hopper (nvjet, sm90 xmma,
#: CUTLASS instances, matrix-vector kernels and the split-K reduction)
PRODUCT = re.compile(r"nvjet|gemm|gemv|xmma|cutlass|splitKreduce", re.I)


def read(run):
    bound = getattr(run.cell.family, "products_bound_s", None)
    if run.trace is None or bound is None:
        return None
    t = run.trace.device_s(PRODUCT.search)
    if t <= 0:
        return None
    return 100 * bound(run.cell.dims, run.cell.batch) / t
