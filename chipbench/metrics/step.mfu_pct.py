"""The whole step's share of the card's bf16 peak over the window: the
model's operations (the family's ``model_flops``, from the configuration
and the tokens done, the same for every batch of a cell) in every batch
that ran without the profiler, over those batches' wall seconds x 989
TFLOP/s, in %. The profiled batch is left out: under CUPTI it runs
slower."""
from chipbench import work


def read(run):
    flops = getattr(run.cell.family, "model_flops", None)
    spans = run.untraced_batch_s()
    if not spans or flops is None:
        return None
    total = flops(run.cell.dims, run.cell.batch) * len(spans)
    return 100 * total / (sum(spans) * work.PEAK_BF16_FLOPS)
