"""The readings a cell's correctness limit is set from, many seeds in one
process (the benchmark's own runs do not run this).

    python3 chipbench/calibrate.py --workload stablelm-3b.long_ctx_decode \\
        --seeds 101-112 --control 3 --out calib.jsonl

For each seed: the cell's weights and prompts from the seed, the program
set up and warmed up as in a run, as many whole batches at the cell's own
shapes as the comparison's sample needs, then the comparison
(``correct.compare``): the program's widest gap (the lower reading is the
largest over the seeds) and, on the first ``--control`` seeds, the
control's, the tokens that the fp8 reference puts first at the same
positions (the upper reading is the smallest). One JSON line a seed, on
standard output and appended to ``--out``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seed_list(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first-last")
    ap.add_argument("--control", type=int, default=3,
                    help="seeds (the first ones) that also read the control")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from chipbench import correct, harness
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        cell = harness.load_cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    n = cell.check["requests"]
    batches = math.ceil(n / cell.batch.batch)
    for i, seed in enumerate(seed_list(args.seeds)):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run, finished, weights = harness.serve(
            cell, seed, 0.0, device="cuda", t0=T0 if i == 0 else t,
            batches=batches, log=lambda *a: print(*a, file=sys.stderr))
        t_ref = time.perf_counter()
        got = correct.compare(cell, weights, finished, n, seed,
                              control=i < args.control)
        line = {"cell": cell.name, "seed": seed, **got,
                "reference_s": time.perf_counter() - t_ref,
                "setup_s": run.setup_s,
                "ttft_ms": statistics.median(run.prefill_s) * 1e3,
                "itl_ms": statistics.median(run.itl_s) * 1e3,
                "peak_bytes": run.peak_bytes}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(json.dumps(line) + "\n")
        del run, finished, weights
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
