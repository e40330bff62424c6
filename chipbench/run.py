"""Run one cell of the benchmark and print its result as one JSON line.

    python3 chipbench/run.py --workload stablelm-3b.long_ctx_decode \\
        --seed 1234 --seconds 30 --trace 0

Run from the root of a checkout, on a machine with the cards the cell asks
for. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (torch.profiler over one whole batch of the window).
Every run checks what the window served against the plain reference
(``chipbench/correct.py``) and prints each number compared beside its
limit, last on standard error and last in the JSON line. Exits nonzero,
printing no result, without CUDA or with fewer cards than the cell asks
for, or where JAX or the JAX package is loaded once the window has
closed. Logs go to standard error; the result is standard output's last
line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in the process that prints the
#: result: JAX and the JAX package (the port, ``repro_torch``, is another
#: name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """The loaded modules (``sys.modules`` unless given) whose top-level
    name, compared whole, is JAX's or the JAX package's."""
    return sorted(m for m in (sys.modules if modules is None else modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        bench = json.load(f)
    from chipbench import harness
    cell = harness.load_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        log("run: no CUDA device; the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"run: {cell.name} asks for {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    device = torch.device("cuda", 0)
    trace = bool(args.trace)
    run, finished, weights = harness.serve(
        cell, args.seed, args.seconds, device=device, t0=T0, trace=trace,
        log=log)
    metrics = harness.read_metrics(bench, run, trace)
    compared, tokens = harness.check(run, finished, weights, args.seed)
    del finished, weights
    # last, so that it sees what the metric readers and the comparison
    # loaded as well as the program
    found = forbidden_modules()
    if found:
        log(f"run: JAX or the JAX package is loaded: {found}")
        return 3
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": run.requests, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_by_span}
    result["compared"] = compared
    log(f"run: {cell.name} seed {args.seed}: {run.batches} batches, "
        f"{run.requests} requests, {run.tokens} tokens in "
        f"{run.window_s:.3f} s; set-up {run.setup_s:.3f} s; card "
        f"{card_line()}; {tokens} served tokens compared; prefill ms by "
        f"batch {[round(t * 1e3, 1) for t in run.prefill_s]}")
    for name, c in compared.items():
        log(f"compared: {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
