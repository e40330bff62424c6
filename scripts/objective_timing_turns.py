#!/usr/bin/env python3
"""How the kernel-tuning objective's timing moves BO's choice, in turns.

    python3 scripts/objective_timing_turns.py [--pairs 2]

On one NVIDIA card, BO (its surrogate on the GP kernel) tunes the decode
and the flash cell at gemma-2b's serving shapes in bf16 with the budgets of
``chip_smoke.py``'s phase 7, unjournaled, under three timings of
``KernelObjective``, in turns (ABC then CBA, ``--pairs`` times):

  one     one launch a rep between two CUDA events, the decode cell
          rebuilding its validity bias in every call (the objective as the
          port first had it);
  b2b     n back-to-back launches a rep, the bias built in every call, no
          spin ahead of them;
  spin    the objective as it stands: the bias built once per tile, n
          back-to-back launches queued behind a spin on the card.

Each run prints BO's best config and time, and that config re-timed by
``spin``, so the three choices compare on one yardstick.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# phase 7's cells and budgets: (B, S, H, KV, hd), fill, budget, init, reps
DECODE = ((4, 1088, 8, 1, 256), 0.97, 12, 4, 5)
FLASH = ((4, 1024, 8, 1, 256), 8, 3, 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.strategies.bo import BOConfig, BOStrategy
    from repro_torch.kernels import ops, tuning

    class OneLaunch(tuning.KernelObjective):
        def _rep_plan(self, cfg):
            return 1, 0.0

    class NoSpin(tuning.KernelObjective):
        def _rep_plan(self, cfg):
            return super()._rep_plan(cfg)[0], 0.0

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    (B, S, H, KV, hd), fill, d_budget, d_init, d_reps = DECODE
    dcell = tuning.decode_cell(B, S, H, KV, hd, fill=fill,
                               dtype=torch.bfloat16)
    q, k, v, cp, cu = dcell.meta["inputs"]

    def per_call_bias(cfg):
        return ops.decode_attention(q, k, v, cp, cu, block_kv=cfg["block_kv"],
                                    num_splits=cfg["num_splits"],
                                    combine=cfg["combine"])

    dcell_old = dataclasses.replace(dcell, run=per_call_bias)
    (fB, fS, fH, fKV, fhd), f_budget, f_init, f_reps = FLASH
    fcell = tuning.flash_cell(fB, fS, fH, fhd, KV=fKV, dtype=torch.bfloat16)
    cases = ((dcell, dcell_old, d_budget, d_init, d_reps),
             (fcell, fcell, f_budget, f_init, f_reps))
    timings = {"one": (OneLaunch, True), "b2b": (NoSpin, True),
               "spin": (tuning.KernelObjective, False)}
    order = ["one", "b2b", "spin"]
    for cell, old, budget, init, reps in cases:
        print(f"{cell.objective_id()}: budget {budget}, init {init}, "
              f"reps {reps}")
        yardstick = tuning.KernelObjective(cell, reps=reps)
        for turn in range(2 * args.pairs):
            for name in (order if turn % 2 == 0 else order[::-1]):
                cls, uses_old = timings[name]
                obj = cls(old if uses_old else cell, reps=reps)
                strat = BOStrategy(BOConfig(initial_samples=init,
                                            gp_backend="cuda",
                                            gp_device="cuda"))
                res = run_strategy(strat, obj, budget=budget, seed=0)
                cfg = cell.space.config(res.best_idx)
                print(f"  turn {turn} {name:4s}: best {cfg} "
                      f"{res.best_value * 1e3:.4f} ms; re-timed by spin "
                      f"{yardstick(res.best_idx) * 1e3:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
