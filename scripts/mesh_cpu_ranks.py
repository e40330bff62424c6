#!/usr/bin/env python3
"""The mesh tests' rank jobs on this host's CPU, over gloo, without JAX.

    python3 scripts/mesh_cpu_ranks.py

Runs, in spawned CPU processes (``tests/torch_mesh_ranks.py``), the jobs
``tests/test_torch_mesh.py`` runs: gemma-2b's and internlm2-1.8b's smoke
step sharded over (data 2, model 2) against unsharded, then gemma-2b's
elastic restore onto (data 4, model 1) and onto no mesh (4 ranks), and
two AdamW steps of qwen3-moe-30b-a3b's smoke config over (data 4,
model 2) (8 ranks). It prints the torch version, each loss, the worst
gradient leaf's max|sharded - unsharded| / max|unsharded| and the
restore's bit equality, and exits 1 if the sharded step misses the tests'
rules (loss 1e-5 relative, gradients 1e-4) or a restore differs. It
needs no card and no reference package, so it checks the port's mesh
path against the torch a host has (the card's host among them).
"""
from __future__ import annotations

import os
import pathlib
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402


def main() -> int:
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import params as P
    print(f"torch {torch.__version__}, {os.cpu_count()} CPUs", flush=True)
    ok = True
    with tempfile.TemporaryDirectory(prefix="mesh_cpu_ranks_") as d:
        tmp = pathlib.Path(d)
        (tmp / "dense").mkdir()
        t0 = time.perf_counter()
        R.spawn(R.dense_job, 4, tmp / "dense", ["gemma-2b", "internlm2-1.8b"],
                str(tmp / "ckpt"), str(tmp / "out"))
        for name, got in torch.load(tmp / "out.steps").items():
            s, u = got["sharded"], got["unsharded"]
            rel = abs(s["loss"] - u["loss"]) / abs(u["loss"])
            worst = max(float((s["grads"][p] - g).abs().max()
                              / g.abs().max().clamp(min=1e-30))
                        for p, g in u["grads"].items())
            print(f"{name} (data 2, model 2): loss sharded {s['loss']:.7f}, "
                  f"unsharded {u['loss']:.7f} (rel {rel:.2e}); worst "
                  f"gradient leaf {worst:.2e}", flush=True)
            ok &= rel <= 1e-5 and worst <= 1e-4
        equal = torch.load(tmp / "out.restore")["equal"]
        print(f"gemma-2b restored (step, restored, bit-equal): {equal}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok &= all(v == (2, True, True) for v in equal.values())

        t0 = time.perf_counter()
        cfg = smoke_config("qwen3-moe-30b-a3b").replace(dtype="float32")
        torch.save(P.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu"), tmp / "params.pt")
        np.save(tmp / "tokens.npy", R.tokens(cfg.vocab_size, 8, 32))
        (tmp / "moe").mkdir()
        R.spawn(R.moe_steps, 8, tmp / "moe", cfg.name.removesuffix("-smoke"),
                4, 2, str(tmp / "params.pt"), str(tmp / "tokens.npy"), 2,
                str(tmp / "moe.pt"))
        losses = torch.load(tmp / "moe.pt")["losses"]
        print(f"qwen3-moe-30b-a3b (data 4, model 2), 2 AdamW steps: losses "
              f"{losses}; {time.perf_counter() - t0:.1f} s", flush=True)
        ok &= all(np.isfinite(losses)) and losses[1] < losses[0]
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
