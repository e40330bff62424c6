#!/usr/bin/env python3
"""The mesh tests' rank jobs on this host's CPU, over gloo, without JAX.

    python3 scripts/mesh_cpu_ranks.py

Runs, in spawned CPU processes (``tests/torch_mesh_ranks.py``), the jobs
the mesh tests run, each sharded step against the port's unsharded one on
the same weights and batch:

- dense: gemma-2b's and internlm2-1.8b's smoke step over (data 2,
  model 2), then gemma-2b's elastic restore onto (data 4, model 1) and
  onto no mesh (4 ranks);
- families: recurrentgemma-9b, xlstm-1.3b (per-step and chunkwise
  mLSTM) and musicgen-large over (data 2, model 2); gemma-2b at
  ``microbatches`` 2 over (data 2, model 2) against unsharded at 2;
  deepseek-v3-671b over (data 1, model 4), where the MoE dispatches in one
  group on both sides (4 ranks each);
- moe: two AdamW steps of qwen3-moe-30b-a3b's smoke config over (data 4,
  model 2) (8 ranks; its groups differ from the unsharded step's, so only
  the losses' fall is held);
- blocks: ``sharding.block_local``'s (rows, channels) and (rows, heads)
  blocks over (data 2, model 2) against the unsharded call;
- seq: the reference's sequence rules. Every family's smoke step under
  ``act_seq=model``, the MoE families over (data 1, model 4) (one
  dispatch group on both sides), the others over (data 2, model 2); then
  gemma-2b, recurrentgemma-9b and deepseek-v3-671b served (a prefill of 32
  tokens, 3 decode steps) over (data 1, model 4) under
  ``act_cache_seq=model`` and under both rules, and gemma-2b with the
  decode kernel opted in, against the same steps off the mesh (logits
  within 1e-5 of max|logits|).

It prints the torch version, each loss, the worst gradient leaf's
max|sharded - unsharded| / max|unsharded|, the restore's bit equality and
the served logits' difference, and exits 1 if a sharded step misses the
tests' rules (loss 1e-5 relative, gradients 1e-4, logits 1e-5 of
max|logits|) or a restore differs. ``python3 scripts/mesh_cpu_ranks.py
seq`` runs one job. It needs no card and no
reference package, so it checks the port's mesh path against the torch a
host has (the card's host among them).
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

LOSS_RTOL, GRAD_RTOL, LOGITS_RTOL = 1e-5, 1e-4, 1e-5
FAMILIES = ((1, 4, [("deepseek-v3-671b", {})]),
            (2, 2, [("recurrentgemma-9b", {}), ("xlstm-1.3b", {}),
                    ("xlstm-1.3b", {"mlstm_chunk": 8}), ("musicgen-large", {}),
                    ("gemma-2b", {"microbatches": 2})]))


def held(results, mesh: str) -> bool:
    """Print and hold each run of ``sharded_vs_unsharded``."""
    ok = True
    for name, got in results.items():
        s, u = got["sharded"], got["unsharded"]
        rel = abs(s["loss"] - u["loss"]) / abs(u["loss"])
        path, worst = max(((p, float((s["grads"][p] - g).abs().max()
                                     / g.abs().max().clamp(min=1e-30)))
                           for p, g in u["grads"].items()),
                          key=lambda pw: pw[1])
        print(f"{name} ({mesh}): loss sharded {s['loss']:.7f}, unsharded "
              f"{u['loss']:.7f} (rel {rel:.2e}); worst gradient leaf "
              f"{path} {worst:.2e}", flush=True)
        ok &= rel <= LOSS_RTOL and worst <= GRAD_RTOL
    return ok


def dense(tmp: pathlib.Path) -> bool:
    R.spawn(R.dense_job, 4, tmp, ["gemma-2b", "internlm2-1.8b"],
            str(tmp / "ckpt"), str(tmp / "out"))
    ok = held(torch.load(tmp / "out.steps"), "data 2, model 2")
    equal = torch.load(tmp / "out.restore")["equal"]
    print(f"gemma-2b restored (step, restored, bit-equal): {equal}",
          flush=True)
    return ok and all(v == (2, True, True) for v in equal.values())


def families(tmp: pathlib.Path) -> bool:
    ok = True
    for data, model, runs in FAMILIES:
        group = tmp / f"{data}x{model}"      # a rendezvous file a group
        group.mkdir()
        out = group / "out.pt"
        R.spawn(R.sharded_vs_unsharded, 4, group, runs, data, model,
                str(out), False)
        ok &= held(torch.load(out), f"data {data}, model {model}")
    return ok


def moe(tmp: pathlib.Path) -> bool:
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import params as P
    name = "qwen3-moe-30b-a3b"
    cfg = smoke_config(name).replace(dtype="float32")
    torch.save(P.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
               tmp / "params.pt")
    np.savez(tmp / "batch.npz", **R.batch_np(cfg, 8, 32))
    R.spawn(R.mesh_steps, 8, tmp, 4, 2, [(name, {}, str(tmp / "params.pt"),
                                          str(tmp / "batch.npz"), 2)],
            str(tmp / "moe.pt"))
    losses = torch.load(tmp / "moe.pt")[name]["losses"]
    print(f"{name} (data 4, model 2), 2 AdamW steps: losses {losses}",
          flush=True)
    return all(np.isfinite(losses)) and losses[1] < losses[0]


def blocks(tmp: pathlib.Path) -> bool:
    R.spawn(R.block_checks, 4, tmp, 2, 2, str(tmp / "blocks.pt"))
    res = torch.load(tmp / "blocks.pt")
    s, u = res["sharded"], res["unsharded"]
    out = max(float((a - b).abs().max()) for a, b in zip(s["outs"],
                                                         u["outs"]))
    grad = max(float((s["grads"][p] - g).abs().max())
               for p, g in u["grads"].items())
    print(f"block_local (data 2, model 2): max|d| outputs {out:.2e}, "
          f"gradients {grad:.2e}; output placements {s['out_placements']}",
          flush=True)
    return out <= 1e-5 and grad <= 1e-5


SEQ, CACHE = {"act_seq": "model"}, {"act_cache_seq": "model"}
SEQ_FAMILIES = ((1, 4, [("deepseek-v3-671b", SEQ),
                        ("qwen3-moe-30b-a3b", SEQ)]),
                (2, 2, [(n, SEQ) for n in ("gemma-2b", "recurrentgemma-9b",
                                           "xlstm-1.3b", "musicgen-large")]))
SEQ_SERVE = [(n, rules) for n in ("gemma-2b", "recurrentgemma-9b",
                                  "deepseek-v3-671b")
             for rules in (CACHE, {**SEQ, **CACHE})] + [
    ("gemma-2b", {**CACHE, "kernel": {"use_decode": True,
                                      "decode_block_kv": 8,
                                      "decode_num_splits": 1}})]


def seq(tmp: pathlib.Path) -> bool:
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import params as P
    ok = True
    for data, model, runs in SEQ_FAMILIES:
        group = tmp / f"train{data}x{model}"
        group.mkdir()
        R.spawn(R.sharded_vs_unsharded, 4, group, runs, data, model,
                str(group / "out.pt"), False)
        ok &= held(torch.load(group / "out.pt"), f"data {data}, model "
                   f"{model}")
    runs = []
    for name, pkw in SEQ_SERVE:
        cfg = smoke_config(name).replace(dtype="float32")
        torch.save(P.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu"), tmp / f"{name}.pt")
        np.savez(tmp / f"{name}.npz", tokens=R.tokens(cfg.vocab_size, 4, 35))
        runs.append((name, pkw, str(tmp / f"{name}.pt"),
                     str(tmp / f"{name}.npz"), 32, 36))
    for sub in ("mesh", "off"):
        (tmp / sub).mkdir()
    R.spawn(R.serve_steps, 4, tmp / "mesh", 1, 4, runs, str(tmp / "mesh.pt"))
    R.spawn(R.serve_steps, 1, tmp / "off", 0, 0, runs, str(tmp / "off.pt"))
    mesh, off = torch.load(tmp / "mesh.pt"), torch.load(tmp / "off.pt")
    for tag, got in mesh.items():
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got["logits"], off[tag]["logits"])]
        print(f"{tag} (data 1, model 4): prefill and decode logits, "
              f"max|d| / max|unsharded| {[f'{e:.1e}' for e in errs]}; "
              f"decode kernel calls {got['calls']}", flush=True)
        ok &= max(errs) <= LOGITS_RTOL
        if "kernel" in tag:
            ok &= got["calls"]["partials"] > 0
    return ok


JOBS = {"dense": dense, "families": families, "moe": moe, "blocks": blocks,
        "seq": seq}


def main() -> int:
    print(f"torch {torch.__version__}, {os.cpu_count()} CPUs", flush=True)
    ok = True
    with tempfile.TemporaryDirectory(prefix="mesh_cpu_ranks_") as d:
        for name in sys.argv[1:] or JOBS:
            tmp = pathlib.Path(d) / name
            tmp.mkdir()
            t0 = time.perf_counter()
            passed = JOBS[name](tmp)
            print(f"[{name}] {'ok' if passed else 'FAILED'} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            ok &= passed
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
