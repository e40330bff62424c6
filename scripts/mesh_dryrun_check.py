#!/usr/bin/env python3
"""The mesh dry-run's counts on this host's torch, without JAX or a card.

    python3 scripts/mesh_dryrun_check.py [--scan] [--out FILE]

Traces each family's smoke config (train, prefill and decode, B 8 x S 16)
on meta DTensors over fake worlds of (data 1, model 1), (data 4, model 1)
and (data 2, model 4) (``launch/mesh.fake_mesh``), and on one card, and
prints each mesh's FLOPs x ranks, bytes, arguments and temps over one
card's, with its collective bytes: on (1, 1) every ratio is 1, on
(4, 1) the FLOPs ratio is 1. It exits 1 if a cell fails or a train
cell's (1, 1) or (4, 1) FLOPs ratio is not 1. The tests hold these on
the torch they run with; this holds the DTensor a host has (the card
host's among them) to the same counts.

``--scan``: xlstm-1.3b at its full widths, one repeat of its layer
pattern, B 4 x S 1,024 under remat "full" (``chip_smoke.py`` phase 17 at
S 1,024): the temps' peak carried from 4 and 8 scan steps
(``dryrun.measure``) against a whole trace of the 1,024 steps.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MESHES = ((1, 1), (4, 1), (2, 4))


def smoke_cells() -> tuple:
    import torch
    from repro_torch.configs.arch import ShapeConfig
    from repro_torch.configs.registry import ARCHS, smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.parallel.sharding import ParallelConfig
    print(f"torch {torch.__version__}", flush=True)
    pcfg = ParallelConfig(logits_chunk=0)
    rows, bad = [], 0
    for arch in ARCHS:
        cfg = smoke_config(arch)
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("s", 16, 8, kind)
            one = D.trace_step(cfg, shape, pcfg)
            for dims in MESHES:
                n = dims[0] * dims[1]
                t0 = time.perf_counter()
                try:
                    with fake_mesh(dims, ("data", "model")) as mesh:
                        r = D.trace_step(cfg, shape, pcfg, mesh=mesh)
                except Exception as e:  # noqa: BLE001 — reported, counted
                    bad += 1
                    print(f"{arch} {kind} {dims}: FAIL {type(e).__name__}: "
                          f"{e}", flush=True)
                    continue
                row = {"arch": arch, "kind": kind, "mesh": list(dims),
                       "flops_x_n": r["flops"] * n / one["flops"],
                       "bytes": r["bytes"] / one["bytes"],
                       "args": r["args"] / one["args"],
                       "temp": r["temp"] / one["temp"], "coll": r["coll"],
                       "dcn": r["dcn"], "s": time.perf_counter() - t0}
                rows.append(row)
                if kind == "train" and n <= 4 and dims[1] == 1 and \
                        row["flops_x_n"] != 1:
                    bad += 1
                print(f"{arch} {kind} {dims}: FLOPs x {n} / one card "
                      f"{row['flops_x_n']:.4f}, bytes {row['bytes']:.4f}, "
                      f"arguments {row['args']:.4f}, temps "
                      f"{row['temp']:.4f}, collectives {r['coll']:,} B "
                      f"({r['dcn']:,} across nodes), {row['s']:.2f} s",
                      flush=True)
    return rows, bad


def scan_check() -> dict:
    from repro_torch.configs.arch import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel.sharding import ParallelConfig
    cfg = get_arch("xlstm-1.3b")
    one = D._at_depth(cfg, D._depth_plan(cfg), 1)
    shape = ShapeConfig("train_1k_b4", 1024, 4, "train")
    pcfg = ParallelConfig(flash_threshold=1 << 30, logits_chunk=0,
                          mlstm_chunk=64, remat="full")
    t0 = time.perf_counter()
    cut = D.measure(one, shape, pcfg)
    t_cut = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = D.trace_step(one, shape, pcfg)
    t_whole = time.perf_counter() - t0
    out = {"layers": one.num_layers, "cut_temp": cut["temp"],
           "whole_temp": whole["temp"], "cut_s": t_cut, "whole_s": t_whole,
           "flops_equal": cut["flops"] == whole["flops"],
           "bytes_equal": cut["bytes"] == whole["bytes"]}
    print(f"xlstm-1.3b, {one.num_layers} layers, B 4 x S 1,024, remat full: "
          f"temps carried from {list(D.SCAN_STEPS)} steps "
          f"{cut['temp'] / 2**30:.4f} GiB ({t_cut:.1f} s), whole trace "
          f"{whole['temp'] / 2**30:.4f} GiB ({t_whole:.1f} s); FLOPs equal "
          f"{out['flops_equal']}, bytes equal {out['bytes_equal']}",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scan", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows, bad = smoke_cells()
    out = {"cells": rows}
    if args.scan:
        out["scan"] = scan = scan_check()
        bad += not (scan["flops_equal"] and scan["bytes_equal"]
                    and scan["cut_temp"] == scan["whole_temp"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"{len(rows)} mesh cells traced, {bad} failed", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
