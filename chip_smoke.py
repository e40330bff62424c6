#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, and check it.

    python3 chip_smoke.py            # every phase, on cuda:0
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, in order; any failure exits non-zero and prints no result:
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel under src/repro_torch/kernels/csrc, registers per thread
     and spills of every instance;
  2. each CUDA kernel against its plain PyTorch version on the card: GEMM in
     fp32 and bf16 at 128³, 256x384x512 and 4096³ under the block configs
     the resource model passes, and at 4096³ fp32 against an fp64 product
     on the card (the kernel's error at most 4x the plain version's); the
     Matérn-GP posterior for all four ν at (t,N,d) = (13,512,6),
     (37,1024,15) and the paper's panel (220,18432,15) padded to T = 256;
     flash attention in fp32 (CUDA cores) and bf16 (tensor cores), causal
     and full (causal=False), at small shapes, S 192, gemma-2b's prefill
     (B 4, S 1,024, H 8, KV 1, hd 256), stablelm-3b's (H 32, KV 32, hd 80)
     and qwen3-moe's (H 32, KV 4, hd 128) under several blocks: block_q !=
     block_kv, one and two warpgroups, block_kv > 64 (successive 64-key
     updates); flash decode, every config both ways (one launch with the
     combine fused in, and the partials mode + the tensor-op combine), in
     fp32 and bf16 at gemma-2b's decode (B 4, capacity 1,088, H 8, KV 1,
     hd 256) and at its widths with B 1, at G = 1 and 2, at qwen3-moe's
     decode (H 32, KV 4), mistral-large's (G 12) and stablelm-3b's (hd 80),
     at G 12 and 16 with hd 80 and 128, with one block a head group, and on
     a mostly empty cache, a capacity that does not tile, windows with and
     without wrap-around, and a row with no valid slot (exact zeros), the
     partials held against the plain version's too (splits of padding only
     exactly m = -inf, l = 0, o = 0);
  3. the self-hosting cell: BO tunes the GP kernel's block_n at the paper's
     panel, journaled into a temporary store, and tuned_gp_block_n reads
     the stored best back;
  4. slice 1's main path: BO, its surrogate on the GP kernel with that
     block_n, tunes the 4096³ fp32 GEMM kernel, journaled into the store;
  5. the paper-scale surrogate: advanced_multi BO over the paper's CLBlast
     GEMM space (17,956 configs) for 220 evaluations with gp_backend="cuda",
     beside a gp_backend="numpy" run of the same seed;
  7. BO, its surrogate on the GP kernel, tunes the serve kernels at
     gemma-2b's shapes and at qwen3-moe-30b-a3b's in bf16: the decode cell,
     then the flash cell, journaled into the same store;
  8. slice 2's main path: launch/serve.py's DecodeServer serves gemma-2b
     at full width and depth (random bf16 weights from a seed): prefill of
     4 x 1,024 tokens, 64 greedy decode steps, each a replay of the decode
     step's captured CUDA graph, blocks resolved from the store; its logits
     are held against the plain attention path, teacher-forced on the same
     tokens; one decode launch a layer, the combine fused in, on the path
     or in an extra decode run of 8 steps (replays count the launches they
     hold, and a capture's warm-up step its own); the graph's logits
     against the eager step function's on the same state (bit for bit or
     not, within the serve limit); ms/step eager against graph in turns;
 10. the online loop on a copy of the phase-7 store, as serve --online
     --kernels wires it: gemma-2b at prompt 1,024 and 128 steps (a cache
     of 1,152, a decode cell never tuned: stale), one durable job, the
     retune daemon's BO on the card (the GP kernel its surrogate) journaled
     under its fence token, the hot-swap at the next poll (or the source's
     reason to keep its config), a forced swap back that must be a graph-
     cache hit, prod records, every decode launch fused, and the last steps
     against the plain attention path;
 11. slice 7's main path, the paper's comparison set: (a) Fig. 1's seven
     strategies, Fig. 5's two framework analogues and BO on the padded GP
     (engine="jax") over the GTX Titan X GEMM space (17,956 configs) at
     the paper's budget of 220, BO's surrogate on the GP kernel and the
     padded GPs on the card: MAE, best, evaluations, wall and tuner time,
     GP launches; each baseline against its run on the CPU, each padded
     GP's last state against the CPU and float64, its fit + predict ms;
     (b) pool BO, its surrogate on the GP kernel, over a 1.07e9-config
     generative space beside the numpy surrogate's run (feasible, no
     revisit, the same initial sample, the posterior at pool sizes that do
     not tile the kernel's block), and the wide qwen3-moe sharding space
     (size, feasible-fraction estimate, first sample); (c) the four
     baselines and the two frameworks tune phase 4's GEMM cell with its
     budget, journaled into the store (best, evaluations to it, static and
     runtime invalids);
  6. yardsticks at the blocks phases 4 and 8 ran: kernel, plain-version
     and library times (CUDA events around one call) beside each kernel's
     bound (GEMM and GP: on the path the kernel takes, the tensor cores,
     and on the CUDA cores), and the bf16 GEMM beside torch.matmul;
  9. torch.profiler, last (a profiler session leaves host overhead behind
     it): the device's busy share over a prefill and over 4 decode steps of
     the phase-8 server (graph replays, no logits kept), the kernels that
     took its time (one decode kernel a layer and step), and each phase-6
     call's device time (kernels only, no host launch time), the flash
     kernel's full-attention instance beside SDPA(is_causal=False) among
     them; the fused decode call launches one kernel. The
     combine's time is the fused launch's less the partials-mode launch's,
     on the same inputs, timed in turns;
 12. slice 8's main path, after the gemma-2b server is freed: DecodeServer
     serves qwen3-moe-30b-a3b at full width and depth (48 layers, 30.5 B
     random bf16 parameters from a seed), blocks resolved from the phase-7
     store, prefill 4 x 1,024 and 64 graph replays: prefill ms, ms/step,
     tokens/s, peak memory, launches (one fused decode launch a layer and
     step, no call of a plain attention core), the logits against the
     plain attention path teacher-forced (2e-2 x max|logits|), the share of
     top-k routing choices that differ between the kernel and plain paths
     (where the limit is missed through them: each kernel call held to its
     plain version on its own inputs, and the rows whose routing agreed in
     every layer to the limit), the step beside its byte bounds (every
     expert read, the routed only); then internlm2-1.8b and stablelm-3b at
     full depth, mistral-large-123b at 4 layers and chameleon-34b at 8, each
     at full width, 8 graph steps, the same limit; each model's two
     attention kernels at its shapes against their plain versions, timed
     (events and device) beside their bounds and SDPA; each model freed
     before the next.
 13. slice 9's main path: DecodeServer serves the last four families at
     full width with KernelConfig(use_flash, use_decode), random bf16
     weights from seed 0, batch 4: recurrentgemma-9b at 20 of 38 layers
     (prompt 3,072 past its 2,048 window: the rolling cache, the blockwise
     attention, the decode kernel at G 16 with the window),
     deepseek-v3-671b at 5 of 61 layers (MLA, 256 experts), musicgen-large
     at 24 of 48 (frame embeddings, cross-attention, both kernels at hd 64)
     and xlstm-1.3b at 24 of 48 blocks (mlstm_chunk 64); prefill ms, ms/step, tokens/s, peak memory, the step's byte
     bound; the reference's dispatch (flash launches a prefill, decode
     launches a step, the plain core of each other attention layer), each
     kernel call against its plain version, the served logits against the
     plain path (the section-6 rules where 2e-2 is missed), graph replays
     against the eager step bit for bit, the recurrent state carried from
     a prefill into a graph step, xlstm's chunkwise and per-step scans;
     a profile of a prefill and of 4 steps; the kernels at each model's
     shapes timed beside bound and SDPA.
 14. slice 10's main path, training, after the last model is freed: (a)
     one train step's loss and every gradient leaf of gemma-2b at full
     width cut to 2 layers, fp32 with TF32 off, B 1 x S 256, on the card
     against the CPU (loss 1e-5 relative, each leaf 1e-3 of its max); (b)
     TrainLoop on gemma-2b whole (18 layers, 2.51 B parameters, bf16
     weights, fp32 AdamW moments) with the reference's loop defaults
     (remat "none", unchunked cross-entropy, materialized attention),
     SyntheticLM over the 256,000 vocab, B 4 x S 1,024, 8 steps at peak
     LR 3e-4: ms/step, tokens/s, peak memory, losses (the last two below
     the first two), the operations and optimizer-byte bounds, no kernel
     launched, one step in parts (forward, backward, optimizer) timed
     with CUDA events and profiled; (c) the same first step with
     remat="full": the same loss (1e-6), its peak memory; (d) the restart
     drill at internlm2-1.8b's smoke config (checkpoints every 5, failure
     at 8, resume at 5, finish at 14, the manifest read back); (e) a train
     step with the flash kernel opted in, and the flash wrapper handed a
     CUDA operand that requires grad, both raise.
 15. slice 11, the dry-run tooling (meta-tensor traces, no kernel): (a)
     phase 14's cell (gemma-2b whole, B 4 x S 1,024, remat "none") and
     phase 8's decode (B 4, capacity 1,088, plain attention) traced by
     launch/dryrun.measure and run on the card: arguments equal to the
     byte (the decode cache too), FLOPs equal to FlopCounterMode over the
     card's step, the dry peak within 10% of the arguments plus
     max_memory_allocated above them, the step's time beside the
     roofline; CARD_MEMORY against the card's total_memory; (b) every
     arch x shape cell for the card in worker processes (status,
     arguments, peak against the card's memory, dominant term, step time,
     useful FLOPs ratio, cuts, trace seconds); every admitted cell ok;
     (c) BO (ei) through DryRunObjective, 24 evaluations journaled into
     the phase-3 store, at gemma-2b's prefill_32k (the reference's cell)
     and prefill_32k_b4 (phase 8's batch, where the knobs decide: valid
     and invalid configs), resolved back by serve.resolve_pcfg under the
     card's key, dryrun_objective_for serving the key and refusing
     "single"; (d) gradient compression on CUDA tensors at world size 1
     against the CPU's.
 16. slice 12, training on a device mesh: an NCCL process group of one
     rank, make_host_mesh(data=1, model=1), gemma-2b's TrainLoop(mesh=...)
     at phase 14's cell and parallel config for 2 steps, its weights,
     moments and batches DTensors: the losses held to phase 14's first two
     (REMAT_RTOL, bit equality stated), step times and peak memory beside
     phase 14's, no kernel launched; the group destroyed before the
     summary. More than one rank runs on the CPU only (tests over gloo).
 17. slice 13, every family on a mesh: xlstm-1.3b at full width and
     depth (48 blocks, d 2,048, 7 mLSTM : 1 sLSTM; the family whose mesh
     path runs the most per-rank code, sharding.block_local) through
     TrainLoop at B 4 x S 256, the chunkwise mLSTM (chunk 64) and remat
     "full", MESH_STEPS steps with no mesh and then on a one-rank NCCL
     mesh, at microbatches 1 and then 2: each pair's losses held bit for
     bit (else within REMAT_RTOL, the reason printed), each run's step ms,
     first step ms, peak memory and kernel launches (none: the training
     path reaches no kernel); the group destroyed before the summary.
 18. slice 14, the dry-run on the card's production meshes (meta DTensors
     over a fake world of 256 or 512 ranks, each mesh cell traced in a
     worker process; no kernel): (a) phase 14's cell on a 1 x 1 mesh
     against its one-card record: arguments, temps, FLOPs and bytes
     equal, no collective bytes; (b) every arch x shape cell on the
     single (data 32, model 8) and multi (pod 2, data 32, model 8) meshes:
     fits or not, a card's peak against its memory, the dominant term,
     t_collective, the NVLink and InfiniBand bytes a card, the trace
     seconds; every admitted cell ok; (c) BO (ei) through
     DryRunObjective(mesh="single") at deepseek-v3-671b's decode_32k,
     each config traced in a child process, journaled under
     dryrun[...×single-<card>] in a store of its own and resolved back by
     that id only, with embed_rule and experts_rule each moving the
     value; (d) the cells that fit each mesh beside those that fit one
     card (phase 15); (e) slice 15's sequence rules on single, each cell
     beside its default record from (b): gemma-2b's decode_32k under
     act_cache_seq=model (its cache a card an eighth of the default's)
     and its train_4k under act_seq=model, a card's peak, cache bytes and
     collective bytes by kind and by link.
 19. slice 15, serving on a device mesh: gemma-2b whole served off a mesh
     with phase 8's tuned kernels (DecodeServer, a prefill of 4 x 1,024
     and 4 graph steps), then the same prefill and steps on a one-rank
     NCCL mesh (DTensor weights, batch and cache, each step fed the
     server's token): the flash kernel launched once a layer, the decode
     kernel once a layer and step (the mesh path goes through both kernel
     gates), the logits bit-equal to the served ones (else within phase
     12's 2e-2 x max|logits|, the difference printed).
 20. slice 16, the rest of the paper's evaluation through
     launch/compare.py at the reference's budgets, caps and sizes, one
     seed each: Fig. 4 (EI at 220 evaluations on the GTX Titan X GEMM
     space, the four baselines to 1,020), Figs. 6-7 (ExpDist and Adding on
     the A100 spaces, the seven strategies), Table I's ten BO variants on
     pnpoly (matern52 and rbf among them), and the cross-size warm start
     (3 source runs at sequence 512 into a temporary store, a cold and a
     warm run at 4,096), on ExpDist, the reference's, and on GEMM, whose
     256 priors beside 220 evaluations take the GP kernel to T 512; every
     BO run launches the GP kernel at least once an iteration, every
     baseline's trace is the CPU's, no config is evaluated twice; suggest
     ms a proposal by T stage, and the GP kernel at GEMM's warm run's last
     state (T 512) against its plain version.
The line before the last holds the kernels' JSON summary (times are the
phase-9 device times, the phase-6 event times where the profiler saw none;
the GEMM's and the GP kernel's launches are phases 4, 11 and 20 together;
the entries named ``kernel@arch`` are phases 12's and 13's instances, with
that model's launches and times, ``matern_gp@T512`` phase 20's warm run),
the one before it the card's name and power limit; the last line is the
device JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

GEMM_SHAPES = ((128, 128, 128), (256, 384, 512), (4096, 4096, 4096))
GEMM_BLOCKS = ((64, 64, 64), (128, 128, 64), (64, 128, 128), (128, 64, 256),
               (128, 128, 128),
               # next to the reference's 256³ default, where the resource
               # model passes them (1 to 4 ring stages)
               (256, 128, 64), (128, 256, 64), (256, 128, 128),
               (128, 256, 128), (256, 64, 64), (64, 256, 64))
# the last pads T to 1024: 513 to 1024 observations, from a budget over
# 512 or warm-start priors. Its observations are distinct candidates, as a
# BO run makes them; the others are drawn with repeats
GP_T1024 = (600, 2048, 15)
GP_SHAPES = ((13, 512, 6), (37, 1024, 15), (220, 18432, 15), GP_T1024)
MAIN_GEMM = (4096, 4096, 4096)
MAIN_GP = (220, 18432, 15)          # 17,956 candidates padded to a tile multiple
MAIN_T = 256
# flash attention: (B, S, H, KV, hd) and (block_q, block_kv)
FLASH_SHAPES = ((1, 256, 4, 4, 64), (2, 512, 4, 2, 128), (4, 1024, 8, 1, 256),
                (2, 192, 4, 2, 128), (2, 192, 4, 2, 80),
                # stablelm-3b's prefill (hd 80, MHA) and qwen3-moe's (G 8)
                (4, 1024, 32, 32, 80), (4, 1024, 32, 4, 128))
# bf16: block_kv > 64 is successive 64-key updates, block_q a multiple of
# 128 puts two warpgroups in a block, block_q 64 one
FLASH_BLOCKS = ((128, 128), (128, 64), (64, 128), (256, 128), (128, 256),
                (512, 256), (64, 64), (128, 512))
GEMMA_FLASH = (4, 1024, 8, 1, 256)
# flash decode: (name, B, S, H, KV, hd, cur, window, rolling); cur per row
# where it is a tuple (-1: a row with no valid slot)
DECODE_CASES = (
    ("gemma-2b decode", 4, 1088, 8, 1, 256, 1054, None, False),
    ("gemma-2b widths, B 1", 1, 1088, 8, 1, 256, 1054, None, False),
    ("G=1", 2, 512, 4, 4, 128, 400, None, False),
    ("G=2", 2, 512, 4, 2, 64, 300, None, False),
    ("mostly empty", 2, 1024, 8, 1, 256, 5, None, False),
    ("capacity 1000 does not tile", 1, 1000, 4, 2, 64, 999, None, False),
    ("rolling window", 2, 512, 4, 2, 64, 1500, 200, True),
    ("window, no wrap", 2, 768, 4, 1, 128, 400, 128, False),
    ("one block a group", 33, 256, 8, 4, 64, 200, None, False),
    ("no valid slot in row 0", 2, 1088, 8, 1, 256, (-1, 1054), None, False),
    # head dim 80 and query groups of 9 to 16 rows (the 16-row instance)
    ("qwen3-moe decode", 4, 1088, 32, 4, 128, 1054, None, False),
    ("mistral-large decode, G=12", 4, 1088, 96, 8, 128, 1054, None, False),
    ("stablelm-3b decode, hd 80", 4, 1088, 32, 32, 80, 1054, None, False),
    ("G=16", 2, 1088, 16, 1, 128, 1054, None, False),
    ("G=16 hd 80", 2, 512, 32, 2, 80, 300, None, False),
    ("G=12 hd 80 mostly empty", 2, 1024, 24, 2, 80, 5, None, False),
    ("G=12 mostly empty", 2, 1024, 24, 2, 128, 5, None, False),
    ("G=16 window, no wrap", 2, 768, 16, 1, 64, 400, 128, False),
    ("G=12 hd 80 rolling window", 2, 512, 12, 1, 80, 1500, 200, True),
    ("G=16 no valid slot in row 0", 2, 1088, 16, 1, 256, (-1, 1054), None,
     False),
    ("G=12 hd 80 no valid slot in row 1", 2, 1088, 12, 1, 80, (1054, -1),
     None, False),
)
# (block_kv, splits), each run with both combines
DECODE_CONFIGS = ((128, 8), (256, 4), (512, 2), (1024, 1), (512, 1), (128, 1))
GEMMA_DECODE = (4, 1088, 8, 1, 256)
# the serving run: batch, prompt, decode steps; logits held for PARITY_STEPS
SERVE_B, SERVE_PROMPT, SERVE_STEPS, PARITY_STEPS = 4, 1024, 64, 8
# eager against graph decode, in turns: this many pairs of SERVE_STEPS steps
TIMING_PAIRS = 4
# phase 10, the online loop: decode steps (a cache of 1,152, a decode cell
# phase 7 never tuned), steps before the daemon runs, steps after the swap
# back (held against the plain path), the daemon's budget and init
ONLINE_STEPS, ONLINE_FIRST, ONLINE_LAST = 128, 8, 8
DAEMON_BUDGET, DAEMON_INIT = 12, 4
ONLINE_SHAPE = "decode_32k"          # the sharding cell (the reference's)
# decode steps the profile window covers (phase 9)
PROFILE_STEPS = 4
# the phase-6/9 row of decode attention as one fused launch, and of the
# flash kernel's full-attention (causal=False) instance
FUSED_DECODE = "decode (one fused launch)"
FLASH_FULL = "flash_attention full (causal=False)"
# a cache 97% full: the middle of the 64 decode steps (1,024..1,087 of 1,088)
DECODE_FILL = 0.97
# about 1 config in 6 of the 4096³ space passes the resource model, and the
# paper's init repairs invalid draws until ``init`` are valid, so the budget
# leaves room for both the repairs and the BO iterations
GEMM_BUDGET = 40
# phase 11: the paper's comparison (Fig. 1's seven strategies, Fig. 5's two
# framework analogues, and BO on the padded GP) on the GTX Titan X GEMM
# space at the paper's budget; pool BO over a 1e9 generative space; the
# wide MoE sharding space
PAPER_GPU, PAPER_BUDGET = "gtx_titan_x", 220
PAPER_RUNS = ("advanced_multi", "multi", "ei", "genetic_algorithm", "mls",
              "simulated_annealing", "random", "bayesopt_ucb",
              "skopt_gphedge", "ei engine=jax")
GEN_BUDGET = 60
WIDE_ARCH = "qwen3-moe-30b-a3b"
# phase 12: the MoE model at full width and depth, its kernel cells tuned
# in phase 7 ((B, S, H, KV, hd) of its prefill and its decode), and the
# dense configs at full width, depth cut where one card cannot hold them
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_FLASH = (4, 1024, 32, 4, 128)
MOE_DECODE = (4, 1088, 32, 4, 128)
DENSE_RUNS = (("internlm2-1.8b", None), ("stablelm-3b", None),
              ("mistral-large-123b", 4), ("chameleon-34b", 8))
DENSE_STEPS = 8
# the dense parity rule's margin: the kernel path may sit at most this much
# of max|logits| farther from the fp32 model than the plain bf16 path does
# (worst step against worst step; PERF.md section 6 gives the readings)
FP32_MARGIN = 5e-3
# the dense config whose bf16 paths are also run with sqrt(d)-scaled
# embeddings, and with the head tied to them (gemma-2b's logits path)
CONTROL_ARCH = "internlm2-1.8b"
# phase 13: the last four families at full width: (arch, depth or None for
# all of it, prompt, graph steps, ParallelConfig fields). recurrentgemma's
# prompt passes its 2,048 window (the cache rolls) and flash_threshold (the
# blockwise attention runs); deepseek's five layers are its three dense
# ones and two MoE (three MoE layers would be 76 GB of bf16 weights);
# xlstm's mlstm_chunk is what its sharding cell sets. xlstm runs last: the
# profile of its prefill (about 170,000 device events at full depth) leaves
# the profiler losing records of the device timings after it. The other
# three are cut in depth, whole repeats of their layer patterns (20 of 38,
# 24 of 48, 24 of 48), for the script's time limit: at full depth a slower
# host ran the whole script in 1,209 s
LAST_RUNS = (("recurrentgemma-9b", 20, 3072, 64, {}),
             ("deepseek-v3-671b", 5, 1024, 8, {}),
             ("musicgen-large", 24, 1024, 64, {}),
             ("xlstm-1.3b", 24, 1024, 64, {"mlstm_chunk": 64}))
# the reference's dispatch: flash launches a prefill, decode launches a
# step (one a layer of attention at these depths)
LAST_LAUNCHES = {"recurrentgemma-9b": (0, 6), "deepseek-v3-671b": (0, 0),
                 "xlstm-1.3b": (0, 0), "musicgen-large": (24, 24)}
# phase 14, training: gemma-2b at full width and depth with the TrainLoop's
# parallel defaults (materialized attention, unchunked cross-entropy, remat
# "none"), batch x sequence, steps, the launcher's peak LR; the card-vs-CPU
# check at full width cut to 2 layers in fp32 at B 1 x S 256; the restart
# drill at the smoke size test_substrate.py runs it
TRAIN_ARCH, TRAIN_SHAPE, TRAIN_STEPS, TRAIN_PEAK_LR = "gemma-2b", (4, 1024), 8, 3e-4
TRAIN_PCFG = {"flash_threshold": 1 << 30, "logits_chunk": 0}
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SHAPE = 2, (1, 256)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, REMAT_RTOL = 1e-5, 1e-3, 1e-6
RESTART_ARCH = "internlm2-1.8b"
# phase 16, training on a one-rank device mesh: steps, held to phase 14's
# first ones
MESH_STEPS = 2
# phase 17, xlstm-1.3b's training off and on a one-rank mesh: the config's
# own mLSTM chunk and remat "full" (at S 1,024 launch/dryrun puts remat
# "none" at 168.7 GiB); S cut from phase 14's 1,024 to 256, as the six
# sLSTM blocks' step loops are host-bound (at S 1,024 a step took 21.4 s
# and the phase 313 s, PERF.md)
XLSTM_ARCH, XLSTM_SHAPE, XLSTM_MICROBATCHES = "xlstm-1.3b", (4, 256), (1, 2)
XLSTM_PCFG = {**TRAIN_PCFG, "mlstm_chunk": 64, "remat": "full"}
# phase 15, the dry-run: the peak's limit against max_memory_allocated, the
# processes the sweep traces in, BO's cell and budget (the reference's
# prefill_32k cell, then the one-card cell at phase 8's batch)
DRY_PEAK_RTOL, DRY_WORKERS = 0.10, 6
DRY_BO_ARCH, DRY_BO_SHAPES, DRY_BO_BUDGET = ("gemma-2b",
                                             ("prefill_32k", "prefill_32k_b4"),
                                             24)
# phase 18, the dry-run on the production meshes: BO's cell, where the
# mesh knobs decide (deepseek-v3's 256 experts divide over model x data of
# the single mesh, qwen3-moe's 128 do not; without ZeRO-3 its weights do
# not fit a card), and budget
MESH_BO_ARCH, MESH_BO_SHAPE, MESH_BO_BUDGET = ("deepseek-v3-671b",
                                               "decode_32k", 3)
# phase 19, gemma-2b served on a one-rank mesh: decode steps after the
# prefill
MESH_SERVE_STEPS = 4
# phase 18(e), the reference's sequence rules on the single mesh: gemma-2b's
# decode cell with its cache split along its slots (its one KV head leaves
# act_kv_heads nothing to split), and its train cell, which does not fit a
# card under the default rules, with its activations split along the
# sequence
SEQ_RULE_CELLS = (("gemma-2b", "decode_32k", {"act_cache_seq": "model"}),
                  ("gemma-2b", "train_4k", {"act_seq": "model"}))
# phase 20, the rest of the paper's evaluation: seeds a run (the reference
# runs 5 to 7; budgets, caps and spaces are the reference's), Table I's
# kernel, and the kernel whose warm start takes the GP to T 512 (ExpDist's
# runs observe few valid configurations: its warm GP ends near 80
# observations; GEMM's holds 256 priors and 220 evaluations)
EVAL_SEEDS, EVAL_TABLE1_KERNEL, EVAL_T512_KERNEL = 1, "pnpoly", "gemm"
# graph replays held against the eager step bit for bit; xLSTM's two mLSTM
# scans compared at this many blocks
GRAPH_STEPS, SCAN_BLOCKS = 4, 8


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` single-launch CUDA-event timings of ``fn``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def gp_state(t: int, N: int, d: int, nu: str, seed: int = 5,
             distinct: bool = False):
    """A real IncrementalGP state: t observations drawn from an N-candidate
    panel of dimension d (distinct candidates when ``distinct``, with
    repeats otherwise), and the panel (fp32)."""
    import numpy as np
    from repro_torch.core.gp_fast import IncrementalGP
    rng = np.random.default_rng(seed)
    Xc = rng.random((N, d)).astype(np.float32)
    g = IncrementalGP(Xc, max_obs=t, kernel=nu, ell=2.0)
    pick = rng.permutation(N)[:t] if distinct else None
    for s in range(t):
        i = pick[s] if distinct else rng.integers(N)
        g.add(Xc[i], float(rng.normal(10, 3)))
    return g, Xc


def gp_problem(t: int, N: int, d: int, nu: str, T=None,
               distinct: bool = False):
    """Padded kernel inputs (numpy) of ``gp_state``'s GP."""
    from repro_torch.kernels import ops
    g, Xc = gp_state(t, N, d, nu, distinct=distinct)
    return (Xc,) + ops.gp_inputs_from_incremental(g, pad_T=T)[:4]


# -- phase 2 -------------------------------------------------------------------


def check_gemm(dev) -> dict:
    """Every GEMM block the resource model passes against the plain
    version, in fp32 (rtol 1e-4, atol 1e-3) and bf16 (3e-2); at 4096³ fp32
    both against an fp64 product on the card too: the kernel's max|err|
    may be at most 4x the plain version's (3xTF32 keeps fp32 accuracy)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build, gemm as kg, ops, ref
    worst = {}
    for (M, N, K) in GEMM_SHAPES:
        rng = np.random.default_rng(0)
        a64 = torch.from_numpy(rng.normal(size=(M, K)))
        b64 = torch.from_numpy(rng.normal(size=(K, N)))
        for dtype, tol in ((torch.float32, (1e-4, 1e-3)),
                           (torch.bfloat16, (3e-2, 3e-2))):
            a, b = a64.to(dev, dtype), b64.to(dev, dtype)
            want = ref.gemm(a, b).float()
            exact = plain_err = None
            if (M, N, K) == MAIN_GEMM and dtype == torch.float32:
                # fp64 product of the fp32 inputs, used only to check
                exact = torch.matmul(a.double(), b.double())
                plain_err = float((want.double() - exact).abs().max())
            dtype_bytes = a.element_size()
            for bm, bn, bk in GEMM_BLOCKS:
                cfg = {"block_m": bm, "block_n": bn, "block_k": bk}
                if M % bm or N % bn or K % bk:
                    continue
                if not ops.gemm_valid(cfg, dtype_bytes):
                    # the model's static invalid: the card refuses it too
                    try:
                        kg.gemm(a, b, block_m=bm, block_n=bn, block_k=bk)
                    except _build.LaunchRefused as e:
                        log(f"  gemm {M}x{N}x{K} {str(dtype)[6:]:8s} blocks "
                            f"({bm},{bn},{bk}): refused as the model says "
                            f"({_build.error_string(e.code)})")
                        continue
                    fail(f"gemm {M}x{N}x{K} {dtype} ({bm},{bn},{bk}) ran, "
                         "but the resource model calls it invalid")
                got = kg.gemm(a, b, block_m=bm, block_n=bn,
                              block_k=bk).float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                rtol, atol = tol
                bad = int((err > atol + rtol * want.abs()).sum())
                mx = float(err.max())
                stages = kg.gemm_stages(bm, bn, bk, dtype_bytes)
                log(f"  gemm {M}x{N}x{K} {str(dtype)[6:]:8s} blocks "
                    f"({bm},{bn},{bk}), {stages} stages: max|err| {mx:.3e} "
                    f"(rtol {rtol}, atol {atol}) -> "
                    f"{'ok' if bad == 0 else f'{bad} BAD'}")
                if bad:
                    fail(f"gemm {M}x{N}x{K} {dtype} ({bm},{bn},{bk}) "
                         f"disagrees with its plain version in {bad} entries")
                if exact is not None:
                    k_err = float((got.double() - exact).abs().max())
                    log(f"    against fp64: kernel max|err| {k_err:.3e}, "
                        f"plain {plain_err:.3e} ({k_err / plain_err:.2f}x; "
                        "limit 4x)")
                    if k_err > 4 * plain_err:
                        fail(f"gemm {M}x{N}x{K} fp32 ({bm},{bn},{bk}) is "
                             f"{k_err / plain_err:.2f}x the plain version's "
                             "error against fp64, over 4x")
                    worst["gemm"] = max(worst.get("gemm", 0.0), mx)
            del exact
    return worst


def check_gp(dev) -> dict:
    """Every GP shape against its plain version: var within 1e-4 +
    3e-3|var|, mean within 3% of its range. Both means against the plain
    version run in float64 on the same inputs too (printed; the kernel's
    must be within 3% of the range there as well): where observations
    repeat, L^-1 grows large and the fp32 versions lose digits, and this
    shows which lost more."""
    import torch
    from repro_torch.kernels import matern_gp as kgp, ref
    worst = {}
    for (t, N, d) in GP_SHAPES:
        T = MAIN_T if (t, N, d) == MAIN_GP else None
        for nu in ("matern12", "matern32", "matern52", "rbf"):
            Xc, x_obs, vinv, w, mask = gp_problem(
                t, N, d, nu, T, distinct=(t, N, d) == GP_T1024)
            args = [torch.from_numpy(x).to(dev)
                    for x in (Xc, x_obs, vinv, w, mask)]
            mean_k, var_k = kgp.gp_posterior(*args, ell=2.0, nu=nu,
                                              block_n=256)
            mean_r, var_r = ref.gp_posterior(*args[:4], 2.0, nu,
                                             mask=args[4])
            # used only to check
            mean_x, _ = ref.gp_posterior(*(a.double() for a in args[:4]),
                                         2.0, nu, mask=args[4].double())
            torch.cuda.synchronize()
            # variance is well conditioned: tight; the mean is amplified by
            # ||L^-1||*||w||, so it is bounded by a share of its range
            var_bad = int(((var_k - var_r).abs()
                           > 1e-4 + 3e-3 * var_r.abs()).sum())
            m_err = float((mean_k - mean_r).abs().max())
            m_rng = float(mean_r.max() - mean_r.min()) + 1e-9
            v_err = float((var_k - var_r).abs().max())
            ok = var_bad == 0 and m_err < 0.03 * m_rng
            log(f"  gp t={t} N={N} d={d} T={x_obs.shape[0]} {nu}: "
                f"max|dvar| {v_err:.3e}, max|dmean| {m_err:.3e} "
                f"({m_err / m_rng:.2e} of range) -> {'ok' if ok else 'BAD'}")
            x_rng = float(mean_x.max() - mean_x.min()) + 1e-9
            k_x = float((mean_k.double() - mean_x).abs().max()) / x_rng
            p_x = float((mean_r.double() - mean_x).abs().max()) / x_rng
            log(f"    mean against float64: kernel {k_x:.2e}, plain "
                f"{p_x:.2e} of range")
            if not ok:
                i = int(torch.argmax((var_k - var_r).abs()))
                log(f"    worst var at {i}: kernel {float(var_k[i]):.6e}, "
                    f"plain {float(var_r[i]):.6e}")
                fail(f"gp_posterior t={t} N={N} d={d} {nu} disagrees with "
                     "its plain version")
            if k_x >= 0.03:
                fail(f"gp_posterior t={t} N={N} d={d} {nu}: mean "
                     f"{k_x:.2e} of its range from the float64 answer")
            if (t, N, d) == MAIN_GP:
                worst["matern_gp"] = max(worst.get("matern_gp", 0.0), m_err,
                                         v_err)
    return worst


def _agree(got, want, dtype, what: str) -> float:
    """Max |err| of ``got`` against the plain ``want`` (both fp32 views),
    failing past the stated tolerance: fp32 at the reference's 2e-4 (rtol
    and atol; the kernels sum in another order than the plain versions).
    bf16 at 2^-7 x max|ref|, the least bound that holds one bf16 ulp of
    every output (an output x has an ulp of at most 2^-7 |x|): each version
    rounds its output to bf16 once, from fp32 sums taken in another order,
    so an output next to a rounding boundary lands one ulp apart. The
    reference's 5e-3 x max|ref| (test_kernels.py:386-387) is below one ulp
    of max|ref| when max|ref| lies in [2^e, 1.5625 x 2^e); a kernel off by
    more than one ulp of the largest output fails."""
    import torch
    err = (got - want).abs()
    mx = float(err.max())
    if dtype == torch.float32:
        bad = int((err > 2e-4 + 2e-4 * want.abs()).sum())
        tol = "2e-4 + 2e-4|ref|"
    else:
        lim = 2.0 ** -7 * float(want.abs().max())
        bad = int((err > lim).sum())
        tol = f"2^-7 max|ref| = {lim:.2e}"
    log(f"  {what}: max|err| {mx:.3e} ({tol}) -> "
        f"{'ok' if bad == 0 else f'{bad} BAD'}")
    if bad:
        fail(f"{what} disagrees with its plain version in {bad} entries")
    return mx


def _agree_full_bf16(got, want, q, k, v, what: str) -> float:
    """Full attention in bf16. The plain version rounds the scores q.k to
    bf16 before the softmax, as the reference's ``ref.attention`` does; the
    kernel keeps them in fp32, as the Pallas kernel does. Every row of a
    full attention averages all S keys, so max|ref| is small and that
    rounding (a score of |q.k| ~ 45 is off by up to 1/8 before the 1/16
    scale) exceeds one output ulp. So the kernel is held to the plain
    version at the reference's bf16 tolerance (3e-2 + 3e-2|ref|,
    tests/test_kernels.py:55), and to the plain version computed in fp32 on
    the same bf16 inputs, rounded to bf16, at 2^-7 x max|ref|, as causal
    bf16 is held."""
    import torch
    from repro_torch.kernels import ref
    bad = int(((got - want).abs() > 3e-2 + 3e-2 * want.abs()).sum())
    log(f"  {what}: against the bf16 plain version max|err| "
        f"{float((got - want).abs().max()):.3e} (3e-2 + 3e-2|ref|) -> "
        f"{'ok' if bad == 0 else f'{bad} BAD'}")
    if bad:
        fail(f"{what} disagrees with its plain version in {bad} entries")
    want32 = ref.attention(q.float(), k.float(), v.float(), causal=False)
    return _agree(got, want32.to(torch.bfloat16).float(), torch.bfloat16,
                  f"{what}, against the plain version in fp32")


def check_flash(dev) -> dict:
    """Every shape and block the resource model passes, causal and full
    (``causal=False``), fp32 and bf16, against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as kfa, ops, ref
    worst = {}
    for (B, S, H, KV, hd) in FLASH_SHAPES:
        rng = np.random.default_rng(0)
        q64 = torch.from_numpy(rng.normal(size=(B, S, H, hd)))
        k64, v64 = (torch.from_numpy(rng.normal(size=(B, S, KV, hd)))
                    for _ in range(2))
        for dtype, causal in ((torch.float32, True), (torch.bfloat16, True),
                              (torch.float32, False),
                              (torch.bfloat16, False)):
            q, k, v = (t.to(dev, dtype) for t in (q64, k64, v64))
            want = ref.attention(q, k, v, causal=causal).float()
            for bq, bkv in FLASH_BLOCKS:
                cfg = {"block_q": bq, "block_kv": bkv}
                if S % bq or S % bkv or not ops.flash_valid(cfg, hd, dtype):
                    continue
                got = kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv,
                                          causal=causal).float()
                torch.cuda.synchronize()
                label = (f"flash B{B} S{S} H{H} KV{KV} hd{hd} "
                         f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
                         f" blocks ({bq},{bkv})")
                if causal or dtype == torch.float32:
                    err = _agree(got, want, dtype, label)
                else:
                    err = _agree_full_bf16(got, want, q, k, v, label)
                if (B, S, H, KV, hd) == GEMMA_FLASH and dtype == torch.bfloat16:
                    key = "flash_attention" if causal else "flash_full"
                    worst[key] = max(worst.get(key, 0.0), err)
    return worst


def _cache_positions(S: int, cur: int, rolling: bool):
    """Slot positions of a live cache: contiguous fill to ``cur``, or a
    rolling window's wrapped layout (tests/test_kernels.py's cases)."""
    import numpy as np
    if rolling:
        pos = cur - ((cur - np.arange(S)) % S)
        return np.where(pos >= 0, pos, -1)
    return np.where(np.arange(S) <= cur, np.arange(S), -1)


def _agree_partials(got, want, what: str) -> None:
    """The split kernel's per-split partials against the plain version's:
    the same splits with no valid slot (m = -inf) and, there, exactly
    l = 0 and o = 0 (splits of padding only among them); m within 1e-4
    and l within 1e-3 relative elsewhere (fp32 sums in another order; the
    kernel folds its chunks with the combine's weights)."""
    import torch
    (ko, km, kl), (o_r, m_r, l_r) = got, want
    empty = torch.isinf(m_r)
    n_empty = int(empty.sum())
    ok = (torch.equal(torch.isinf(km), empty)
          and bool((km[empty] == -math.inf).all())
          and bool((kl[empty] == 0).all()) and bool((ko[empty] == 0).all()))
    full = ~empty
    m_err = l_rel = top = 0.0
    if n_empty < m_r.numel():
        m_err = float((km[full] - m_r[full]).abs().max())
        l_rel = float(((kl[full] - l_r[full]).abs() / l_r[full]).max())
        top = float(m_r[full].abs().max())
    ok = ok and m_err <= 1e-4 * (1 + top) and l_rel <= 1e-3
    splits_empty = int(empty.all(dim=-1).sum())
    log(f"    partials: {splits_empty} empty (split, head) of "
        f"{m_r.shape[0] * m_r.shape[1] * m_r.shape[2]} exactly -inf/0/0; "
        f"max|dm| {m_err:.2e}, max rel dl {l_rel:.2e} -> "
        f"{'ok' if ok else 'BAD'}")
    if not ok:
        fail(f"{what}: split partials disagree with the plain version's")


def check_decode(dev) -> dict:
    """Every case and config with the combine fused in (one launch) and
    with the partials mode + the tensor-op combine, against the plain
    split + combine; rows with no valid slot exactly 0. max_abs_err at the
    serving shape in bf16: the split's from the partials path, the
    combine's from the fused launch."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_decode as kfd, ops, ref
    worst = {"flash_decode_split": 0.0, "flash_decode_combine": 0.0}
    for name, B, S, H, KV, hd, cur, window, rolling in DECODE_CASES:
        curs = cur if isinstance(cur, tuple) else (cur,) * B
        empty = [b for b, c in enumerate(curs) if c < 0]
        rng = np.random.default_rng(1)
        q64 = torch.from_numpy(rng.normal(size=(B, 1, H, hd)))
        k64, v64 = (torch.from_numpy(rng.normal(size=(B, S, KV, hd)))
                    for _ in range(2))
        pos = np.stack([_cache_positions(S, c, rolling) for c in curs])
        cp = torch.from_numpy(pos).to(dev)
        cu = torch.tensor(curs, dtype=torch.long, device=dev)
        serving = (B, S, H, KV, hd) == GEMMA_DECODE and curs == (1054,) * B
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dev, dtype) for t in (q64, k64, v64))
            for bkv, ns in DECODE_CONFIGS:
                if (bkv * (ns - 1) >= S
                        or not ops.decode_valid({"block_kv": bkv}, H // KV,
                                                hd)):
                    continue
                bias = ops.decode_bias(cp, cu, window, ns * bkv)
                o_r, m_r, l_r = ref.decode_split(q[:, 0], k, v, bias, ns)
                want = ref.combine_partials(o_r, m_r, l_r).reshape(
                    B, 1, H, hd).to(dtype).float()
                label = (f"decode {name} B{B} S{S} H{H} KV{KV} hd{hd} "
                         f"{str(dtype)[6:]} ({bkv},{ns})")
                err = {}
                for comb in ("kernel", "torch"):
                    kfd.split_launches = kfd.combine_launches = 0
                    got = ops.decode_attention(q, k, v, cp, cu, window=window,
                                               block_kv=bkv, num_splits=ns,
                                               combine=comb).float()
                    torch.cuda.synchronize()
                    n = (kfd.split_launches, kfd.combine_launches)
                    if n != (1, int(comb == "kernel")):
                        fail(f"{label} combine={comb}: launches (split, "
                             f"fused combine) {n}")
                    err[comb] = _agree(got, want, dtype, f"{label} {comb}")
                    if empty and not bool((got[empty] == 0).all()):
                        fail(f"{label} combine={comb}: rows {empty} have no "
                             "valid slot and are not exactly 0")
                _agree_partials(kfd.decode_split(q[:, 0], k, v, bias,
                                                 block_kv=bkv, num_splits=ns),
                                (o_r, m_r, l_r), label)
                if serving and dtype == torch.bfloat16:
                    worst["flash_decode_split"] = max(
                        worst["flash_decode_split"], err["torch"])
                    worst["flash_decode_combine"] = max(
                        worst["flash_decode_combine"], err["kernel"])
    return worst


# -- phases 3-6 ------------------------------------------------------------------


def gp_bounds(N: int, T: int, d: int, card: str):
    """Bounds of the GP kernel's work, N*(3*T*d + T^2) flop over the bytes
    read and written once: all on the CUDA cores, and on the path the
    kernel takes (the triangular product as 3xTF32 on the tensor cores,
    plus the distances on the CUDA cores). Each (ms, bound_by)."""
    from repro_torch.launch.roofline import bound_ms
    nbytes = 4.0 * (N * d + T * d + T * T + 2 * T + 2 * N)
    cores = bound_ms(N * (3.0 * T * d + T * T), nbytes, card)
    ops_ms = (bound_ms(float(N) * T * T, 0, card, "tf32x3")[0]
              + bound_ms(3.0 * N * T * d, 0, card)[0])
    bytes_ms = bound_ms(0, nbytes, card)[0]
    return cores, (max(ops_ms, bytes_ms),
                   "operations" if ops_ms >= bytes_ms else "bytes")


def evals_to_best(result) -> int:
    """Unique evaluations until the run's best value was first reached."""
    return int(next(i for i, v in enumerate(result.trace)
                    if v == result.best_value)) + 1


def invalid_split(result, cell):
    """(static, runtime) invalid counts of a kernel-tuning run's journal; a
    config outside the space counts as static."""
    static = runtime = 0
    for o in result.journal:
        if not math.isfinite(o.value):
            if o.idx is not None and cell.valid(cell.space.config(o.idx)):
                runtime += 1
            else:
                static += 1
    return static, runtime


def tune_serve_kernels(sdir: str, gp_block_n: int) -> None:
    """Phase 7: BO tunes the decode cell, then the flash cell, at gemma-2b's
    serving shapes and at qwen3-moe's in bf16, the surrogate on the GP
    kernel."""
    import torch
    from repro_torch.kernels import tuning
    cells = []
    for dec, fl in ((GEMMA_DECODE, GEMMA_FLASH), (MOE_DECODE, MOE_FLASH)):
        B, S, H, KV, hd = dec
        fB, fS, fH, fKV, fhd = fl
        cells += [
            (tuning.decode_cell(B, S, H, KV, hd, fill=DECODE_FILL,
                                dtype=torch.bfloat16), 12, 4, 5),
            (tuning.flash_cell(fB, fS, fH, fhd, KV=fKV,
                               dtype=torch.bfloat16), 8, 3, 3)]
    for cell, budget, init, reps in cells:
        t0 = time.perf_counter()
        res = tuning.run_kernel_tuning(cell, sdir, budget=budget, init=init,
                                       reps=reps, gp_backend="cuda",
                                       gp_block_n=gp_block_n)
        n_static, n_runtime = invalid_split(res, cell)
        if not math.isfinite(res.best_value):
            fail(f"{cell.objective_id()}: no valid config in {budget}")
        log(f"[7] {cell.objective_id()}: best "
            f"{cell.space.config(res.best_idx)} {res.best_value * 1e3:.4f} "
            f"ms after {evals_to_best(res)} of {res.unique_evals} evals; "
            f"invalid {n_static} static, {n_runtime} runtime "
            f"({time.perf_counter() - t0:.1f} s)")


def profile_window(fn, what: str, top: int = 8, tag: str = "[9]"):
    """Run ``fn`` under torch.profiler and print the device's busy share of
    the window (kernel time over wall time) and the kernels that took the
    most device time. Prints "not measured" when the profiler sees no
    device time. Returns the (ms, count, name) rows, or None without
    them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except RuntimeError as e:             # no CUPTI on this host
        log(f"{tag} profile of {what}: profiler unavailable ({e}); device "
            "busy share not measured")
        fn()
        return None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        prof.__exit__(None, None, None)
    rows = [(a.self_device_time_total / 1e3, a.count, a.key)
            for a in prof.key_averages()
            if a.device_type != DeviceType.CPU and a.self_device_time_total > 0]
    graphs = sum(a.count for a in prof.key_averages()
                 if a.device_type == DeviceType.CPU
                 and "GraphLaunch" in a.key)
    if graphs:
        log(f"{tag} profile of {what}: {graphs} CUDA graph launches on the "
            "host; the device events below include the graphs' kernels")
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log(f"{tag} profile of {what}: wall {wall_ms:.3f} ms; the profiler saw "
            "no device time (device busy share not measured)")
        return None
    rows.sort(reverse=True)
    log(f"{tag} profile of {what} (torch.profiler on): wall {wall_ms:.3f} ms, "
        f"device kernel time {busy:.3f} ms, busy {100 * busy / wall_ms:.1f}%"
        f", idle {100 * (1 - busy / wall_ms):.1f}%; "
        f"{sum(r[1] for r in rows)} device events")
    for ms, n, name in rows[:top]:
        log(f"{tag}   {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<5d} {name[:90]}")
    return rows


def serve_gemma(sdir: str, dev) -> dict:
    """Phase 8: DecodeServer serves gemma-2b at full width with blocks from
    the store; parity against the plain attention path on the card."""
    import statistics as st
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.params import leaves
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import ParallelConfig
    cfg = get_arch("gemma-2b")
    cap = SERVE_PROMPT + SERVE_STEPS
    kc = serve.serving_kernel_config(cfg, device=dev, prompt_len=SERVE_PROMPT,
                                     cache_cap=cap, store=sdir, batch=SERVE_B,
                                     log=log)
    if not (kc.use_flash and kc.use_decode):
        fail(f"serving config {kc} leaves a kernel off")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    server = serve.DecodeServer(
        cfg, ParallelConfig(kernel=kc),
        batch=SERVE_B, prompt_len=SERVE_PROMPT, decode_steps=SERVE_STEPS,
        seed=0, device=dev, keep_logits=PARITY_STEPS)
    torch.cuda.synchronize(dev)
    n_params = sum(t.numel() for _, t in leaves(server.params))
    init_s = time.perf_counter() - t0
    batch = server.input_batch()
    serve.reset_kernel_launches()
    # the first prefill also pays one-time costs (cuBLAS workspaces and
    # heuristics for new shapes); the second, on a fresh cache, is the
    # steady one and leaves the cache the decode steps run on
    cold_s = server.prefill_batch(batch)
    prefill_s = server.prefill_batch(batch)
    steps = [server.decode_step() for _ in range(SERVE_STEPS)]
    launches = serve.kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    med = st.median(steps)
    log(f"[8] {cfg.name}: {n_params:,} parameters (bf16) initialised in "
        f"{init_s:.3f} s; blocks {kc}")
    log(f"[8] prefill {SERVE_B} x {SERVE_PROMPT}: {prefill_s * 1e3:.3f} ms "
        f"(first call {cold_s * 1e3:.3f} ms; {server.prefill_dispatch}); "
        f"decode {SERVE_STEPS} steps: median "
        f"{med * 1e3:.4f} ms/step (min {min(steps) * 1e3:.4f}, max "
        f"{max(steps) * 1e3:.4f}), {SERVE_B / med:.1f} tokens/s "
        f"({server.decode_dispatch}); peak memory "
        f"{peak / 2 ** 30:.3f} GiB; launches {launches}")
    # one decode launch a layer and step, carrying the combine where the
    # config says "kernel"; none else (phase 9 reads the device trace). The
    # steps replay the captured graph, which counts the launches it holds;
    # each capture ran one warm-up step first
    fused = kc.decode_combine == "kernel"
    n_dec = cfg.num_layers * (SERVE_STEPS + server.captures)
    want = {"flash_attention": 2 * cfg.num_layers,
            "flash_decode_split": n_dec,
            "flash_decode_combine": n_dec * fused}
    log(f"[8] decode graphs: {server.captures} captured in "
        f"{[round(t, 4) for t in server.capture_s]} s (warm-up step "
        f"included); cache {server.kernel_cache.stats()}; {SERVE_STEPS} "
        f"steps replayed, {cfg.num_layers} decode launches each")
    if server.captures != 1:
        fail(f"{server.captures} decode graphs captured for one config")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times in two prefills "
                 f"and {SERVE_STEPS} decode steps, want {n}")
    toks = torch.stack(server.out, 1)
    if toks.shape != (SERVE_B, SERVE_STEPS + 1) or not all(
            bool(torch.isfinite(x).all()) for x in server.kept):
        fail("served tokens or logits malformed")

    # the plain attention path on the same weights and tokens
    plain_pcfg = ParallelConfig(kernel=None)
    prefill = make_prefill_step(cfg, plain_pcfg, cache_cap=cap)
    decode = make_decode_step(cfg, plain_pcfg)
    logits, cache = prefill(server.params, batch)
    plain = [logits.float().cpu()]
    for i in range(PARITY_STEPS):
        logits, cache = decode(server.params, cache,
                               {"tokens": server.out[i][:, None]},
                               SERVE_PROMPT + i)
        plain.append(logits.float().cpu())
    del cache

    def parity(kept, what):
        worst = 0.0
        for i, (a, b) in enumerate(zip(kept, plain)):
            err, top = float((a - b).abs().max()), float(b.abs().max())
            worst = max(worst, err / top)
            if err > 2e-2 * top:
                fail(f"{what} logits step {i}: max|err| {err:.4e} over "
                     f"2e-2 x max|logits| = {2e-2 * top:.4e}")
        log(f"[8] {what} vs plain attention path, prefill + {PARITY_STEPS} "
            f"teacher-forced decode steps: max|err| / max|logits| = "
            f"{worst:.3e} (limit 2e-2); greedy tokens equal at "
            f"{sum(int(torch.equal(a.argmax(-1), b.argmax(-1))) for a, b in zip(kept, plain))}"
            f" of {len(plain)} steps")
        return worst

    rel = parity(server.kept, "served")
    graph_vs_eager(server, batch, dev)
    timing = eager_vs_graph_ms(server, batch, dev)
    combine = launches["flash_decode_combine"]
    if not fused:
        # the fused combine on the same path: an extra decode run at the
        # serving shape, teacher-forced on the served tokens
        extra = serve.DecodeServer(
            cfg, ParallelConfig(kernel=kc.replace(decode_combine="kernel")),
            batch=SERVE_B, prompt_len=SERVE_PROMPT, decode_steps=SERVE_STEPS,
            device=dev, params=server.params, keep_logits=PARITY_STEPS)
        serve.reset_kernel_launches()
        extra.prefill_batch(batch)
        for i in range(PARITY_STEPS):
            extra.toks = server.out[i]
            extra.decode_step()
        n = serve.kernel_launches()
        combine = n["flash_decode_combine"]
        log(f"[8] extra run with decode_combine='kernel': {combine} fused "
            f"launches of {n['flash_decode_split']} decode launches")
        if n["flash_decode_split"] != combine:
            fail(f"extra run: decode launches {n}, want each fused")
        rel = max(rel, parity(extra.kept, "fused-combine run"))
    if combine < cfg.num_layers:
        fail(f"fused combine launched {combine} times")
    launches["flash_decode_combine"] = combine
    return {"kc": kc, "launches": launches, "prefill_ms": prefill_s * 1e3,
            "prefill_cold_ms": cold_s * 1e3,
            "step_ms": med * 1e3, "tokens_s": SERVE_B / med, "peak": peak,
            "parity": rel, "server": server, "batch": batch,
            "timing": timing}


def eager_step(server, pos, dev) -> float:
    """One decode step of ``server`` through its eager step function (no
    graph), as ``DecodeServer.decode_step`` does on the CPU; seconds."""
    import torch
    t0 = time.perf_counter()
    with torch.inference_mode():
        pos.fill_(server.pos)
        logits, _ = server.decode(server.params, server.cache,
                                  {"tokens": server.toks[:, None]}, pos)
        server.toks = torch.argmax(logits, -1)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    server.out.append(server.toks)
    server.pos += 1
    return dt


def graph_vs_eager(server, batch, dev) -> None:
    """The graph step's logits against the eager step function's on the
    same state, over PARITY_STEPS steps of a new sequence: before each
    replay the eager step runs on the held state (it writes the cache slot
    the replay then rewrites with the same values). Prints whether they are
    equal bit for bit; fails past the serve limit, 2e-2 x max|logits|."""
    import torch
    server.prefill_batch(batch)
    saved = server.keep_logits
    server.keep_logits = PARITY_STEPS
    same, worst = 0, 0.0
    for _ in range(PARITY_STEPS):
        with torch.inference_mode():
            eager, _ = server.decode(server.params, server.cache,
                                     {"tokens": server.toks[:, None]},
                                     server.pos)
            eager = eager.float().cpu()
        server.decode_step()
        got = server.kept[-1]
        same += int(torch.equal(got, eager))
        top = float(eager.abs().max())
        worst = max(worst, float((got - eager).abs().max()) / top)
    server.keep_logits = saved
    log(f"[8] graph replay vs eager step on the same state, {PARITY_STEPS} "
        f"steps: bit for bit equal at {same} of {PARITY_STEPS}; max|err| / "
        f"max|logits| = {worst:.3e} (limit 2e-2)")
    if worst > 2e-2:
        fail(f"graph step logits {worst:.3e} x max|logits| from the eager "
             "step's")


def eager_vs_graph_ms(server, batch, dev) -> dict:
    """Median ms/step of SERVE_STEPS decode steps, eager step function
    against graph replay, in TIMING_PAIRS pairs in turns (E G, G E, ...),
    each run on a fresh prefill of the same prompt, no logits kept."""
    import torch
    pos = torch.zeros((), dtype=torch.long, device=dev)
    saved = server.keep_logits
    server.keep_logits = 0
    runs = {"eager": [], "graph": []}
    for i in range(TIMING_PAIRS):
        for mode in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            server.prefill_batch(batch)
            step = ((lambda: eager_step(server, pos, dev)) if mode == "eager"
                    else server.decode_step)
            runs[mode].append(1e3 * statistics.median(
                [step() for _ in range(SERVE_STEPS)]))
    server.keep_logits = saved
    log(f"[8] decode ms/step (median of {SERVE_STEPS}), eager step against "
        f"graph replay in turns (E G G E ...), {smi_line()}: eager "
        f"{[round(x, 4) for x in runs['eager']]}, graph "
        f"{[round(x, 4) for x in runs['graph']]}")
    return runs


def online_gemma(sdir: str, dev, params, gp_block_n: int) -> dict:
    """Phase 10: the online loop on a copy of the phase-7 store, wired as
    ``serve.main --online --kernels`` wires it: a stale decode cell, one
    durable job, the retune daemon's BO on the card, the hot-swap (or the
    source's reason to keep its config), a forced swap back that must be a
    graph-cache hit, prod records, and parity against the plain path."""
    import shutil
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import matern_gp as kgp
    from repro_torch.launch import serve
    from repro_torch.launch.retune import RetuneDaemon
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.store import HotConfigSource, TuningRecordStore
    cfg = get_arch("gemma-2b")
    cap = SERVE_PROMPT + ONLINE_STEPS
    odir = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_online_"), "st")
    shutil.copytree(sdir, odir)
    source = HotConfigSource(odir, cfg.name, ONLINE_SHAPE)
    if source.refresh() is not None:
        fail("the sharding cell has a record in a store of kernel cells")
    kc = serve.serving_kernel_config(cfg, device=dev, prompt_len=SERVE_PROMPT,
                                     cache_cap=cap, store=odir, batch=SERVE_B,
                                     log=log)
    ksrc = serve.kernel_sources(odir, cfg, batch=SERVE_B,
                                prompt_len=SERVE_PROMPT, cache_cap=cap,
                                device=dev, log=log)
    fsrc, dsrc = ksrc
    log(f"[10] sources: {fsrc.objective_id} stale={fsrc.stale}; "
        f"{dsrc.objective_id} stale={dsrc.stale}")
    if fsrc.stale or not dsrc.stale:
        fail("want the flash cell tuned (phase 7) and the decode cell at "
             f"capacity {cap} stale")
    first = {"block_kv": kc.decode_block_kv,
             "num_splits": kc.decode_num_splits,
             "combine": kc.decode_combine}
    server = serve.DecodeServer(
        cfg, ParallelConfig(kernel=kc), batch=SERVE_B,
        prompt_len=SERVE_PROMPT, decode_steps=ONLINE_STEPS, device=dev,
        params=params)
    batch = server.input_batch()
    prefill_s = server.prefill_batch(batch)
    loop, recorder, queue = serve.make_online_loop(
        server, odir, arch=cfg.name, tuned_shape=ONLINE_SHAPE, source=source,
        kernel_sources=ksrc, prefill_s=prefill_s)
    serve.reset_kernel_launches()
    t0 = time.perf_counter()
    stats = [loop.run(ONLINE_FIRST)]
    tickets = queue.open_tickets()
    log(f"[10] {ONLINE_FIRST} steps served on blocks {first} (resolved "
        f"from the capacity-1,088 record); open jobs: "
        f"{[(tk.key, tk.reason) for tk in tickets]}")
    if [(tk.key, tk.reason) for tk in tickets] != [(dsrc.objective_id,
                                                     "stale")]:
        fail("want exactly one open stale job, for the decode cell")

    # the daemon, in process, on the card: claims the job, BO retunes the
    # cell (its surrogate on the GP kernel), journals under its fence token
    daemon = RetuneDaemon(
        odir, budget=DAEMON_BUDGET, worker="chip-smoke-daemon", device=dev,
        verbose=True, strategy_factory=lambda: make_strategy(
            "ei", initial_samples=DAEMON_INIT, gp_backend="cuda",
            gp_device=str(dev), gp_block_n=gp_block_n))
    before, gp0, d0 = serve.kernel_launches(), kgp.launches, time.perf_counter()
    res = daemon.step()
    daemon_s = time.perf_counter() - d0
    mid = serve.kernel_launches()
    daemon_launches = {k: mid[k] - before[k] for k in mid}
    if res is None or daemon.serviced != 1:
        fail("the daemon serviced no job")
    view = TuningRecordStore(odir)
    fp = next(d for d, desc in view.fingerprints().items()
              if desc.objective == dsrc.objective_id)
    recs = view.records(fp=fp)
    tokens = {int((r.meta or {}).get("fence", {}).get("token", -1))
              for r in recs}
    jobs = [d for seg in sorted(os.listdir(odir)) if seg.endswith(".jsonl")
            for d in (json.loads(x) for x in open(os.path.join(odir, seg))
                      if x.strip()) if d.get("kind") == "job"]
    states = [d["state"] for d in jobs if d["key"] == dsrc.objective_id]
    log(f"[10] daemon: {res.unique_evals} evaluations in {daemon_s:.1f} s, "
        f"best {res.best_value * 1e3:.4f} ms; "
        f"{len(recs)} records journaled under fence tokens {tokens}; job "
        f"records {states}; launches in its BO run: GP kernel "
        f"{kgp.launches - gp0}, {daemon_launches}")
    # the loop re-submits at each poll while the cell is stale: duplicate
    # submits coalesce into the one job, and its done closes each of them
    if (states.count("claim") != 1 or states.count("done")
            != states.count("submit") or len(tokens) != 1 or -1 in tokens
            or queue.open_tickets() or {d["key"] for d in jobs}
            != {dsrc.objective_id}):
        fail("want one job, claimed once and done, its records under the "
             "claim's token")
    if kgp.launches == gp0:
        fail("the daemon's BO never ran the GP kernel")

    stats.append(loop.run(ONLINE_STEPS - ONLINE_FIRST - ONLINE_LAST))
    swaps = stats[-1].kernel_swaps
    log(f"[10] after the retune: kernel hot-swaps {swaps}; decode source "
        f"current {dsrc.current}, stale={dsrc.stale}")
    if dsrc.stale:
        fail("the decode cell is still stale after the daemon's run")
    if not swaps:
        log(f"[10] no hot-swap: the source kept {dsrc.current} by its tier "
            "and margin rules")
    captured = server.captures
    server.apply_kernel_config(first)           # the forced swap back
    server.kept, server.keep_logits = [], ONLINE_LAST - 1
    stats.append(loop.run(ONLINE_LAST))
    wall = time.perf_counter() - t0
    cache = server.kernel_cache.stats()
    log(f"[10] swap back to {first}: captures {captured} -> "
        f"{server.captures}; cache {cache}; capture times "
        f"{[round(x, 4) for x in server.capture_s]} s")
    if server.captures != captured or cache["hits"] < 1:
        fail("the swap back captured a new graph instead of a cache hit")
    if server.captures != cache["entries"]:
        fail(f"{server.captures} graphs captured for {cache['entries']} "
             "kernel configs served")

    total = serve.kernel_launches()
    served = {k: total[k] - daemon_launches[k] for k in total}
    n_steps = sum(st.steps for st in stats)
    n_kernel = sum(st.decode_steps_kernel for st in stats)
    warm = {0} | {step for st in stats for step, *_ in
                  st.swaps + st.kernel_swaps}
    lat = [x for st in stats for x in st.latencies]
    log(f"[10] {n_steps} steps in {wall:.1f} s (daemon included), median "
        f"{1e3 * statistics.median(lat):.4f} ms/step; {n_kernel} on the "
        f"decode kernel; prod records {recorder.count} (the prefill's and "
        f"{n_steps - len(warm)} steps, {len(warm)} warm-up); serve launches "
        f"{served}")
    if recorder.count != 1 + n_steps - len(warm):
        fail(f"{recorder.count} prod records, want 1 + {n_steps} - "
             f"{len(warm)}")
    n_dec = cfg.num_layers * ONLINE_STEPS
    fused = all(c.get("combine", "kernel") == "kernel" for c in
                [first] + [c for st in stats for _, c, _ in st.kernel_swaps])
    if not fused:
        log("[10] the tuned decode blocks merge the splits with tensor ops: "
            "steps on them launch the decode kernel in partials mode")
    if (n_kernel != n_steps or served["flash_decode_split"] < n_dec
            or (fused and served["flash_decode_split"]
                != served["flash_decode_combine"])):
        fail(f"decode launches {served}: want {n_dec} or more, each fused "
             "where the served blocks say so")

    # the last steps, after both swaps, against the plain attention path,
    # teacher-forced on the served tokens
    plain_pcfg = ParallelConfig(kernel=None)
    logits, pcache = make_prefill_step(cfg, plain_pcfg, cache_cap=cap)(
        server.params, batch)
    decode = make_decode_step(cfg, plain_pcfg)
    plain = []
    for i in range(ONLINE_STEPS):
        logits, pcache = decode(server.params, pcache,
                                {"tokens": server.out[i][:, None]},
                                SERVE_PROMPT + i)
        if i >= ONLINE_STEPS - ONLINE_LAST:
            plain.append(logits.float().cpu())
    del pcache
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(server.kept, plain))
    log(f"[10] last {ONLINE_LAST} steps vs plain attention path: max|err| / "
        f"max|logits| = {worst:.3e} (limit 2e-2)")
    if len(server.kept) != ONLINE_LAST or worst > 2e-2:
        fail(f"online logits {worst:.3e} x max|logits| from the plain path")
    shutil.rmtree(os.path.dirname(odir))
    return {"parity": worst, "launches": served, "steps": n_steps}


# -- phase 11 ------------------------------------------------------------------


def paper_comparison(dev) -> int:
    """Phase 11(a): the paper's comparison on the GTX Titan X GEMM space at
    its budget, each strategy once at seed 0, BO's surrogate on the GP
    kernel and the padded GPs on the card. Returns the GP-kernel launches."""
    import numpy as np
    import torch
    from repro_torch.core import gp as G
    from repro_torch.core.metrics import mae
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.spaces import make_objective
    from repro_torch.core.strategies import (ALL_BASELINES, ALL_FRAMEWORKS,
                                             BO_NAMES, make_strategy)
    from repro_torch.kernels import matern_gp as kgp
    from repro_torch.launch import compare
    obj = make_objective("gemm", PAPER_GPU)
    cap = PAPER_BUDGET * 50                    # the engine's total-call cap
    gp_launches = 0
    framework_gps = {}
    for label in PAPER_RUNS:
        name = label.split()[0]
        kw = ({"engine": "jax", "gp_device": str(dev)} if "jax" in label
              else compare.strategy_kwargs(name, dev))
        strat = compare.TimedStrategy(make_strategy(name, **kw))
        kgp.launches = 0
        t0 = time.perf_counter()
        res = run_strategy(strat, obj, budget=PAPER_BUDGET, seed=0)
        wall = time.perf_counter() - t0
        gp_launches += kgp.launches
        keys = [o.key for o in res.journal]
        n_inv = sum(not math.isfinite(o.value) for o in res.journal)
        log(f"[11a] {label}: MAE {mae(res.trace, obj.optimum):.4f}, best "
            f"{res.best_value:.4f} (optimum {obj.optimum:.4f}), "
            f"{res.unique_evals} unique evals of {strat.proposals} "
            f"proposals, {n_inv} invalid, {wall:.2f} s, tuner "
            f"{1e3 * strat.seconds / max(strat.proposals, 1):.3f} ms a "
            f"proposal, {kgp.launches} GP-kernel launches")
        if res.unique_evals != PAPER_BUDGET and strat.proposals < cap:
            fail(f"{label}: {res.unique_evals} of {PAPER_BUDGET} evals "
                 "before the total-call cap")
        if len(set(keys)) != len(keys):
            fail(f"{label}: a config was evaluated twice")
        bo = name in BO_NAMES
        if bo and strat.proposals > res.unique_evals + 1:
            fail(f"{label}: BO proposed an evaluated config "
                 f"({strat.proposals} proposals, {res.unique_evals} evals)")
        if bo and "jax" not in label and kgp.launches < PAPER_BUDGET - 20:
            fail(f"{label}: {kgp.launches} GP-kernel launches, want one a "
                 "BO iteration")
        if name in ALL_BASELINES:
            cpu = run_strategy(make_strategy(
                name, **compare.strategy_kwargs(name, "cpu")), obj,
                budget=PAPER_BUDGET, seed=0)
            if [o.key for o in cpu.journal] != keys:
                fail(f"{label}: trace differs from the same run on the CPU")
        if name in ALL_FRAMEWORKS:
            framework_gps[name] = strat.inner.gp
        if "jax" in label:
            framework_gps[label] = strat.inner.gp.gp

    # the padded GPs at their last state: card against CPU against float64
    # (the CPU tests' rule: the card within 8x the CPU's fp32 error plus
    # 1e-5 of the scale), and fit + predict ms on the card
    rng = np.random.default_rng(0)
    for label, g in framework_gps.items():
        cand = (obj.space.X_norm if "jax" in label else
                rng.random((2048, g.dim)).astype(np.float32))
        cpu = G.GP(g.dim, g.max_obs, g.kernel, g.ell, g.noise, device="cpu")
        cpu.X[:], cpu.y[:], cpu.mask[:], cpu.n = g.X, g.y, g.mask, g.n
        got = [t.double().cpu().numpy() for t in g.predict(cand)]
        want = [t.double().numpy() for t in cpu.predict(cand)]
        st = G.gp_fit(torch.from_numpy(g.X).double(),
                      torch.from_numpy(g.y).double(),
                      torch.from_numpy(g.mask), kernel=g.kernel, ell=g.ell,
                      noise=g.noise)
        exact = [t.numpy() for t in G.gp_predict(
            st, torch.from_numpy(cand).double(), kernel=g.kernel, ell=g.ell)]
        cand_dev = g.upload(cand)
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            g.fit()
            mu, _ = g.predict(cand_dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
        for what, a, b, e in zip(("mean", "std"), got, want, exact):
            err_c, err_p = np.abs(a - e).max(), np.abs(b - e).max()
            bound = 8 * err_p + 1e-5 * np.abs(e).max()
            log(f"[11a] {label} padded GP at {g.n} observations, {what} "
                f"over {len(cand)} candidates: card {err_c:.3e}, CPU "
                f"{err_p:.3e} from float64 (bound {bound:.3e})")
            if not (np.isfinite(a).all() and err_c <= bound):
                fail(f"{label}: the padded GP on the card disagrees with "
                     "the CPU")
        log(f"[11a] {label} padded GP fit + predict on the card: "
            f"{1e3 * statistics.median(times):.3f} ms (median of 20, "
            f"{g.max_obs} padded rows)")
    return gp_launches


def _bowl(cfg) -> float:
    import numpy as np
    vals = np.array([cfg[f"p{j}"] for j in range(6)], np.float64)
    return float(0.01 + np.sum((vals / 31.0 - 0.4) ** 2))


def generative_on_card(dev) -> int:
    """Phase 11(b): pool-mode BO, its surrogate on the GP kernel, over a
    constrained space of 1.07e9 cartesian configs, beside the numpy
    surrogate's run of the same seed; and the wide MoE sharding space.
    Returns the GP-kernel launches of the kernel-backed run."""
    import numpy as np
    from repro_torch.core.gp_fast import IncrementalGP
    from repro_torch.core.objectives import CallableObjective
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.searchspace import (GenerativeSpace, Param,
                                              SearchSpace, VectorConstraint)
    from repro_torch.core.strategies import make_strategy
    from repro_torch.core.tuning_targets import sharding_space
    from repro_torch.kernels import matern_gp as kgp
    space = SearchSpace([Param(f"p{j}", tuple(range(32))) for j in range(6)],
                        [VectorConstraint(
                            lambda c: (c["p0"] + c["p1"]) % 2 == 0)],
                        name="gen1e9")
    if not isinstance(space, GenerativeSpace):
        fail("a 1e9 cartesian space did not build as a GenerativeSpace")
    obj = CallableObjective(space, _bowl, name="gen1e9_bowl")
    runs = {}
    for backend in ("cuda", "numpy"):
        kw = ({"gp_backend": "cuda", "gp_device": str(dev)}
              if backend == "cuda" else {})
        strat = make_strategy("ei", **kw)
        kgp.launches = 0
        t0 = time.perf_counter()
        res = run_strategy(strat, obj, budget=GEN_BUDGET, seed=0)
        runs[backend] = (res, strat, kgp.launches,
                         time.perf_counter() - t0)
    res, strat, n_gp, wall = runs["cuda"]
    ref = runs["numpy"][0]
    codes = np.array([o.idx for o in res.journal], np.int64)
    keys = [o.key for o in res.journal]
    agree = next((i for i, (a, b) in enumerate(zip(keys, [
        o.key for o in ref.journal])) if a != b), len(keys))
    log(f"[11b] {space.name} (cartesian {space.cartesian_size:,}): ei, "
        f"gp_backend cuda, {res.unique_evals} evals in {wall:.2f} s, "
        f"{n_gp} GP-kernel launches, best {res.best_value:.5f}; numpy "
        f"surrogate best {ref.best_value:.5f} in {runs['numpy'][3]:.2f} s; "
        f"the first {agree} suggestions agree")
    if res.unique_evals != GEN_BUDGET or len(set(keys)) != len(keys):
        fail("generative BO did not spend its budget without revisits")
    if not space._feasible_mask(codes).all():
        fail("generative BO suggested an infeasible config")
    if agree < strat.cfg.initial_samples:
        fail(f"the initial sample differs from the numpy run at {agree}")
    if n_gp < GEN_BUDGET - strat.cfg.initial_samples:
        fail(f"{n_gp} GP-kernel launches for "
             f"{GEN_BUDGET - strat.cfg.initial_samples} BO iterations: a "
             "pool fell back to numpy")
    # the kernel-backed posterior at the final state, at pool sizes that do
    # not tile block_n, against the numpy surrogate on the same state
    # (phase 2's rule for the GP kernel: the mean within 3% of its range
    # over the largest pool, here the std too)
    gp = strat.gp.gp
    plain = IncrementalGP.from_state(gp.state())
    rng = np.random.default_rng(3)
    pools = [space.X_norm[space.sample_feasible(rng, m)]
             for m in (2049, 777, 1)]
    mu_n, sd_n = plain.predict_at(pools[0])
    scale_mu = float(mu_n.max() - mu_n.min())
    scale_sd = float(sd_n.max() - sd_n.min())
    for X in pools:
        before = kgp.launches
        mu, sd = gp.predict_at(X)
        mu_n, sd_n = plain.predict_at(X)
        e_mu = float(np.abs(mu - mu_n).max())
        e_sd = float(np.abs(sd - sd_n).max())
        log(f"[11b] pool of {len(X)}: kernel against numpy, mean "
            f"{e_mu:.3e} ({e_mu / scale_mu:.2e} of its range), std "
            f"{e_sd:.3e} ({e_sd / scale_sd:.2e}); "
            f"{kgp.launches - before} launch")
        if (kgp.launches != before + 1 or e_mu > 0.03 * scale_mu
                or e_sd > 0.03 * scale_sd):
            fail(f"pool of {len(X)}: the kernel-backed posterior disagrees "
                 "with numpy or did not launch")
    # the wide MoE sharding space the port could not build before
    t0 = time.perf_counter()
    wide = sharding_space(WIDE_ARCH, "train_4k", wide=True)
    built = time.perf_counter() - t0
    est = wide.feasible_fraction_interval()
    t0 = time.perf_counter()
    first = wide.sample_feasible(np.random.default_rng(0), 1)
    drawn = time.perf_counter() - t0
    log(f"[11b] {wide.name}: {type(wide).__name__}, cartesian "
        f"{wide.cartesian_size:,}, built in {1e3 * built:.2f} ms; feasible "
        f"fraction estimate {est['point']:.3g} ({est['method']} "
        f"[{est['lo']:.2g}, {est['hi']:.2g}]); first feasible sample in "
        f"{1e3 * drawn:.2f} ms")
    if not (isinstance(wide, GenerativeSpace)
            and wide._feasible_mask(first).all()):
        fail(f"{wide.name}: not generative or its first sample infeasible")
    return n_gp


def live_comparison(cell, sdir: str, phase4: str) -> int:
    """Phase 11(c): the baselines and the frameworks tune phase 4's cell
    with phase 4's budget, journaled into the same store. Returns the GEMM
    launches."""
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.strategies import (ALL_BASELINES, ALL_FRAMEWORKS,
                                             make_strategy)
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import tuning
    from repro_torch.launch import compare
    log(f"[11c] beside phase 4's BO: {phase4}")
    n_gemm = 0
    for name in ALL_BASELINES + ALL_FRAMEWORKS:
        obj = tuning.KernelObjective(cell, reps=3, device=cell.device)
        strat = compare.TimedStrategy(make_strategy(
            name, **compare.strategy_kwargs(name, obj.device)))
        kg.launches = 0
        t0 = time.perf_counter()
        res = run_strategy(strat, obj, budget=GEMM_BUDGET, seed=0,
                           store=sdir, warm_start=False,
                           run_id=f"{name}_{cell.kernel}_{cell.shape_sig}-s0")
        n_gemm += kg.launches
        n_static, n_runtime = invalid_split(res, cell)
        best = (f"{cell.space.config(res.best_idx)} "
                f"{res.best_value * 1e3:.4f} ms after {evals_to_best(res)} "
                "evals" if math.isfinite(res.best_value) else "none valid")
        log(f"[11c] {name}: best {best}; {res.unique_evals} evals of "
            f"{strat.proposals} proposals, invalid {n_static} static, "
            f"{n_runtime} runtime; {kg.launches} gemm launches; "
            f"{time.perf_counter() - t0:.1f} s")
        # the budget, or the engine's total-call cap (a walk that keeps
        # proposing evaluated configs, as simulated annealing does)
        if (res.unique_evals != GEMM_BUDGET
                and strat.proposals < 50 * GEMM_BUDGET):
            fail(f"{name}: {res.unique_evals} of {GEMM_BUDGET} evals")
    return n_gemm


def serve_cases(kc, dev, card: str) -> dict:
    """The serve kernels at gemma-2b's shapes with the blocks phase 8 ran:
    name -> (label, kernel fn, plain fn, library fn or None, bound ms,
    bound_by); a kernel fn that is a pair is timed as the difference of
    the two. The decode library call (SDPA with the additive bias mask and
    enable_gqa) computes split + combine together: it is timed beside the
    one fused launch as ``FUSED_DECODE`` and given to neither kernel. Both
    sides take the validity bias built beforehand, as SDPA takes its mask.
    The row ``decode as served`` times it as the serve path runs it, the
    bias built from the cache positions on every side."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.roofline import bound_ms
    bf16 = torch.bfloat16
    rng = np.random.default_rng(2)
    B, S, H, KV, hd = GEMMA_FLASH
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd))).to(dev, bf16)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(dev, bf16)
            for _ in range(2))
    bq, bkv = kc.flash_block_q, kc.flash_block_kv
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    cases = {"flash_attention": (
        f"flash B{B} S{S} H{H} KV{KV} hd{hd} bf16 ({bq},{bkv}); library "
        "SDPA(is_causal, enable_gqa)",
        lambda: kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv),
        lambda: ref.attention(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        *bound_ms(4.0 * B * H * hd * S * (S + 1) / 2,
                  2.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd), card,
                  "bfloat16"))}
    # the reference's causal=False branch at the same shape and blocks (no
    # model path runs it: it is timed here, not on the JSON line)
    cases[FLASH_FULL] = (
        f"flash full (causal=False) B{B} S{S} H{H} KV{KV} hd{hd} bf16 "
        f"({bq},{bkv}); library SDPA(is_causal=False, enable_gqa)",
        lambda: kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv,
                                    causal=False),
        lambda: ref.attention(q, k, v, causal=False),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=False,
                                               enable_gqa=True),
        *bound_ms(4.0 * B * H * hd * S * S,
                  2.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd), card,
                  "bfloat16"))

    B, S, H, KV, hd = GEMMA_DECODE
    G = H // KV
    ns, dbkv = kc.decode_num_splits, kc.decode_block_kv
    cur = int(S * DECODE_FILL) - 1
    qd = torch.from_numpy(rng.normal(size=(B, H, hd))).to(dev, bf16)
    kd, vd = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(dev, bf16)
              for _ in range(2))
    cp = torch.from_numpy(np.broadcast_to(_cache_positions(S, cur, False),
                                          (B, S)).copy()).to(dev)
    cu = torch.full((B,), cur, dtype=torch.long, device=dev)
    bias = ops.decode_bias(cp, cu, None, ns * dbkv)
    n_valid = int((bias == 0).sum())            # slots the data needs read
    part_bytes = 4.0 * B * KV * ns * G * (hd + 2)
    out_bytes = 2.0 * B * H * hd
    parts = kfd.decode_split(qd, kd, vd, bias, block_kv=dbkv, num_splits=ns)
    mask = bias[:, :S].to(bf16)[:, None, None, :]
    kv_bytes = 2.0 * 2 * n_valid * KV * hd + 2.0 * B * H * hd \
        + 4.0 * B * bias.shape[1]
    split_b = bound_ms(4.0 * hd * G * KV * n_valid, kv_bytes + part_bytes,
                       card, "bfloat16")
    fused_b = bound_ms(4.0 * hd * G * KV * n_valid, kv_bytes + out_bytes,
                       card, "bfloat16")

    def split():
        return kfd.decode_split(qd, kd, vd, bias, block_kv=dbkv,
                                num_splits=ns)

    def fused():
        return kfd.flash_decode(qd, kd, vd, bias, block_kv=dbkv,
                                num_splits=ns, combine="kernel")

    cases["flash_decode_split"] = (
        f"decode split B{B} S{S} ({n_valid} valid slots) H{H} KV{KV} hd{hd} "
        f"bf16 ({dbkv},{ns}), partials mode; library none",
        split, lambda: ref.decode_split(qd, kd, vd, bias, ns), None,
        *split_b)
    # the combine has no launch of its own: its time is the fused launch's
    # less the partials-mode launch's (a pair of functions: their difference)
    cases["flash_decode_combine"] = (
        f"decode combine, fused into the split kernel ({ns} splits) bf16: "
        "fused launch less partials-mode launch; plain: the tensor-op "
        "combine of the partials; library none",
        (fused, split),
        lambda: ref.combine_partials(*parts).reshape(B, H, hd).to(bf16),
        None, *bound_ms(2.0 * ns * B * H * hd, part_bytes + out_bytes, card))
    cases[FUSED_DECODE] = (
        "decode as a whole, one launch (split with the combine fused in, on "
        "the bias); library SDPA(the bias as its additive mask, enable_gqa)",
        fused,
        lambda: ref.combine_partials(*ref.decode_split(
            qd, kd, vd, bias, ns)).reshape(B, H, hd).to(bf16),
        lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True),
        *fused_b)
    # as a layer of the serve path runs it: the bias built from the cache
    # positions, then the fused launch; the plain and library sides build
    # their bias too
    cases["decode as served (bias + fused launch)"] = (
        "decode as served (the bias built, then the fused launch); library "
        "SDPA(the bias built as its additive mask, enable_gqa)",
        lambda: ops.decode_attention(qd[:, None], kd, vd, cp, cu,
                                     block_kv=dbkv, num_splits=ns,
                                     combine="kernel"),
        lambda: ref.combine_partials(*ref.decode_split(
            qd, kd, vd, ops.decode_bias(cp, cu, None, ns * dbkv), ns)
        ).reshape(B, H, hd).to(bf16),
        lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=ops.decode_bias(cp, cu, None, 1).to(bf16)[:, None,
                                                                 None],
            enable_gqa=True),
        *bound_ms(4.0 * hd * G * KV * n_valid,
                  2.0 * 2 * n_valid * KV * hd + 2.0 * 2 * B * H * hd
                  + 8.0 * B * S, card, "bfloat16"))
    return cases


def device_ms(fn, reps: int = 20, warmup: int = 3, kernels=None):
    """Device time of one call of ``fn``: the kernels (and copies) the
    profiler saw over ``reps`` calls, divided by ``reps``. Host launch time
    is not in it, where CUDA events around one call include it whenever
    the kernel is shorter than its launch. None where the profiler sees no
    device time. A list given as ``kernels`` receives (name, device events
    per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [a for a in prof.key_averages()
            if a.device_type != DeviceType.CPU and a.self_device_time_total > 0]
    if kernels is not None:
        kernels.extend((a.key, a.count / reps) for a in rows)
    us = sum(a.self_device_time_total for a in rows)
    return us / 1e3 / reps if us > 0 else None


def timed(timer, fn, what: str):
    """``timer(fn)``; for a pair (a, b), a's time less b's, the two timed
    in turns (a b b a, twice), each the median of its four, printed beside
    the difference. None where the timer gives none."""
    if not isinstance(fn, tuple):
        return timer(fn)
    a, b = fn
    ta, tb = [], []
    for i in range(4):
        for f in ((a, b) if i % 2 == 0 else (b, a)):
            (ta if f is a else tb).append(timer(f))
    if None in ta + tb:
        return None
    ma, mb = statistics.median(ta), statistics.median(tb)
    log(f"    {what}: {ma:.4f} ms less {mb:.4f} ms = {ma - mb:.4f} ms")
    return ma - mb


# -- phase 12 ------------------------------------------------------------------


class Probe:
    """Hooks on the port's attention cores and MoE router while a run is
    inside ``with``: the calls of the plain attention cores, each kernel
    call's output against its plain version on the same inputs (``check``:
    the kernel's max|err| over max|plain|, bf16 held as phase 2 holds it),
    and each MoE layer's top-k choice (``record``), in call order. The
    hooks replace module attributes that ``gqa_attention`` and
    ``moe_block`` look up at each call; a captured graph replays what its
    capture called. ``check`` and ``record`` read back to the host, so
    they stay off while a graph is captured."""

    NAMES = ("_direct_attention", "_decode_attention", "_flash_attention",
             "_kernel_flash_attention", "_kernel_decode_attention",
             "moe_route")

    def __init__(self, check: bool = False, record: bool = False):
        self.check, self.record = check, record
        #: calls of each plain attention core, by name
        self.plain = dict.fromkeys(self.NAMES[:3], 0)
        self.core_err = 0.0
        self.core_calls = 0
        self.routes = []

    @property
    def plain_calls(self) -> int:
        return sum(self.plain.values())

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops, ref
        from repro_torch.models import layers as L
        self.L = L
        orig = self.saved = {n: getattr(L, n) for n in self.NAMES}
        probe = self

        def held(got, want):
            want = want.float()
            probe.core_err = max(probe.core_err, float(
                (got.float() - want).abs().max() / want.abs().max()))
            probe.core_calls += 1

        def plain(name):
            def core(*a, **kw):
                probe.plain[name] += 1
                return orig[name](*a, **kw)
            return core

        def kflash(q, k, v, kc):
            out = orig["_kernel_flash_attention"](q, k, v, kc)
            if probe.check:      # the plain version in fp32 (phase 2's rule)
                held(out, ref.attention(q.float(), k.float(), v.float()
                                        ).to(q.dtype))
            return out

        def kdecode(q, k_cache, v_cache, *, cache_pos, cur_pos, window, kc):
            out = orig["_kernel_decode_attention"](
                q, k_cache, v_cache, cache_pos=cache_pos, cur_pos=cur_pos,
                window=window, kc=kc)
            if probe.check:
                ns = kc.decode_num_splits
                bias = ops.decode_bias(cache_pos, cur_pos, window,
                                       ns * kc.decode_block_kv)
                held(out, ref.combine_partials(*ref.decode_split(
                    q[:, 0], k_cache, v_cache, bias, ns)).reshape(
                        out.shape).to(q.dtype))
            return out

        def route(p, xg, *, cfg, C):
            out = orig["moe_route"](p, xg, cfg=cfg, C=C)
            if probe.record:
                probe.routes.append(torch.sort(out[0], dim=-1).values.cpu())
            return out

        for n, f in zip(self.NAMES, [plain(n) for n in self.NAMES[:3]]
                        + [kflash, kdecode, route]):
            setattr(L, n, f)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.L, n, f)


def routing_flips(a_routes, b_routes, B: int, S: int):
    """Top-k choices of two runs, layer by layer and call by call: the
    share of (token, k) choices that differ, the share of (layer, token)
    rows whose top-k sets differ, and the batch rows whose every token in
    every layer so far chose alike, after each call (prefill calls hold
    B x S tokens row-major, decode calls B)."""
    import torch
    if len(a_routes) != len(b_routes):
        fail(f"the two runs routed {len(a_routes)} and {len(b_routes)} "
             "times")
    diff = rows = n = n_rows = 0
    agree = torch.ones(B, dtype=torch.bool)
    agree_after = []
    for a, b in zip(a_routes, b_routes):
        miss = ~(a[:, :, None] == b[:, None, :]).any(-1)        # (T, K)
        diff += int(miss.sum())
        n += miss.numel()
        bad = miss.any(-1)
        rows += int(bad.sum())
        n_rows += bad.numel()
        agree &= ~bad.reshape(B, -1).any(-1)
        agree_after.append(agree.clone())
    return diff / max(n, 1), rows / max(n_rows, 1), agree_after


def family_cases(cfg, kc, dev, card, prompt=SERVE_PROMPT, cap=None,
                 window=None, cur=None, paths=("flash", "decode")):
    """The attention kernels a served model reaches (``paths``) at its
    shapes and blocks, on inputs from a seed: the flash kernel at its
    prefill (B 4 x ``prompt``) and the fused decode launch on a cache of
    ``cap`` slots (default 1,088) at position ``cur`` (default 97% full;
    with a ``window``, the rolling layout of a windowed cache). name ->
    (label, kernel fn, plain fn, library fn, bound ms, bound_by, max|err|
    of the kernel against the plain version, phase 2's rule)."""
    import numpy as np
    rng = np.random.default_rng(3)
    B, S, H, KV = SERVE_B, prompt, cfg.num_heads, cfg.num_kv_heads
    hd, G = cfg.resolved_head_dim, H // KV
    cases = {}
    if "flash" in paths:
        cases.update(_flash_case(cfg, kc, dev, card, rng, B, S, H, KV, hd))
    if "decode" in paths:
        cases.update(_decode_case(cfg, kc, dev, card, rng, B, H, KV, hd, G,
                                  cap or SERVE_PROMPT + SERVE_STEPS, window,
                                  cur))
    return cases


def _flash_case(cfg, kc, dev, card, rng, B, S, H, KV, hd):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import bound_ms
    bf16 = torch.bfloat16
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd))).to(dev, bf16)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(dev, bf16)
            for _ in range(2))
    bq, bkv = kc.flash_block_q, kc.flash_block_kv
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash = (lambda: kfa.flash_attention(q, k, v, block_q=bq, block_kv=bkv))
    plain = (lambda: ref.attention(q, k, v))
    err_f = _agree(flash().float(), plain().float(), bf16,
                   f"{cfg.name} flash B{B} S{S} H{H} KV{KV} hd{hd} bf16 "
                   f"({bq},{bkv})")
    return {"flash_attention": (
        f"flash B{B} S{S} H{H} KV{KV} hd{hd} bf16 ({bq},{bkv}); library "
        "SDPA(is_causal, enable_gqa)", flash, plain,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        *bound_ms(4.0 * B * H * hd * S * (S + 1) / 2,
                  2.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd), card,
                  "bfloat16"), err_f)}


def _decode_case(cfg, kc, dev, card, rng, B, H, KV, hd, G, Sd, window,
                 cur):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.roofline import bound_ms
    bf16 = torch.bfloat16
    ns, dbkv = kc.decode_num_splits, kc.decode_block_kv
    if cur is None:
        cur = int(Sd * DECODE_FILL) - 1
    rolling = window is not None
    qd = torch.from_numpy(rng.normal(size=(B, H, hd))).to(dev, bf16)
    kd, vd = (torch.from_numpy(rng.normal(size=(B, Sd, KV, hd))).to(dev, bf16)
              for _ in range(2))
    cp = torch.from_numpy(np.broadcast_to(_cache_positions(Sd, cur, rolling),
                                          (B, Sd)).copy()).to(dev)
    cu = torch.full((B,), cur, dtype=torch.long, device=dev)
    bias = ops.decode_bias(cp, cu, window, ns * dbkv)
    n_valid = int((bias == 0).sum())
    mask = bias[:, :Sd].to(bf16)[:, None, None, :]
    fused = (lambda: kfd.flash_decode(qd, kd, vd, bias, block_kv=dbkv,
                                      num_splits=ns,
                                      combine=kc.decode_combine))
    dplain = (lambda: ref.combine_partials(*ref.decode_split(
        qd, kd, vd, bias, ns)).reshape(B, H, hd).to(bf16))
    win = "" if window is None else f" window {window} rolling"
    err_d = _agree(fused().float(), dplain().float(), bf16,
                   f"{cfg.name} decode B{B} S{Sd}{win} ({n_valid} valid) "
                   f"H{H} KV{KV} G{G} hd{hd} bf16 ({dbkv},{ns}) "
                   f"{kc.decode_combine}")
    return {"flash_decode_split": (
        f"decode B{B} S{Sd}{win} ({n_valid} valid slots) H{H} KV{KV} "
        f"G{G} hd{hd} bf16 ({dbkv},{ns}), combine {kc.decode_combine} (one "
        "launch where fused); library SDPA(the bias as its additive mask, "
        "enable_gqa)", fused, dplain,
        lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True),
        *bound_ms(4.0 * hd * G * KV * n_valid,
                  2.0 * 2 * n_valid * KV * hd + 2.0 * 2 * B * H * hd
                  + 4.0 * B * bias.shape[1], card, "bfloat16"), err_d)}


def moe_step_bounds(cfg, routes, card):
    """Byte bounds of one qwen3-moe decode step at batch 4 (weights read
    once, the KV cache's valid slots, the embedding rows): every expert
    read, as the reference's dense (E, C, d) dispatch reads them; the
    routed experts only at their most (B x k of E per layer); and the
    routed experts this run's decode steps chose (distinct experts per
    layer and step, measured). (ms, ms, ms, distinct experts a layer)."""
    from repro_torch.launch.roofline import bound_ms
    from repro_torch.models.params import count_params
    mo, L = cfg.moe, cfg.num_layers
    expert = 3 * mo.num_experts * cfg.d_model * mo.d_expert     # a layer's
    other = count_params(cfg) - L * expert - cfg.vocab_size * cfg.d_model
    cache = (2 * 2 * SERVE_B * (SERVE_PROMPT + SERVE_STEPS // 2) * L
             * cfg.num_kv_heads * cfg.resolved_head_dim)
    base = 2.0 * (other + SERVE_B * cfg.d_model) + cache
    dec = [r for r in routes if r.shape[0] == SERVE_B]
    distinct = (sum(len(set(r.flatten().tolist())) for r in dec)
                / max(len(dec), 1))
    most = min(mo.num_experts, SERVE_B * mo.top_k)
    return (bound_ms(0, base + 2.0 * L * expert, card)[0],
            bound_ms(0, base + 2.0 * L * expert * most / mo.num_experts,
                     card)[0],
            bound_ms(0, base + 2.0 * L * expert * distinct / mo.num_experts,
                     card)[0], distinct)


def serve_family(name: str, layers, steps: int, sdir: str, dev,
                 card: str) -> dict:
    """Phase 12, one model: DecodeServer at full width (depth cut to
    ``layers`` where given) with blocks from the store; prefill 4 x 1,024
    (a cold one, then the timed one), ``steps`` graph replays; launches of
    each kernel and no call of a plain attention core; the logits held
    against the plain attention path, teacher-forced on the served tokens,
    at 2e-2 x max|logits|; a dense model whose two bf16 paths differ by
    more is held against the same weights in fp32 (``FP32_MARGIN``), and
    ``CONTROL_ARCH`` is also run with scaled and with scaled and tied
    embeddings, to show what sets that distance. An MoE model's routing is
    held too: the kernel
    path's eager run and the plain path record each layer's top-k; where
    the end-to-end limit is missed and routing differs, each kernel call is
    held to its plain version on its own inputs (the unit the kernels
    change) and the logits of the batch rows whose routing agreed in every
    layer to the limit. Then its two kernels at its shapes
    (``family_cases``), and the model is freed."""
    import gc
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.params import leaves
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import ParallelConfig
    full = get_arch(name)
    cfg = full if layers is None else full.replace(num_layers=layers)
    tag = f"[12] {name}" + ("" if layers is None else
                           f" ({layers} of {full.num_layers} layers)")
    cap = SERVE_PROMPT + steps
    parity = min(PARITY_STEPS, steps)
    kc = serve.serving_kernel_config(cfg, device=dev, prompt_len=SERVE_PROMPT,
                                     cache_cap=cap, store=sdir, batch=SERVE_B,
                                     log=log)
    if not (kc.use_flash and kc.use_decode):
        fail(f"{name}: serving config {kc} leaves a kernel off")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with Probe() as probe:
        t0 = time.perf_counter()
        server = serve.DecodeServer(
            cfg, ParallelConfig(kernel=kc), batch=SERVE_B,
            prompt_len=SERVE_PROMPT, decode_steps=steps, seed=0, device=dev,
            keep_logits=parity)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for _, t in leaves(server.params))
        batch = server.input_batch()
        serve.reset_kernel_launches()
        cold_s = server.prefill_batch(batch)
        prefill_s = server.prefill_batch(batch)
        step_s = [server.decode_step() for _ in range(steps)]
        launches = serve.kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    med = statistics.median(step_s)
    log(f"{tag}: {n_params:,} parameters (bf16, {2 * n_params / 1e9:.2f} GB)"
        f" initialised in {init_s:.3f} s; blocks {kc}")
    log(f"{tag}: prefill {SERVE_B} x {SERVE_PROMPT}: {prefill_s * 1e3:.3f} ms "
        f"(first call {cold_s * 1e3:.3f} ms; {server.prefill_dispatch}); "
        f"decode {steps} steps: median {med * 1e3:.4f} ms/step (min "
        f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f}), "
        f"{SERVE_B / med:.1f} tokens/s ({server.decode_dispatch}); peak "
        f"memory {peak / 2 ** 30:.3f} GiB; launches {launches}; plain "
        f"attention calls {probe.plain_calls}")
    fused = kc.decode_combine == "kernel"
    n_dec = cfg.num_layers * (steps + server.captures)
    want = {"flash_attention": 2 * cfg.num_layers,
            "flash_decode_split": n_dec,
            "flash_decode_combine": n_dec * fused}
    if server.captures != 1 or launches != want or probe.plain_calls:
        fail(f"{name}: {server.captures} captures, launches {launches} "
             f"(want {want}), {probe.plain_calls} plain attention calls")
    if not all(bool(torch.isfinite(x).all()) for x in server.kept) or \
            torch.stack(server.out, 1).shape != (SERVE_B, steps + 1):
        fail(f"{name}: served tokens or logits malformed")

    moe = cfg.moe is not None

    def forced(label, run_cfg, params, kcx):
        """Prefill + ``parity`` decode steps teacher-forced on the served
        tokens, eager, under a Probe: (logits per step, probe)."""
        pcfg = ParallelConfig(kernel=kcx)
        with Probe(check=kcx is not None, record=moe) as pr:
            logits, cache = make_prefill_step(run_cfg, pcfg, cache_cap=cap)(
                params, batch)
            out = [logits.float().cpu()]
            decode = make_decode_step(run_cfg, pcfg)
            for i in range(parity):
                logits, cache = decode(params, cache,
                                       {"tokens": server.out[i][:, None]},
                                       SERVE_PROMPT + i)
                out.append(logits.float().cpu())
            del cache, logits
        return out, pr

    def dist(a_steps, b_steps):
        return [float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(a_steps, b_steps)]

    runs = {"kernels": forced("kernels", cfg, server.params, kc),
            "plain": forced("plain", cfg, server.params, None)}
    plain = runs["plain"][0]
    rel = dist(server.kept, plain)
    same = sum(int(torch.equal(a.argmax(-1), b.argmax(-1)))
               for a, b in zip(server.kept, plain))
    log(f"{tag}: served vs plain attention path, prefill + {parity} "
        f"teacher-forced steps: max|err| / max|logits| per step "
        f"{[round(x, 5) for x in rel]} (limit 2e-2); greedy tokens equal at "
        f"{same} of {len(plain)}")
    result = {"cfg": cfg, "kc": kc, "launches": launches,
              "prefill_ms": prefill_s * 1e3, "step_ms": med * 1e3,
              "tokens_s": SERVE_B / med, "peak": peak, "parity": max(rel),
              "params": n_params}
    if moe:
        kr, pr = runs["kernels"][1], runs["plain"][1]
        share, row_share, agree = routing_flips(kr.routes, pr.routes,
                                                SERVE_B, SERVE_PROMPT)
        eager = [float((a - b).abs().max()) / float(b.abs().max())
                 for a, b in zip(runs["kernels"][0], plain)]
        n_moe = sum(1 for _ in kr.routes) // (parity + 1)
        # agreement after each step's last MoE layer
        rows_ok = [agree[(i + 1) * n_moe - 1] for i in range(parity + 1)]
        log(f"{tag}: routing, kernel path against plain path on the same "
            f"tokens: {100 * share:.3f}% of top-{cfg.moe.top_k} choices "
            f"differ, {100 * row_share:.3f}% of (layer, token) rows; batch "
            f"rows agreeing in every layer after each step "
            f"{[int(r.sum()) for r in rows_ok]} of {SERVE_B}; the kernel "
            f"path's eager logits against plain "
            f"{[round(x, 5) for x in eager]}; each kernel call against its "
            f"plain version on its inputs: max|err| / max|plain| "
            f"{kr.core_err:.3e} over {kr.core_calls} calls (limit 2^-7)")
        bounds = moe_step_bounds(cfg, pr.routes, card)
        log(f"{tag}: decode step {med * 1e3:.4f} ms against byte bounds: "
            f"every expert read {bounds[0]:.4f} ms, the routed only at "
            f"most ({min(cfg.moe.num_experts, SERVE_B * cfg.moe.top_k)} of "
            f"{cfg.moe.num_experts} a layer) {bounds[1]:.4f} ms, the "
            f"{bounds[3]:.2f} distinct experts a layer this run's steps "
            f"chose {bounds[2]:.4f} ms ({smi_line()})")
        result.update(flip_share=share, flip_rows=row_share,
                      core_err=kr.core_err, bounds=bounds, eager=max(eager))
        if kr.core_calls < 2 * cfg.num_layers or kr.core_err > 2.0 ** -7:
            fail(f"{name}: a kernel call disagrees with its plain version "
                 f"on its own inputs ({kr.core_err:.3e} over "
                 f"{kr.core_calls} calls)")
        if max(rel) > 2e-2:
            if share == 0:
                fail(f"{name}: logits {max(rel):.3e} x max|logits| from the "
                     "plain path with the same routing")
            worst, n_rows = 0.0, 0
            for i, ok in enumerate(rows_ok):
                if bool(ok.any()):
                    n_rows += int(ok.sum())
                    a, b = server.kept[i][ok], plain[i][ok]
                    worst = max(worst, float((a - b).abs().max())
                                / float(b.abs().max()))
            rows = (f"{n_rows} (row, step) logits whose routing agreed in "
                    f"every layer: max|err| / max|logits| {worst:.3e}"
                    if n_rows else "no batch row whose routing agreed in "
                    "every layer to hold")
            log(f"{tag}: the end-to-end limit is missed where routing "
                f"differs; held instead per kernel call (above), and {rows}"
                " (limit 2e-2)")
            if worst > 2e-2:
                fail(f"{name}: rows with equal routing {worst:.3e} x "
                     "max|logits| from the plain path")
            result["parity_rows"] = worst
        # where a step's time goes: a prefill, then PROFILE_STEPS graph
        # replays (no logits kept)
        server.keep_logits = 0
        profile_window(lambda: server.prefill_batch(batch),
                       f"{name}: a prefill", top=12)
        profile_window(lambda: [server.decode_step()
                                for _ in range(PROFILE_STEPS)],
                       f"{name}: {PROFILE_STEPS} decode steps", top=12)
    else:
        # the same weights in fp32, fp32 activations, plain attention: how
        # far each bf16 path sits from the model it rounds
        from repro_torch.models.params import map_tree

        def fp32_of(run_cfg, params):
            p32 = map_tree(lambda t: t.float(), params)
            out = forced("fp32", run_cfg.replace(dtype="float32"), p32,
                         None)[0]
            del p32
            return out

        f32 = fp32_of(cfg, server.params)
        d_served, d_plain = dist(server.kept, f32), dist(plain, f32)
        kr = runs["kernels"][1]
        log(f"{tag}: against the same weights in fp32 (plain attention, "
            f"teacher-forced): served {[round(x, 5) for x in d_served]}, "
            f"plain bf16 path {[round(x, 5) for x in d_plain]}; each kernel "
            f"call against its plain version on its inputs: max|err| / "
            f"max|plain| {kr.core_err:.3e} over {kr.core_calls} calls "
            "(limit 2^-7)")
        result.update(fp32_served=max(d_served), fp32_plain=max(d_plain),
                      core_err=kr.core_err)
        if kr.core_calls < 2 * cfg.num_layers or kr.core_err > 2.0 ** -7:
            fail(f"{name}: a kernel call disagrees with its plain version "
                 f"on its own inputs ({kr.core_err:.3e} over "
                 f"{kr.core_calls} calls)")
        if max(rel) > 2e-2:
            # two bf16 paths of this model differ by more than the serve
            # limit: the kernel path is held to the plain path's own
            # distance from the fp32 model, plus FP32_MARGIN
            ok = max(d_served) <= max(d_plain) + FP32_MARGIN
            log(f"{tag}: the end-to-end limit is missed by the plain bf16 "
                f"path's own rounding ({max(d_plain):.5f} of max|logits| "
                "from fp32); held instead: served at most the plain path's "
                f"distance from fp32 + {FP32_MARGIN:g}, worst steps: "
                f"{max(d_served):.5f} against {max(d_plain):.5f} + "
                f"{FP32_MARGIN:g} ({'met' if ok else 'missed'})")
            if not ok:
                fail(f"{name}: served logits {max(d_served):.5f} of "
                     "max|logits| from the fp32 model, the plain path "
                     f"{max(d_plain):.5f} (+ {FP32_MARGIN:g} allowed)")
        if name == CONTROL_ARCH:
            # what sets the bf16 paths' distance: the same weights with
            # sqrt(d)-scaled embeddings, then also with the head tied to
            # them (the embedding table stands in for lm_head)
            tied = {k: t for k, t in server.params.items() if k != "lm_head"}
            control = {}
            for label, ccfg, cp in (
                    ("scaled embeddings",
                     cfg.replace(scale_embeddings=True), server.params),
                    ("scaled and tied embeddings",
                     cfg.replace(scale_embeddings=True, tie_embeddings=True),
                     tied)):
                k_out, k_pr = forced("kernels", ccfg, cp, kc)
                p_out = forced("plain", ccfg, cp, None)[0]
                c32 = fp32_of(ccfg, cp)
                row = (max(dist(k_out, p_out)), max(dist(p_out, c32)),
                       max(dist(k_out, c32)),
                       max(float(x.abs().max()) for x in c32))
                control[label] = row
                log(f"{tag}, control with {label}: worst step, max|err| / "
                    f"max|logits|: kernels against plain {row[0]:.5f}, "
                    f"plain against fp32 {row[1]:.5f}, kernels against fp32 "
                    f"{row[2]:.5f}; fp32 max|logits| {row[3]:.3f} (this "
                    f"config's {max(float(x.abs().max()) for x in f32):.3f})"
                    f"; kernel calls {k_pr.core_err:.3e} over "
                    f"{k_pr.core_calls}")
                del k_out, p_out, c32
            result["control"] = control
            del tied
    del runs, server, batch
    gc.collect()
    torch.cuda.empty_cache()

    cases = family_cases(cfg, kc, dev, card)
    times = {}
    for kname, (label, *fns, bound, by, err) in cases.items():
        ev = [timed(event_ms, f, f"{tag} {kname} events") for f in fns]
        dv = [timed(device_ms, f, f"{tag} {kname} device") for f in fns]
        k_ms, p_ms, l_ms = (e if d is None else d for d, e in zip(dv, ev))
        log(f"{tag} {label}: kernel {k_ms:.4f} ms (events {ev[0]:.4f}), "
            f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound "
            f"{bound:.6f} ms ({by}); kernel / library {k_ms / l_ms:.3f}; "
            f"max|err| {err:.3e}")
        times[kname] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": bound, "bound_by": by,
                        "max_abs_err": err}
    result["kernels"] = times
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    return result


# -- phase 13 ------------------------------------------------------------------


def step_bytes(cfg, B: int, filled: int) -> float:
    """Bytes one decode step must move at batch ``B`` with ``filled``
    positions in each cache: every weight once (all the experts, as the
    reference's dense (E, C, d) dispatch reads them; an untied token table
    only its B rows), each attention layer's live cache entries (a windowed
    layer at most its window; MLA its latent rows; cross-attention's K/V),
    and each recurrent state read and written."""
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params, layer_kinds
    n = count_params(cfg)
    if cfg.frontend is None and not cfg.tie_embeddings:
        n -= (cfg.vocab_size - B) * cfg.d_model
    total = 2.0 * n
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    for kind in layer_kinds(cfg):
        if kind in ("attn", "attn_dense"):
            if cfg.attention == "mla":
                m = cfg.mla
                total += 2.0 * B * filled * (m.kv_lora_rank
                                             + m.qk_rope_head_dim)
            else:
                slots = M.attention_cache_cap(cfg, filled)
                total += 2.0 * 2 * B * slots * kv * hd
            if cfg.cross_attention:
                total += 2.0 * 2 * B * cfg.cross_seq * kv * hd
        else:
            state = M._cache_layer(cfg, kind, B, 1, "meta")
            total += 2.0 * sum(t.numel() * t.element_size()
                               for t in state.values())
    return total


def decode_step_bound_ms(cfg, B: int, filled: int, card: str) -> float:
    """The roofline of one decode step (``launch/roofline.Roofline``):
    ``model_flops_for``'s 2 N FLOPs a token at the model dtype's peak, and
    ``step_bytes`` at the card's HBM rate; the larger, in ms."""
    from repro_torch.configs.arch import ShapeConfig
    from repro_torch.launch.roofline import (Roofline, dtype_peak_flops,
                                             model_flops_for)
    shape = ShapeConfig("decode", filled, B, "decode")
    return 1e3 * Roofline(flops=model_flops_for(cfg, shape),
                          hbm_bytes=step_bytes(cfg, B, filled),
                          peak_flops=dtype_peak_flops(cfg.dtype, card)
                          ).step_time


def scan_agreement(cfg, chunk: int, prompt: int, dev, tag: str) -> dict:
    """xLSTM's chunkwise mLSTM scan (``chunk``) against its per-step scan:
    one prefill of each at ``SCAN_BLOCKS`` blocks, batch 4, random weights
    from seed 0, in bf16 and with the same draws in fp32. The scans are one
    function in exact arithmetic; in fp32 they are held at 2e-2 x
    max|logits|. In bf16 the distance is printed, not held: a block's two
    scans round some outputs one bf16 ulp apart, and these random weights
    amplify that over the blocks (PERF.md, PR 19)."""
    import torch
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import make_prefill_step
    from repro_torch.parallel.sharding import ParallelConfig
    toks = torch.randint(0, cfg.vocab_size, (SERVE_B, prompt),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    dist = {}
    for dtype in ("bfloat16", "float32"):
        small = cfg.replace(num_layers=SCAN_BLOCKS, dtype=dtype)
        sp = P.init_params(small, torch.Generator(device=dev).manual_seed(0),
                           dev)
        outs = {}
        for c in (chunk, 0):
            t0 = time.perf_counter()
            outs[c] = make_prefill_step(
                small, ParallelConfig(mlstm_chunk=c), cache_cap=prompt)(
                    sp, {"tokens": toks})[0].float().cpu()
            torch.cuda.synchronize(dev)
            log(f"{tag}: prefill at {SCAN_BLOCKS} blocks in {dtype}, "
                f"mlstm_chunk {c}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        a, b = outs[chunk], outs[0]
        dist[dtype] = float((a - b).abs().max()) / float(b.abs().max())
        del sp
    log(f"{tag}: chunkwise against per-step mLSTM scan at {SCAN_BLOCKS} "
        f"blocks: max|err| / max|logits| fp32 {dist['float32']:.3e} (limit "
        f"2e-2), bf16 {dist['bfloat16']:.3e} (printed)")
    if dist["float32"] > 2e-2:
        fail(f"the two mLSTM scans disagree in fp32 ({dist['float32']:.3e})")
    return {"scans_fp32": dist["float32"], "scans_bf16": dist["bfloat16"]}


def serve_last_family(name: str, layers, prompt: int, steps: int, pkw,
                      sdir: str, dev, card: str) -> dict:
    """Phase 13, one model: DecodeServer at full width (depth cut to
    ``layers`` where given) with ``KernelConfig(use_flash, use_decode)``,
    blocks from the store by the server's rule, random bf16 weights from
    seed 0; a cold prefill, the timed prefill and ``steps`` graph replays,
    the counts set to 0 before each and read after. Checks, each failing
    the phase: the reference's dispatch (``LAST_LAUNCHES``, and which plain
    core each attention layer runs); every kernel call within 2^-7 x
    max|plain| of its plain version on its own inputs; the served logits
    against the plain attention path, teacher-forced, at 2e-2 x
    max|logits| per step (else the rule of PERF.md section 6: a dense
    model against its fp32 self, an MoE model by its routing); graph
    replays against the eager step on the same state, bit for bit; the
    recurrent state carried (prefill then one graph step against one
    prefill of the prompt and that token, plain attention, batch 1, no
    expert capacity drop, the per-step mLSTM scan); xlstm's two mLSTM
    scans (``scan_agreement``). Then the kernels at
    its shapes (``family_cases``), and the model is freed."""
    import gc
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.launch.roofline import bound_ms
    from repro_torch.models import params as P
    from repro_torch.models.model import attention_cache_cap
    from repro_torch.models.stepfn import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import ParallelConfig
    full = get_arch(name)
    cfg = full if layers is None else full.replace(num_layers=layers)
    tag = f"[13] {name}" + ("" if layers is None else
                           f" ({layers} of {full.num_layers} layers)")
    cap = prompt + steps
    parity = min(PARITY_STEPS, steps)
    paths = serve.kernel_paths(cfg)
    kc = serve.serving_kernel_config(cfg, device=dev, prompt_len=prompt,
                                     cache_cap=cap, store=sdir, batch=SERVE_B,
                                     log=log)
    pcfg = ParallelConfig(kernel=kc, **pkw)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with Probe() as probe:
        t0 = time.perf_counter()
        server = serve.DecodeServer(
            cfg, pcfg, batch=SERVE_B, prompt_len=prompt, decode_steps=steps,
            seed=0, device=dev, keep_logits=parity)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for _, t in P.leaves(server.params))
        batch = server.input_batch()
        cold_s = server.prefill_batch(batch)
        before = dict(probe.plain)
        serve.reset_kernel_launches()
        prefill_s = server.prefill_batch(batch)
        n_prefill = serve.kernel_launches()
        plain_prefill = {k: v - before[k] for k, v in probe.plain.items()}
        before = dict(probe.plain)
        serve.reset_kernel_launches()
        step_s = [server.decode_step() for _ in range(steps)]
        n_decode = serve.kernel_launches()
        plain_decode = {k: v - before[k] for k, v in probe.plain.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    med = statistics.median(step_s)
    bound = decode_step_bound_ms(cfg, SERVE_B, prompt + steps // 2, card)
    log(f"{tag}: {n_params:,} parameters (bf16, {2 * n_params / 1e9:.2f} GB)"
        f" initialised in {init_s:.3f} s; {pkw or 'default knobs'}; "
        f"kernels reached {sorted(paths)}, blocks {kc}")
    log(f"{tag}: prefill {SERVE_B} x {prompt}: {prefill_s * 1e3:.3f} ms "
        f"(first call {cold_s * 1e3:.3f} ms; {server.prefill_dispatch}); "
        f"decode {steps} steps: median {med * 1e3:.4f} ms/step (min "
        f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f}), "
        f"{SERVE_B / med:.1f} tokens/s ({server.decode_dispatch}); byte "
        f"bound of a step {bound:.4f} ms ({med * 1e3 / bound:.2f}x); peak "
        f"memory {peak / 2 ** 30:.3f} GiB ({smi_line()})")
    log(f"{tag}: launches, the timed prefill {n_prefill}, the {steps} "
        f"steps and the capture's warm-up {n_decode}; plain attention cores, "
        f"prefill {plain_prefill}, decode {plain_decode}")
    fused = kc.decode_combine == "kernel"
    per_prefill, per_step = LAST_LAUNCHES[name]
    n_dec = per_step * (steps + server.captures)
    want = ({"flash_attention": per_prefill, "flash_decode_split": 0,
             "flash_decode_combine": 0},
            {"flash_attention": 0, "flash_decode_split": n_dec,
             "flash_decode_combine": n_dec * fused})
    n_attn = sum(k.startswith("attn") for k in P.layer_kinds(cfg))
    core = ("_flash_attention" if prompt >= pcfg.flash_threshold
            else "_direct_attention")
    want_plain = dict.fromkeys(probe.plain, 0)
    if "flash" not in paths:
        want_plain[core] = n_attn
    if (server.captures != 1 or (n_prefill, n_decode) != want
            or plain_prefill != want_plain or any(plain_decode.values())):
        fail(f"{name}: {server.captures} captures, launches {n_prefill} and "
             f"{n_decode} (want {want}), plain cores {plain_prefill} and "
             f"{plain_decode} (want {want_plain} and none)")
    if not all(bool(torch.isfinite(x).all()) for x in server.kept) or \
            torch.stack(server.out, 1).shape != (SERVE_B, steps + 1):
        fail(f"{name}: served tokens or logits malformed")
    log(f"{tag}: dispatch is the reference's: {per_prefill} flash launches a "
        f"prefill, {per_step} decode launches a step; {n_attn} attention "
        f"layers on {'the kernels' if paths else core}")

    moe = cfg.moe is not None

    def forced(run_cfg, params, pc, record=False):
        """Prefill + ``parity`` decode steps teacher-forced on the served
        tokens, eager, under a Probe: (logits per step, probe). Frame
        embeddings and conditioning go in the run's dtype."""
        dt = P.DTYPES[run_cfg.dtype]
        run_batch = {k: (v.to(dt) if v.is_floating_point() else v)
                     for k, v in batch.items()}
        with Probe(check=pc.kernel is not None, record=record) as pr:
            logits, cache = make_prefill_step(run_cfg, pc, cache_cap=cap)(
                params, run_batch)
            out = [logits.float().cpu()]
            decode = make_decode_step(run_cfg, pc)
            for i in range(parity):
                logits, cache = decode(params, cache, serve.step_batch(
                    run_cfg, params, server.out[i]), prompt + i)
                out.append(logits.float().cpu())
            del cache, logits
        return out, pr

    def dist(a_steps, b_steps):
        return [float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(a_steps, b_steps)]

    plain_pc = ParallelConfig(**pkw)
    plain, pr_plain = forced(cfg, server.params, plain_pc, record=moe)
    rel = dist(server.kept, plain)
    log(f"{tag}: served vs plain attention path, prefill + {parity} "
        f"teacher-forced steps: max|err| / max|logits| per step "
        f"{[round(x, 5) for x in rel]} (limit 2e-2)")
    result = {"cfg": cfg, "kc": kc, "prefill_ms": prefill_s * 1e3,
              "step_ms": med * 1e3, "tokens_s": SERVE_B / med, "peak": peak,
              "parity": max(rel), "params": n_params, "bound_ms": bound,
              "launches": {k: n_prefill[k] + n_decode[k] for k in n_prefill}}
    if paths:
        k_out, kr = forced(cfg, server.params, pcfg, record=moe)
        n_calls = per_prefill + per_step * parity
        log(f"{tag}: each kernel call against its plain version on its "
            f"inputs: max|err| / max|plain| {kr.core_err:.3e} over "
            f"{kr.core_calls} calls (limit 2^-7)")
        if kr.core_calls < n_calls or kr.core_err > 2.0 ** -7:
            fail(f"{name}: a kernel call disagrees with its plain version "
                 f"({kr.core_err:.3e} over {kr.core_calls} calls, want "
                 f"{n_calls})")
        result["core_err"] = kr.core_err
        del k_out
    if max(rel) > 2e-2 and moe:
        # the MoE rule (PERF.md section 6): routing must differ, and the
        # rows whose routing agreed in every layer hold the limit
        kr_routes = forced(cfg, server.params, pcfg, record=True)[1].routes
        share, _, agree = routing_flips(kr_routes, pr_plain.routes, SERVE_B,
                                        prompt)
        n_moe = len(kr_routes) // (parity + 1)
        worst = 0.0
        for i in range(parity + 1):
            ok = agree[(i + 1) * n_moe - 1]
            if bool(ok.any()):
                worst = max(worst, dist([server.kept[i][ok]],
                                        [plain[i][ok]])[0])
        log(f"{tag}: {100 * share:.3f}% of top-k choices differ; rows whose "
            f"routing agreed: max|err| / max|logits| {worst:.3e}")
        if share == 0 or worst > 2e-2:
            fail(f"{name}: logits {max(rel):.3e} x max|logits| from the "
                 "plain path")
    elif max(rel) > 2e-2:
        p32 = P.map_tree(lambda t: t.float(), server.params)
        f32 = forced(cfg.replace(dtype="float32"), p32, plain_pc)[0]
        del p32
        d_served, d_plain = max(dist(server.kept, f32)), max(dist(plain,
                                                                  f32))
        log(f"{tag}: the 2e-2 limit is missed; against the same weights in "
            f"fp32: served {d_served:.5f}, plain bf16 path {d_plain:.5f} "
            f"(+ {FP32_MARGIN:g} allowed)")
        if d_served > d_plain + FP32_MARGIN:
            fail(f"{name}: served logits {d_served:.5f} of max|logits| from "
                 f"the fp32 model, the plain path {d_plain:.5f}")
        result.update(fp32_served=d_served, fp32_plain=d_plain)
    del plain, pr_plain

    # graph replays against the eager step on the same state, bit for bit
    server.keep_logits = GRAPH_STEPS
    server.prefill_batch(batch)
    same, worst = 0, 0.0
    for _ in range(GRAPH_STEPS):
        with torch.inference_mode():
            saved = [{k: t.clone() for k, t in layer.items()}
                     for layer in server.cache]
            server._tokens.copy_(server.toks[:, None])
            server._pos.fill_(server.pos)
            eager, _ = server.decode(server.params, server.cache,
                                     server._step_batch(), server._pos)
            eager = eager.float().cpu()
            for layer, old in zip(server.cache, saved):
                for k, t in layer.items():
                    t.copy_(old[k])
            del saved
        server.decode_step()
        same += int(torch.equal(server.kept[-1], eager))
        worst = max(worst, dist([server.kept[-1]], [eager])[0])
    log(f"{tag}: graph replay vs eager step on the same state, "
        f"{GRAPH_STEPS} steps: bit for bit equal at {same} of {GRAPH_STEPS} "
        f"(max|err| / max|logits| {worst:.3e})")
    if same != GRAPH_STEPS:
        fail(f"{name}: graph replays differ from the eager step")

    # the recurrent state carried: prefill then one graph step, against
    # one prefill of the prompt and that token; plain attention (the
    # blockwise attention needs whole KV blocks: the longer prefill takes
    # the materialized scores), batch 1, for MoE a capacity that drops no
    # expert copy, and the per-step mLSTM scan on both sides (a prompt and
    # the prompt + 1 cannot both be whole chunks; random bf16 weights
    # amplify the two scans' one-ulp differences far past 2e-2, see the
    # scans below), so that both sides compute the same function
    carry = dict(pkw)
    if moe:
        carry["capacity_factor"] = cfg.moe.num_experts / cfg.moe.top_k
    if "mlstm_chunk" in carry:
        carry["mlstm_chunk"] = 0

    def carried(run_cfg, params):
        one = serve.DecodeServer(run_cfg, ParallelConfig(**carry), batch=1,
                                 prompt_len=prompt, decode_steps=1, seed=0,
                                 device=dev, params=params, keep_logits=1)
        b1 = one.input_batch()
        one.prefill_batch(b1)
        one.decode_step()
        if one.captures != 1:
            fail(f"{name}: the state-carry server captured no graph")
        nxt = serve.step_batch(run_cfg, params, one.out[0])
        longer = {k: (torch.cat([v, nxt[k]], dim=1) if k in nxt else v)
                  for k, v in b1.items()}
        pc_long = ParallelConfig(**{**carry, "flash_threshold": 1 << 30})
        want_l, _ = make_prefill_step(run_cfg, pc_long, cache_cap=prompt + 2)(
            params, longer)
        return dist([one.kept[1]], [want_l.float().cpu()])[0]

    result["carried"] = d = carried(cfg, server.params)
    log(f"{tag}: state carried: prefill of {prompt} then one graph step "
        f"against one prefill of {prompt + 1}: max|err| / max|logits| "
        f"{d:.3e} (limit 2e-2)")
    if d > 2e-2 and not moe:
        # the two sides run other GEMM shapes (one row against 1,025), so
        # their bf16 roundings differ, and random weights amplify that (the
        # rule of PERF.md section 6): held again with the weights in fp32,
        # where a state rebound instead of written moves the logits by O(1)
        p32 = P.map_tree(lambda t: t.float(), server.params)
        result["carried_fp32"] = d = carried(cfg.replace(dtype="float32"),
                                             p32)
        del p32
        log(f"{tag}: state carried, the same weights in fp32: max|err| / "
            f"max|logits| {d:.3e} (limit 2e-2)")
    if d > 2e-2:
        fail(f"{name}: the decode step's state is not the prefill's "
             f"({d:.3e})")

    server.keep_logits = 0
    profile_window(lambda: server.prefill_batch(batch),
                   f"{name}: a prefill", top=10)
    profile_window(lambda: [server.decode_step()
                            for _ in range(PROFILE_STEPS)],
                   f"{name}: {PROFILE_STEPS} decode steps", top=10)
    del server, batch
    gc.collect()
    torch.cuda.empty_cache()

    if name.startswith("xlstm"):
        result.update(scan_agreement(cfg, pkw["mlstm_chunk"], prompt, dev,
                                     tag))
        gc.collect()
        torch.cuda.empty_cache()

    cases = family_cases(
        cfg, kc, dev, card, prompt=prompt,
        cap=attention_cache_cap(cfg, cap), window=cfg.local_window,
        cur=(prompt + steps // 2 if cfg.local_window else None), paths=paths)
    times = {}
    for kname, (label, *fns, kbound, by, err) in cases.items():
        ev = [timed(event_ms, f, f"{tag} {kname} events") for f in fns]
        dv = [timed(device_ms, f, f"{tag} {kname} device") for f in fns]
        k_ms, p_ms, l_ms = (e if d is None else d for d, e in zip(dv, ev))
        log(f"{tag} {label}: kernel {k_ms:.4f} ms (events {ev[0]:.4f}), "
            f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound "
            f"{kbound:.6f} ms ({by}); kernel / library {k_ms / l_ms:.3f}; "
            f"max|err| {err:.3e}")
        times[kname] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": kbound, "bound_by": by,
                        "max_abs_err": err}
    result["kernels"] = times
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    return result


# -- phase 14 ------------------------------------------------------------------


def _loss_and_grads(cfg, params, batch, pcfg):
    """(loss, {path: grad}) of one train step's loss, no optimizer."""
    import torch
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import loss_fn
    views = P.trainable(params)
    loss, _ = loss_fn(views, batch, cfg=cfg, pcfg=pcfg)
    flat = list(P.leaves(views))
    grads = torch.autograd.grad(loss, [t for _, t in flat],
                                materialize_grads=True)
    return loss.detach(), {path: g for (path, _), g in zip(flat, grads)}


def train_card_vs_cpu(dev) -> None:
    """Phase 14(a): one train step's loss and gradients of gemma-2b at full
    width, cut to TRAIN_CHECK_LAYERS layers, in fp32 (TF32 off), the same
    weights and batch on the card and on the CPU."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import params as P
    from repro_torch.parallel.sharding import ParallelConfig
    t0 = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH).replace(num_layers=TRAIN_CHECK_LAYERS,
                                       dtype="float32")
    B, S = TRAIN_CHECK_SHAPE
    tokens = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B)).batch(0)["tokens"]
    pcfg = ParallelConfig(**TRAIN_PCFG)
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu_batch = {"tokens": torch.from_numpy(tokens).long()}
    cpu_loss, cpu_g = _loss_and_grads(cfg, params, cpu_batch, pcfg)
    cpu_s = time.perf_counter() - t0
    params = P.map_tree(lambda t: t.to(dev), params)
    loss, grads = _loss_and_grads(cfg, params, {"tokens": cpu_batch[
        "tokens"].to(dev)}, pcfg)
    rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    worst, worst_path = 0.0, None
    for path, g in grads.items():
        want = cpu_g[path]
        ratio = float((g.cpu() - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if ratio > worst:
            worst, worst_path = ratio, path
    log(f"[14a] {cfg.name} at {TRAIN_CHECK_LAYERS} layers, fp32, B {B} x S "
        f"{S}: loss card {float(loss):.7f}, cpu {float(cpu_loss):.7f} "
        f"(rel {rel:.2e}, limit {TRAIN_LOSS_RTOL}); worst grad leaf "
        f"{worst_path}: max|d| / max|g| {worst:.2e} (limit "
        f"{TRAIN_GRAD_RTOL}) over {len(grads)} leaves; cpu {cpu_s:.1f} s, "
        f"all {time.perf_counter() - t0:.1f} s")
    if not rel <= TRAIN_LOSS_RTOL:
        fail(f"train step loss on the card {float(loss)} vs cpu "
             f"{float(cpu_loss)}: rel {rel:.2e}")
    if not worst <= TRAIN_GRAD_RTOL:
        fail(f"train step gradient {worst_path} on the card vs cpu: "
             f"max|d| / max|g| {worst:.2e}")


def _train_loop(cfg, pcfg, steps: int, dev, mesh=None, shape=None):
    """TrainLoop on ``cfg`` over the synthetic source at ``shape`` (B, S)
    (TRAIN_SHAPE unless given), the launcher's peak LR, no checkpoint
    directory, on ``mesh`` if given."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.train import LoopConfig, TrainLoop
    B, S = shape or TRAIN_SHAPE
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    lc = LoopConfig(steps=steps, log_every=0, peak_lr=TRAIN_PEAK_LR)
    return TrainLoop(cfg, dc, lc, pcfg=pcfg, device=dev, mesh=mesh)


def train_step_bounds(cfg, card: str):
    """(operations bound ms, optimizer byte bound ms, FLOP, bytes) of one
    train step at TRAIN_SHAPE: ``model_flops_for``'s 6 x parameters x
    tokens (forward and backward of every product, the tied head's
    included) plus the materialized attention (QK^T and PV, forward and
    twice backward) at the model dtype's peak (``launch/roofline``); AdamW
    reads a bf16 weight and gradient and two fp32 moments and writes the
    weight and moments, 22 bytes a parameter, at the card's HBM rate."""
    from repro_torch.configs.arch import ShapeConfig
    from repro_torch.launch.roofline import (Roofline, dtype_peak_flops,
                                             model_flops_for)
    from repro_torch.models.params import count_params
    B, S = TRAIN_SHAPE
    attn = 3 * 2 * 2 * B * cfg.num_heads * S * S * cfg.resolved_head_dim
    flops = (model_flops_for(cfg, ShapeConfig("train", S, B, "train"))
             + attn * cfg.num_layers)
    opt_bytes = 22.0 * count_params(cfg)
    peak = dtype_peak_flops(cfg.dtype, card)
    return (1e3 * Roofline(flops=flops, hbm_bytes=0.0,
                           peak_flops=peak).step_time,
            1e3 * Roofline(flops=0.0, hbm_bytes=opt_bytes,
                           peak_flops=peak).step_time, flops, opt_bytes)


def _step_in_parts(loop, run) -> None:
    """One more step of ``loop`` as its three parts, each handed to
    ``run(name, fn)``: forward (the loss), backward (the gradients),
    optimizer (AdamW in place)."""
    import torch
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import loss_fn
    batch = loop._to_device(next(loop.data))
    held = {}

    def forward():
        held["views"] = P.trainable(loop.params)
        held["loss"], _ = loss_fn(held["views"], batch, cfg=loop.arch,
                                  pcfg=loop.pcfg)

    def backward():
        flat = list(P.leaves(held.pop("views")))
        grads = torch.autograd.grad(held.pop("loss"), [t for _, t in flat])
        held["grads"] = P.map_tree_paths(loop.params, {
            p: g for (p, _), g in zip(flat, grads)})

    def optimizer():
        loop.optimizer.update(held.pop("grads"), loop.opt_state, loop.params)

    for name, fn in (("forward", forward), ("backward", backward),
                     ("optimizer", optimizer)):
        run(name, fn)


def profile_train_step(loop) -> dict:
    """Two more steps of ``loop`` in parts: the first with CUDA events
    around each part (profiler off), the second under torch.profiler, one
    window a part. Returns {part: ms} of the first."""
    import torch
    parts = {}

    def timed(name, fn):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        parts[name] = t0.elapsed_time(t1)

    _step_in_parts(loop, timed)
    _step_in_parts(loop, lambda name, fn: profile_window(
        fn, f"the train step's {name}", top=6, tag="[14b]"))
    return parts


def train_on_card(dev, card: str) -> dict:
    """Phase 14: training on the card. (a) card against CPU at 2 layers in
    fp32; (b) TrainLoop on gemma-2b at full width and depth in bf16 with
    the loop's parallel defaults, its time beside the two bounds, peak
    memory, losses, one profiled step; (c) the same first step with
    remat="full"; (d) the restart drill at the smoke size; (e) the
    refusals of a kernel without a backward."""
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.registry import get_arch, smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import matern_gp as kgp
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import make_train_step
    from repro_torch.optim.optimizers import AdamW, constant_lr
    from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
    from repro_torch.runtime.train import (LoopConfig, TrainLoop,
                                           run_with_restarts)
    gc.collect()
    torch.cuda.empty_cache()
    out = {}

    # (a) the card against the CPU
    train_card_vs_cpu(dev)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the slice at full width: the kernel counts must stay at 0 (the
    # training path reaches none of the kernels)
    cfg = get_arch(TRAIN_ARCH)
    pcfg = ParallelConfig(**TRAIN_PCFG)
    kg.launches = kgp.launches = kfa.launches = kfd.split_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        loop = _train_loop(cfg, pcfg, TRAIN_STEPS, dev)
        met = loop.run()
    except torch.cuda.OutOfMemoryError as e:
        log(f"[14b] the loop's defaults do not fit on the card ({e}); "
            "rerun with remat=\"full\"")
        loop = None
        gc.collect()
        torch.cuda.empty_cache()
        pcfg = pcfg.replace(remat="full")
        torch.cuda.reset_peak_memory_stats(dev)
        loop = _train_loop(cfg, pcfg, TRAIN_STEPS, dev)
        met = loop.run()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    counts = (kg.launches, kgp.launches, kfa.launches, kfd.split_launches)
    if any(counts):
        fail(f"the train loop launched kernels (gemm, gp, flash, decode) "
             f"{counts}: the training path reaches none")
    B, S = TRAIN_SHAPE
    step_ms = 1e3 * statistics.median(met.step_times[2:])
    ops_ms, opt_ms, flops, opt_bytes = train_step_bounds(cfg, card)
    n = P.count_params(cfg)
    losses = met.losses
    log(f"[14b] {cfg.name}: {n:,} parameters, {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.dtype} weights, fp32 AdamW moments; "
        f"remat {pcfg.remat!r}, logits_chunk {pcfg.logits_chunk}, "
        f"materialized attention; B {B} x S {S}, {TRAIN_STEPS} steps in "
        f"{run_s:.1f} s (weights from the seed included)")
    log(f"[14b] step {step_ms:.3f} ms (median of steps 2-{TRAIN_STEPS - 1}; "
        f"each {[round(1e3 * t, 3) for t in met.step_times]} ms), "
        f"{B * S / step_ms * 1e3:,.0f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; losses step 0 {losses[0]:.4f}, 1 "
        f"{losses[1]:.4f}, {TRAIN_STEPS - 2} {losses[-2]:.4f}, "
        f"{TRAIN_STEPS - 1} {losses[-1]:.4f} (ln V = "
        f"{math.log(cfg.vocab_size):.4f})")
    log(f"[14b] bounds on {card}: operations {flops / 1e12:.2f} TFLOP -> "
        f"{ops_ms:.3f} ms at the bf16 peak; the optimizer's bytes "
        f"{opt_bytes / 1e9:.2f} GB -> {opt_ms:.3f} ms; the step at "
        f"{ops_ms / step_ms:.3f} of the operations bound; no kernel of the "
        f"port launched (counts {counts})")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train losses {losses}")
    if not (statistics.mean(losses[-2:]) < statistics.mean(losses[:2])):
        fail(f"train loss did not fall: {losses}")
    parts = profile_train_step(loop)
    log(f"[14b] one step in parts (CUDA events around each, profiler off): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()))
    out.update(step_ms=step_ms, peak=peak, losses=losses, pcfg=pcfg)
    loop = met = None
    gc.collect()
    torch.cuda.empty_cache()

    # (c) remat changes memory, not the function
    torch.cuda.reset_peak_memory_stats(dev)
    full = _train_loop(cfg, ParallelConfig(**{**TRAIN_PCFG, "remat": "full"}),
                       1, dev)
    loss_full = full.run().losses[0]
    peak_full = torch.cuda.max_memory_allocated(dev)
    rel = abs(loss_full - losses[0]) / abs(losses[0])
    log(f"[14c] remat=\"full\", step 0 on the same weights and batch: loss "
        f"{loss_full:.6f} against {losses[0]:.6f} (rel {rel:.2e}, limit "
        f"{REMAT_RTOL}); peak memory {peak_full / 2**30:.2f} GiB against "
        f"{peak / 2**30:.2f} GiB with remat {pcfg.remat!r}")
    if not rel <= REMAT_RTOL:
        fail(f"remat full changed step 0's loss: {loss_full} vs {losses[0]}")
    full = None
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the restart drill on the card
    smoke = smoke_config(RESTART_ARCH)
    dc = DataConfig(vocab_size=smoke.vocab_size, seq_len=32, global_batch=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        def make_loop(attempt):
            lc = LoopConfig(steps=14, ckpt_every=5, ckpt_dir=d, log_every=0,
                            fail_at_step=8 if attempt == 0 else None)
            return TrainLoop(smoke, dc, lc, device=dev)
        drill = run_with_restarts(make_loop, max_restarts=2)
        meta = ckpt.load_manifest(ckpt.latest(d))
        want_leaves = len(list(P.leaves(make_loop(1)._state_tree())))
    log(f"[14d] restart drill ({smoke.name}, ckpt every 5, failure at step "
        f"8): resumed at step {drill.start_step} from "
        f"{os.path.basename(drill.restored_from or '')}, "
        f"{len(drill.losses)} steps after it; last manifest: step "
        f"{meta['step']}, {meta['n_leaves']} leaves, dtypes "
        f"{sorted(set(meta['dtypes']))}, extras {meta['extras']}")
    if (drill.start_step != 5 or drill.start_step + len(drill.losses) != 14
            or meta["step"] != 14 or meta["n_leaves"] != want_leaves):
        fail(f"restart drill: start {drill.start_step}, "
             f"{len(drill.losses)} steps, manifest {meta}")

    # (e) the refusals: no kernel has a backward
    refused = []
    try:
        make_train_step(cfg, ParallelConfig(kernel=KernelConfig(
            use_flash=True)), AdamW(schedule=constant_lr(1e-3)))
    except ValueError as e:
        refused.append(str(e))
    q = torch.randn(1, 128, 2, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k, v = (torch.randn(1, 128, 2, 64, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    kfa.launches = 0
    try:
        kfa.flash_attention(q, k, v, block_q=64, block_kv=64)
    except ValueError as e:
        refused.append(str(e))
    with torch.no_grad():
        kfa.flash_attention(q, k, v, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    log(f"[14e] refused: {refused}; under no_grad the wrapper launched "
        f"{kfa.launches} time(s)")
    if len(refused) != 2 or kfa.launches != 1:
        fail(f"the refusals: {refused}, launches {kfa.launches}")
    return out


# -- phase 15 ------------------------------------------------------------------


def _real_step(fn, dev):
    """(peak bytes allocated during ``fn()`` above what was allocated
    before it, ms of the call by CUDA events)."""
    import torch
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return torch.cuda.max_memory_allocated(dev) - base, t0.elapsed_time(t1)


def _dry_vs_card(tag, cfg, shape, pcfg, args, step, dev, card, time_reps):
    """Phase 15(a) for one cell: the meta trace's arguments, FLOPs and
    peak against the same step run on the card on ``args`` (which hold
    the cell's real inputs), and its roofline beside the step's time."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import (Roofline, dtype_peak_flops,
                                             model_flops_for)
    t0 = time.perf_counter()
    m = dryrun.measure(cfg, shape, pcfg)
    trace_s = time.perf_counter() - t0
    roof = Roofline(flops=float(m["flops"]), hbm_bytes=float(m["bytes"]),
                    model_flops=model_flops_for(cfg, shape),
                    peak_flops=dtype_peak_flops(cfg.dtype, card))
    real_args = dryrun.storage_bytes(args)
    temp, first_ms = _real_step(lambda: step(*args), dev)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize(dev)
    real_flops = fc.get_total_flops()
    times = [_real_step(lambda: step(*args), dev)[1]
             for _ in range(time_reps)]
    med = statistics.median(times)
    dry_peak, real_peak = m["args"] + m["temp"], real_args + temp
    rel = abs(dry_peak - real_peak) / real_peak
    log(f"[15a] {tag}: arguments dry {m['args']:,} B, card {real_args:,} B; "
        f"FLOPs dry {m['flops']:,}, card {real_flops:,} (FlopCounterMode on "
        f"the card's step); peak dry {dry_peak / 2**30:.3f} GiB (arguments + "
        f"{m['temp'] / 2**30:.3f} GiB temps), card {real_peak / 2**30:.3f} "
        f"GiB (arguments + max_memory_allocated above them), off by "
        f"{rel:.2%} (limit {DRY_PEAK_RTOL:.0%}); trace {trace_s:.2f} s, "
        f"cuts {[c['block'] for c in m['scaled']]}")
    log(f"[15a] {tag}: step on the card {med:.3f} ms (median of "
        f"{time_reps}; first {first_ms:.3f} ms) against the roofline "
        f"{roof.step_time * 1e3:.3f} ms ({roof.dominant}: compute "
        f"{roof.t_compute * 1e3:.3f} ms, memory {roof.t_memory * 1e3:.3f} ms "
        f"over {m['bytes'] / 1e9:.1f} GB of eager traffic), useful FLOPs "
        f"ratio {roof.useful_flops_ratio:.3f}")
    if m["args"] != real_args:
        fail(f"{tag}: dry-run arguments {m['args']} B, card {real_args} B")
    if m["flops"] != real_flops:
        fail(f"{tag}: dry-run FLOPs {m['flops']}, card {real_flops}")
    if not rel <= DRY_PEAK_RTOL:
        fail(f"{tag}: dry-run peak {dry_peak} B, card {real_peak} B")
    return {"step_ms": med, "roof_ms": roof.step_time * 1e3,
            "peak": real_peak, "dry_peak": dry_peak}


def dryrun_on_card(dev, card: str, sdir: str) -> None:
    """Phase 15: the dry-run tooling (meta-tensor traces, no kernel) held
    against the card. (a) phase 14's train cell and phase 8's decode cell
    traced and run; (b) every arch x shape cell for the card; (c) BO over
    the sharding cells' objective, journaled into the phase-3 store and
    resolved back; (d) gradient compression on CUDA tensors."""
    import torch
    from repro_torch.configs.arch import SHAPES, ShapeConfig
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.strategies import make_strategy
    from repro_torch.core.tuning_targets import DryRunObjective
    from repro_torch.kernels import tuning
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.retune import dryrun_objective_for
    from repro_torch.launch.roofline import card_memory
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import make_decode_step, make_train_step
    from repro_torch.optim.optimizers import AdamW, constant_lr
    from repro_torch.parallel import compression as C
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.store.resolve import apply_sharding_config
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"[15] {card}: total_memory {total:,} B, launch/roofline.py "
        f"CARD_MEMORY {card_memory(card):,} B")
    if total != card_memory(card):
        fail(f"CARD_MEMORY says {card_memory(card)} B, the card {total} B")

    # (a) the trace against the card: phase 14's cell, then phase 8's
    t0 = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    B, S = TRAIN_SHAPE
    pcfg = ParallelConfig(**TRAIN_PCFG)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = P.init_params(cfg, gen, dev)
    opt = AdamW(schedule=constant_lr(TRAIN_PEAK_LR),
                moment_dtype=pcfg.opt_moment_dtype)
    state = opt.init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                     generator=gen)}
    train = _dry_vs_card(
        f"{cfg.name} train B {B} x S {S} (remat none)", cfg,
        ShapeConfig("train", S, B, "train"), pcfg,
        (params, state, batch, 0), make_train_step(cfg, pcfg, opt), dev,
        card, time_reps=3)
    state = batch = None
    cap = SERVE_PROMPT + SERVE_STEPS
    cache = M.init_cache(cfg, SERVE_B, cap, device=dev)
    dry_cache = dryrun.storage_bytes(M.abstract_cache(cfg, SERVE_B, cap))
    real_cache = dryrun.storage_bytes(cache)
    log(f"[15a] {cfg.name} decode cache B {SERVE_B} x {cap}: dry "
        f"{dry_cache:,} B, card {real_cache:,} B")
    if dry_cache != real_cache:
        fail(f"decode cache: dry {dry_cache} B, card {real_cache} B")
    toks = torch.randint(0, cfg.vocab_size, (SERVE_B, 1), device=dev,
                         generator=gen)
    pos = torch.tensor(SERVE_PROMPT, device=dev)
    decode = _dry_vs_card(
        f"{cfg.name} decode B {SERVE_B}, capacity {cap} (plain attention)",
        cfg, ShapeConfig("decode", cap, SERVE_B, "decode"), ParallelConfig(),
        (params, cache, {"tokens": toks}, pos),
        make_decode_step(cfg, ParallelConfig()), dev, card, time_reps=10)
    params = cache = None
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[15a] done in {time.perf_counter() - t0:.1f} s")

    # (b) every cell of the reference for the card, in worker processes
    t0 = time.perf_counter()
    cells = [(a, s.name) for a in ARCHS for s in SHAPES]
    recs = dryrun.run_cells(cells, card, workers=DRY_WORKERS)
    wall = time.perf_counter() - t0
    for r in recs:
        head = f"[15b] {r['arch']} x {r['shape']}: {r['status']}"
        if r["status"] == "skip":
            log(f"{head} ({r['reason'][:60]})")
            continue
        if r["status"] != "ok":
            fail(f"{r['arch']} x {r['shape']}: {r.get('error')}")
        mem, rf = r["memory"], r["roofline"]
        log(f"{head}; arguments {mem['argument_size_in_bytes'] / 1e9:.2f} GB,"
            f" peak {mem['peak_live_bytes'] / 1e9:.1f} GB against "
            f"{mem['card_bytes'] / 1e9:.1f} GB ({'fits' if r['fits'] else 'does not fit'}); "
            f"{rf['dominant']}, step {rf['step_time']:.4g} s, useful FLOPs "
            f"{rf['useful_flops_ratio']:.3f}; cuts "
            f"{[(c['block'], c.get('repeats', c.get('steps'))) for c in r['scaled']]}; "
            f"trace {r['t_trace_s']:.2f} s")
    ok = [r for r in recs if r["status"] == "ok"]
    log(f"[15b] {len(ok)} cells ok, {len(recs) - len(ok)} skipped, "
        f"{sum(r['fits'] for r in ok)} fit the card; traces "
        f"{sum(r['t_trace_s'] for r in ok):.1f} s in all, {wall:.1f} s of "
        f"wall in {DRY_WORKERS} processes")
    fits = {"cells": len(ok), "fit": sum(r["fits"] for r in ok)}

    # (c) BO through the objective, journaled into the phase-3 store
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    kind = tuning.device_kind(dev)
    for shape in DRY_BO_SHAPES:
        t0 = time.perf_counter()
        obj = DryRunObjective(DRY_BO_ARCH, shape, card=card,
                              cache_dir=cache_dir, verbose=False)
        res = run_strategy(make_strategy("ei"), obj, budget=DRY_BO_BUDGET,
                           seed=0, store=sdir)
        vals = [o.value for o in res.journal]
        valid = [v for v in vals if math.isfinite(v)]
        log(f"[15c] {obj.name}: {obj.space.size} configs, "
            f"{len(vals)} evaluations ({obj.traced} traced, the rest "
            f"sharing a trace), {len(valid)} valid, "
            f"{len(vals) - len(valid)} invalid; best "
            f"{res.best_value:.4g} s at {obj.space.config(res.best_idx) if res.best_idx is not None else None} "
            f"({time.perf_counter() - t0:.1f} s)")
        resolved = serve.resolve_pcfg(ParallelConfig(), sdir, DRY_BO_ARCH,
                                      shape)
        if valid:
            want = apply_sharding_config(
                ParallelConfig(), obj.space.config(res.best_idx),
                log=lambda *a: None)
            if resolved != want:
                fail(f"resolve_pcfg under {kind} gave {resolved}, the best "
                     f"config is {want}")
        elif resolved != ParallelConfig():
            fail(f"{obj.name}: no valid config, yet resolve_pcfg gave "
                 f"{resolved}")
        if dryrun_objective_for(obj.name, device=dev,
                                cache_dir=cache_dir).name != obj.name:
            fail(f"dryrun_objective_for({obj.name!r})")
        try:
            dryrun_objective_for(obj.name.replace(kind, "single"),
                                 device=dev)
            fail("dryrun_objective_for serviced a pod mesh's key")
        except ValueError as e:
            log(f"[15c] {obj.name.replace(kind, 'single')} refused: {e}")
        if shape == DRY_BO_SHAPES[-1] and not (valid and len(valid) < len(vals)):
            fail(f"{obj.name}: want valid and invalid configs, got "
                 f"{len(valid)} valid of {len(vals)}")
    shutil_rmtree(cache_dir)

    # (d) gradient compression on CUDA tensors at world size 1
    g = torch.randn(256, 64, generator=torch.Generator().manual_seed(0))
    r = torch.randn(256, 64, generator=torch.Generator().manual_seed(1)) * .1
    one = C.Reduction.local()
    out = {}
    for where in ("cpu", dev):
        out[str(where)] = {m: C.compress_tree_psum(
            {"w": g.to(where)}, {"w": r.to(where)}, one, m, seed=0,
            k_frac=0.25) for m in ("none", "topk", "int8")}
    cpu, gpu = out["cpu"], out[str(dev)]
    scale = float(g.abs().max())
    int8_d = float((gpu["int8"][0]["w"].cpu() - cpu["int8"][0]["w"]).abs().max())
    same = all(torch.equal(gpu[m][i]["w"].cpu(), cpu[m][i]["w"])
               for m in ("none", "topk") for i in (0, 1))
    log(f"[15d] compression at world size 1: none and topk (values and "
        f"residuals) equal to the CPU's: {same}; int8 card vs CPU max "
        f"|d| {int8_d:.4g} (limit 0.02 x max|g| = {0.02 * scale:.4g})")
    if not same or not int8_d <= 0.02 * scale:
        fail("compression on the card differs from the CPU's")
    return {"train": train, "decode": decode, **fits}


# -- phase 16 ------------------------------------------------------------------


def _launches() -> tuple:
    """The kernel wrappers' launch counts: (gemm, gp, flash, decode)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import matern_gp as kgp
    return kg.launches, kgp.launches, kfa.launches, kfd.split_launches


def _zero_launches() -> None:
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import matern_gp as kgp
    kg.launches = kgp.launches = kfa.launches = kfd.split_launches = 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_on_mesh(dev, card: str, phase14: dict) -> None:
    """Phase 16: gemma-2b's TrainLoop on a device mesh of one rank (an NCCL
    process group of world size 1, ``make_host_mesh(data=1, model=1)``):
    the weights, moments and batches are DTensors, the reference's
    activation constraints placed, at phase 14's cell and parallel
    config, MESH_STEPS steps; its losses held to phase 14's first ones
    (the same seed, data and schedule) by phase 14's bf16 rule
    (REMAT_RTOL), its step time and peak memory beside phase 14's, no
    kernel launched. The process group is destroyed before returning."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from torch.distributed.tensor import DTensor
    gc.collect()
    torch.cuda.empty_cache()
    cfg, pcfg = get_arch(TRAIN_ARCH), phase14["pcfg"]
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(data=1, model=1)
        _zero_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loop = _train_loop(cfg, pcfg, MESH_STEPS, dev, mesh=mesh)
        state = list(P.leaves(loop._state_tree()))
        placed = sum(isinstance(t, DTensor) for _, t in state)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        state = None
        met = loop.run()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        counts = _launches()
        loop = None
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    want = phase14["losses"][:MESH_STEPS]
    rels = [abs(a - b) / abs(b) for a, b in zip(met.losses, want)]
    B, S = TRAIN_SHAPE
    n = len(list(P.leaves(P.model_specs(cfg))))
    log(f"[16] {cfg.name} TrainLoop on a one-rank mesh {shape} (NCCL, "
        f"{placed} DTensor leaves of {3 * n} weights and moments), remat "
        f"{pcfg.remat!r}, B {B} x S "
        f"{S}, {MESH_STEPS} steps in {run_s:.1f} s (weights from the seed "
        f"included); on {card} ({smi_line()})")
    log(f"[16] losses {[round(x, 6) for x in met.losses]} against phase "
        f"14's {[round(x, 6) for x in want]}: rel {[f'{r:.2e}' for r in rels]}"
        f" (limit {REMAT_RTOL}); bit-equal: {met.losses == want}")
    log(f"[16] step times {[round(1e3 * t, 3) for t in met.step_times]} ms "
        f"(the first holds DTensor's first placement plans), phase 14 "
        f"{phase14['step_ms']:.3f} ms/step; peak memory {peak / 2**30:.2f} "
        f"GiB, phase 14 {phase14['peak'] / 2**30:.2f} GiB; kernel launches "
        f"(gemm, gp, flash, decode) {counts}")
    if placed != 3 * n:
        fail(f"the mesh loop placed {placed} of {3 * n} weights and moments "
             "as DTensors")
    if any(counts):
        fail(f"the mesh loop launched kernels {counts}: the training path "
             "reaches none")
    if len(met.losses) != MESH_STEPS or not all(r <= REMAT_RTOL
                                                for r in rels):
        fail(f"the mesh loop's losses {met.losses} against phase 14's "
             f"{want}")


# -- phase 17 ------------------------------------------------------------------


def _xlstm_run(cfg, pcfg, dev, mesh) -> dict:
    """One TrainLoop of MESH_STEPS steps at XLSTM_SHAPE, freed after: its
    losses, step times, peak memory, kernel launches, DTensor leaves and
    seconds (the weights from the seed included)."""
    import torch
    from repro_torch.models import params as P
    from torch.distributed.tensor import DTensor
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    t0 = time.perf_counter()
    loop = _train_loop(cfg, pcfg, MESH_STEPS, dev, mesh=mesh,
                       shape=XLSTM_SHAPE)
    placed = sum(isinstance(t, DTensor)
                 for _, t in P.leaves(loop._state_tree()))
    met = loop.run()
    out = {"losses": met.losses, "step_ms": [1e3 * t for t in met.step_times],
           "peak": (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else float("nan")),
           "launches": _launches(), "placed": placed,
           "s": time.perf_counter() - t0}
    loop = met = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_xlstm_on_mesh(dev, card: str, cfg=None) -> dict:
    """Phase 17: ``cfg`` (xlstm-1.3b whole unless given) through TrainLoop
    at XLSTM_SHAPE with XLSTM_PCFG, MESH_STEPS steps with no mesh and then
    on a one-rank mesh (``make_host_mesh(data=1, model=1)``: NCCL on the
    card, gloo on the CPU), at each of XLSTM_MICROBATCHES: the losses of
    each pair bit for bit, else within REMAT_RTOL; no kernel launched;
    every weight and moment a DTensor on the mesh. Returns {mb: {"off",
    "on"}}. The process group is destroyed before returning."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.parallel.sharding import ParallelConfig
    cfg = cfg or get_arch(XLSTM_ARCH)
    base = ParallelConfig(**XLSTM_PCFG)
    n = 3 * len(list(P.leaves(P.model_specs(cfg))))
    B, S = XLSTM_SHAPE
    log(f"[17] {cfg.name}: {cfg.num_layers} blocks, d {cfg.d_model}, "
        f"{P.count_params(cfg):,} parameters; B {B} x S {S}, mlstm_chunk "
        f"{base.mlstm_chunk}, remat {base.remat!r}, {MESH_STEPS} steps a run; "
        f"on {card} ({smi_line() if dev.type == 'cuda' else 'cpu'})")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    res = {}
    try:
        mesh = make_host_mesh(data=1, model=1, device=dev.type)
        for mb in XLSTM_MICROBATCHES:
            pcfg = dataclasses.replace(base, microbatches=mb)
            res[mb] = {side: _xlstm_run(cfg, pcfg, dev, m)
                       for side, m in (("off", None), ("on", mesh))}
            for side, r in res[mb].items():
                log(f"[17] microbatches {mb}, {side} the mesh: losses "
                    f"{[round(x, 6) for x in r['losses']]}, step ms "
                    f"{[round(t, 3) for t in r['step_ms']]} (the first "
                    "holds the first launches" + (" and DTensor's plans"
                                                   if side == "on" else "")
                    + f"), peak {r['peak'] / 2**30:.2f} GiB, kernel launches "
                    f"(gemm, gp, flash, decode) {r['launches']}, "
                    f"{r['placed']} DTensor leaves of {n}, {r['s']:.1f} s")
    finally:
        dist.destroy_process_group()
    for mb, pair in res.items():
        off, on = pair["off"], pair["on"]
        rels = [abs(a - b) / abs(b) for a, b in zip(on["losses"],
                                                    off["losses"])]
        log(f"[17] microbatches {mb}: on/off the mesh rel "
            f"{[f'{r:.2e}' for r in rels]} (limit {REMAT_RTOL}); bit-equal: "
            f"{on['losses'] == off['losses']}; step ms on/off "
            f"{on['step_ms'][-1] / off['step_ms'][-1]:.3f}")
        if len(on["losses"]) != MESH_STEPS or not all(
                math.isfinite(x) for x in on["losses"] + off["losses"]):
            fail(f"phase 17 at microbatches {mb}: losses {off['losses']} "
                 f"off the mesh, {on['losses']} on it")
        if not all(r <= REMAT_RTOL for r in rels):
            fail(f"phase 17 at microbatches {mb}: the mesh's losses "
                 f"{on['losses']} against {off['losses']} off it")
        if any(off["launches"]) or any(on["launches"]):
            fail(f"phase 17 launched kernels: {off['launches']}, "
                 f"{on['launches']}: the training path reaches none")
        if off["placed"] or on["placed"] != n:
            fail(f"phase 17: {on['placed']} of {n} leaves DTensors on the "
                 f"mesh, {off['placed']} off it")
    first = [res[mb]["off"]["losses"][0] for mb in XLSTM_MICROBATCHES]
    log(f"[17] the first loss at microbatches {XLSTM_MICROBATCHES}: {first}")
    return res


# -- phase 18 ------------------------------------------------------------------


def _in_child(fn, *args):
    """``fn(*args)`` in a spawned process: a fake world of ranks must not
    open in this one, which held NCCL groups (phases 16-17)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        return ex.submit(fn, *args).result()


def dryrun_on_meshes(dev, card: str, phase15: dict) -> dict:
    """Phase 18: the dry-run on the card's production meshes. (a) phase
    14's cell on a 1 x 1 mesh against one card; (b) every arch x shape
    cell on the single and multi meshes; (c) BO over deepseek-v3's
    decode cell on single, journaled under the mesh's id; (d) the cells
    that fit each mesh beside phase 15's one card."""
    from repro_torch.configs.arch import SHAPES
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.strategies import make_strategy
    from repro_torch.core.tuning_targets import DryRunObjective
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import links_for
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.store.resolve import best_sharding_config

    # (a) phase 14's cell on a 1 x 1 mesh against its one-card record
    t0 = time.perf_counter()
    pcfg = ParallelConfig(**TRAIN_PCFG)
    one = dryrun.run_cell(TRAIN_ARCH, "train_1k_b4", card, pcfg)
    mesh = _in_child(dryrun.run_cell, TRAIN_ARCH, "train_1k_b4", card, pcfg,
                     None, {"data": 1, "model": 1})
    if one["status"] != "ok" or mesh["status"] != "ok":
        fail(f"phase 14's cell: {one.get('error')} / {mesh.get('error')}")
    m1, mm = one["memory"], mesh["memory"]
    r1, rm = one["roofline"], mesh["roofline"]
    log(f"[18a] {TRAIN_ARCH} train B {TRAIN_SHAPE[0]} x S {TRAIN_SHAPE[1]}: "
        f"one card arguments {m1['argument_size_in_bytes']:,} B, temps "
        f"{m1['temp_size_in_bytes']:,} B, FLOPs {r1['flops']:,.0f}, bytes "
        f"{r1['hbm_bytes']:,.0f}; on a 1 x 1 mesh "
        f"{mm['argument_size_in_bytes']:,} B, "
        f"{mm['temp_size_in_bytes']:,} B, {rm['flops']:,.0f}, "
        f"{rm['hbm_bytes']:,.0f}, collective bytes {rm['coll_bytes']:,.0f} "
        f"({mesh['t_trace_s']:.1f} s traced); phase 15 measured "
        f"{phase15['train']['peak'] / 2**30:.3f} GiB on the card against "
        f"{phase15['train']['dry_peak'] / 2**30:.3f} dry")
    if mm != m1 or rm["coll_bytes"] or any(
            rm[k] != r1[k] for k in ("flops", "hbm_bytes")):
        fail("a 1 x 1 mesh's record differs from one card's")
    log(f"[18a] done in {time.perf_counter() - t0:.1f} s")

    # (c) BO on the single mesh, each config in a child process, in a
    # thread while (b) sweeps in its worker processes: the two overlap
    def bo_on_single() -> None:
        t0 = time.perf_counter()
        cache_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        store = os.path.join(cache_dir, "store")
        obj = DryRunObjective(MESH_BO_ARCH, MESH_BO_SHAPE, mesh="single",
                              card=card,
                              cache_dir=os.path.join(cache_dir, "c"),
                              verbose=False)
        base = obj.space.config(0)

        def at(**kw):
            want = {**base, **kw}
            return next(i for i in range(obj.space.size)
                        if obj.space.config(i) == want)
        knobs = {"base": obj(at()),
                 "embed_rule none": obj(at(embed_rule="none")),
                 "experts_rule model+data": obj(at(
                     experts_rule="model+data"))}
        log(f"[18c] {obj.name} at {base}: step time s {knobs}")
        b = knobs["base"]
        for k, v in knobs.items():
            moved = math.isnan(v) != math.isnan(b) or (
                not math.isnan(v) and v != b)
            if k != "base" and not moved:
                fail(f"{obj.name}: {k} does not move the value")
        res = run_strategy(make_strategy("ei"), obj, budget=MESH_BO_BUDGET,
                           seed=0, store=store)
        vals = [o.value for o in res.journal]
        valid = [v for v in vals if math.isfinite(v)]
        best = ((obj.space.config(res.best_idx), res.best_value) if valid
                else None)
        log(f"[18c] BO: {obj.space.size} configs, {len(vals)} evaluations "
            f"({obj.traced} traced in child processes), {len(valid)} valid; "
            f"best {best} ({time.perf_counter() - t0:.1f} s)")
        got = best_sharding_config(store, MESH_BO_ARCH, MESH_BO_SHAPE,
                                   mesh=obj.mesh)
        others = [best_sharding_config(store, MESH_BO_ARCH, MESH_BO_SHAPE,
                                       mesh=m)
                  for m in ("single", "multi", obj.mesh.split("-", 1)[1])]
        log(f"[18c] resolved under {obj.mesh}: {got}; under the TPU pods' "
            f"single/multi and one card's id: {others}")
        if got != best or any(o is not None for o in others):
            fail(f"{obj.name}: the store resolved {got} / {others}")
        shutil_rmtree(cache_dir)

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        bo = pool.submit(bo_on_single)
        # (b) every cell on both production meshes, in worker processes
        cells = [(a, s.name) for a in ARCHS for s in SHAPES]
        nvlink, ib = links_for(card)
        fit, default = {}, {}
        for name in ("single", "multi"):
            t0 = time.perf_counter()
            recs = dryrun.run_cells(cells, card, workers=DRY_WORKERS,
                                    mesh=name)
            wall = time.perf_counter() - t0
            for r in recs:
                head = f"[18b] {r['arch']} x {r['shape']} x {name}"
                if r["status"] == "skip":
                    continue
                if r["status"] != "ok":
                    fail(f"{head}: {r.get('error')}")
                mem, rf, ln = r["memory"], r["roofline"], r["links"]
                log(f"{head}: {'fits' if r['fits'] else 'does not fit'}, peak "
                    f"{mem['peak_live_bytes'] / 2**30:.2f} of "
                    f"{mem['card_bytes'] / 2**30:.2f} GiB a card; "
                    f"{rf['dominant']}, step {rf['step_time']:.4g} s (compute "
                    f"{rf['t_compute']:.4g}, memory {rf['t_memory']:.4g}, "
                    f"collective {rf['t_collective']:.4g}); NVLink "
                    f"{ln['nvlink_bytes'] / 1e9:.3f} GB, InfiniBand "
                    f"{ln['ib_bytes'] / 1e9:.3f} GB a card; trace "
                    f"{r['t_trace_s']:.2f} s")
            ok = [r for r in recs if r["status"] == "ok"]
            fit[name] = sum(r["fits"] for r in ok)
            default.update({(r["arch"], r["shape"], name): r for r in ok})
            log(f"[18b] {name} ({ok[0]['chips']} cards, NVLink "
                f"{nvlink / 1e9:.0f} GB/s, InfiniBand {ib / 1e9:.0f} GB/s a "
                f"card, one direction): {len(ok)} cells ok, "
                f"{len(recs) - len(ok)} skipped, {fit[name]} fit; traces "
                f"{sum(r['t_trace_s'] for r in ok):.1f} s in all, "
                f"{wall:.1f} s of wall in {DRY_WORKERS} processes")
        # (e) the sequence rules, beside the default records of (b)
        seq_split_records(card, default)
        bo.result()

    # (d) what fits where
    log(f"[18d] cells that fit: one card {phase15['fit']} of "
        f"{phase15['cells']}, single {fit['single']} of {phase15['cells']}, "
        f"multi {fit['multi']} of {phase15['cells']}")
    return fit


# -- phase 19 ------------------------------------------------------------------


def serve_on_mesh(dev, card: str, kc, cfg=None) -> None:
    """Phase 19: gemma-2b served with phase 8's tuned kernels off a mesh
    (``DecodeServer``: a prefill of SERVE_B x SERVE_PROMPT, then
    MESH_SERVE_STEPS greedy decode steps replayed from a captured graph),
    then the same steps on a one-rank NCCL mesh (``make_prefill_step`` and
    ``make_decode_step`` with a ``ShardCtx``: DTensor weights, batch and
    cache, each step fed the token the server chose). The mesh path goes
    through the kernel gates as the server does: it must launch the flash
    kernel once a layer in its prefill and the decode kernel once a layer
    in each step, and its logits must equal the served ones bit for bit
    (else, held to phase 12's rule, 2e-2 x max|logits|, and the
    difference printed). ``cfg`` (gemma-2b whole unless given) with
    ``dev`` the CPU rehearses it over gloo."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import (make_decode_step,
                                           make_prefill_step, place_batch)
    from repro_torch.parallel.sharding import ParallelConfig, ShardCtx
    from torch.distributed.tensor import DTensor
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    cfg, pcfg = cfg or get_arch("gemma-2b"), ParallelConfig(kernel=kc)
    steps, cuda = MESH_SERVE_STEPS, torch.device(dev).type == "cuda"
    server = serve.DecodeServer(cfg, pcfg, batch=SERVE_B,
                                prompt_len=SERVE_PROMPT, decode_steps=steps,
                                seed=0, device=dev, keep_logits=steps)
    batch = server.input_batch()
    server.prefill_batch(batch)
    for _ in range(steps):
        server.decode_step()
    served, toks = server.kept, [t.clone() for t in server.out]
    params = server.params
    server = None
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_host_mesh(data=1, model=1,
                              device=None if cuda else "cpu")
        px = ShardCtx(mesh, pcfg)
        sharded = P.shard_params(params, P.model_specs(cfg), mesh, pcfg)
        params = None
        prefill = make_prefill_step(cfg, pcfg, SERVE_PROMPT + steps, px=px)
        decode = make_decode_step(cfg, pcfg, px=px)
        serve.reset_kernel_launches()
        t0 = time.perf_counter()
        logits, cache = prefill(sharded, place_batch(batch, px))
        got = [logits]
        for i in range(steps):
            logits, cache = decode(sharded, cache, place_batch(
                {"tokens": toks[i][:, None]}, px), SERVE_PROMPT + i)
            got.append(logits)
        got = [(t.full_tensor() if isinstance(t, DTensor) else t)
               .float().cpu() for t in got]
        run_s = time.perf_counter() - t0
        launches = serve.kernel_launches()
        placed = isinstance(cache[0]["k"], DTensor)
        sharded = cache = None
    finally:
        dist.destroy_process_group()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, served)]
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, served))
    L = cfg.num_layers
    log(f"[19] {cfg.name} on a one-rank NCCL mesh with phase 8's kernels "
        f"{kc}: a prefill of {SERVE_B} x {SERVE_PROMPT} and {steps} decode "
        f"steps in {run_s:.2f} s (eager, DTensor cache: {placed}); launches "
        f"{launches} (want flash {L}, decode {L * steps}); logits bit-equal "
        f"to the served ones, step by step: {equal}; worst "
        f"max|d| / max|served| {worst:.3e} ({card}, {smi_line()})")
    if not placed:
        fail("the mesh path's cache is not a DTensor")
    if launches["flash_attention"] != L or \
            launches["flash_decode_split"] != L * steps:
        fail(f"the mesh path launched {launches}: a kernel gate fell back "
             "to the plain path")
    if len(got) != len(served) or not all(equal) and worst > 2e-2:
        fail(f"the mesh path's logits miss the served ones by {worst:.3e} "
             "of max|logits|")


def seq_split_records(card: str, default: dict) -> None:
    """Phase 18(e): the reference's sequence rules on the single mesh
    (``SEQ_RULE_CELLS``), each cell traced in a process of its own, beside
    its default record from 18(b): a card's peak, its cache bytes and its
    collective bytes over NVLink and InfiniBand. Under ``act_cache_seq``
    the decode cell's cache a card must be the default's / 8 (gemma-2b's
    one KV head: no other rule splits it); every record must be ok."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch import dryrun
    from repro_torch.parallel.sharding import DEFAULT_ACT_RULES, ParallelConfig
    t0 = time.perf_counter()
    jobs = [(arch, shape, card, ParallelConfig(act_rules={
        **DEFAULT_ACT_RULES, **rules}), None, "single")
        for arch, shape, rules in SEQ_RULE_CELLS]
    with ProcessPoolExecutor(len(jobs),
                             mp_context=mp.get_context("spawn")) as ex:
        recs = list(ex.map(dryrun._run_cell_args, jobs))
    for (arch, shape, rules), rec in zip(SEQ_RULE_CELLS, recs):
        base = default[(arch, shape, "single")]
        head = f"[18e] {arch} x {shape} x single"
        if rec["status"] != "ok":
            fail(f"{head} under {rules}: {rec.get('error')}")

        def line(r):
            mem, ln = r["memory"], r["links"]
            return (f"peak {mem['peak_live_bytes'] / 1e9:.3f} GB "
                    f"({'fits' if r['fits'] else 'does not fit'} "
                    f"{mem['card_bytes'] / 1e9:.2f}), cache "
                    f"{mem['cache_size_in_bytes']:,} B, collectives "
                    f"{ {k: int(v) for k, v in r['coll_by_kind'].items()} }, "
                    f"NVLink {ln['nvlink_bytes'] / 1e9:.3f} GB, InfiniBand "
                    f"{ln['ib_bytes'] / 1e9:.3f} GB a card; step "
                    f"{r['roofline']['step_time']:.4g} s "
                    f"({r['roofline']['dominant']})")
        log(f"{head}, default rules: {line(base)}")
        log(f"{head}, {rules}: {line(rec)}; trace {rec['t_trace_s']:.1f} s")
        cache, want = (rec["memory"]["cache_size_in_bytes"],
                       base["memory"]["cache_size_in_bytes"])
        if "act_cache_seq" in rules and cache * 8 != want:
            fail(f"{head}: the cache a card under {rules} is {cache:,} B, "
                 f"want the default's {want:,} / 8")
    log(f"[18e] done in {time.perf_counter() - t0:.1f} s ({smi_line()})")


# -- phase 20 ------------------------------------------------------------------


def gp_stage(t: int) -> int:
    """The T that ``ops.gp_inputs_from_incremental`` pads t observations to."""
    return max(128, 1 << (t - 1).bit_length())


def paper_evaluation(dev, card: str) -> dict:
    """Phase 20: Fig. 4, Figs. 6-7, Table I on one kernel and the warm
    start, through launch/compare.py's functions at the reference's
    budgets, caps and sizes, ``EVAL_SEEDS`` seeds each. Each run is checked
    as it ends: a BO run launches the GP kernel at least once an iteration,
    a baseline's trace is the same run's on the CPU, no config twice.
    Returns the phase's GP-kernel launches and the T 512 kernel entry of
    the kernels' JSON."""
    from collections import Counter
    import torch
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.strategies import make_strategy
    from repro_torch.core.strategies.bo import BOStrategy
    from repro_torch.kernels import matern_gp as kgp, ops, ref
    from repro_torch.launch import compare

    class StageTimer(compare.TimedStrategy):
        """Also each BO iteration's suggest seconds, by the T its GP state
        pads to (read before the call: one observation is added between
        calls, none inside one)."""

        def __init__(self, inner):
            super().__init__(inner)
            self.iterations = 0
            self.stages = {}

        def suggest(self, n):
            gp = getattr(getattr(self.inner, "gp", None), "gp", None)
            t = getattr(gp, "t", 0)
            s0 = time.perf_counter()
            out = super().suggest(n)
            if out and out[0].af != "init":
                self.iterations += 1
                self.stages.setdefault(gp_stage(t) if t else 0, []).append(
                    time.perf_counter() - s0)
            return out

    seen = {"n": kgp.launches, "by": Counter(kgp.launches_by), "runs": {}}

    def stage_ms(s) -> str:
        return ", ".join(f"T {T} {1e3 * sum(v) / len(v):.3f} ms ({len(v)})"
                         for T, v in sorted(s.stages.items()))

    def check(run) -> None:
        res, s = run.result, run.strategy
        n = kgp.launches - seen["n"]
        by = Counter(kgp.launches_by)
        by.subtract(seen["by"])
        by = +by
        seen["n"], seen["by"] = kgp.launches, Counter(kgp.launches_by)
        seen["runs"][run.label] = (run, by)
        keys = [o.key for o in res.journal]
        n_inv = sum(not math.isfinite(o.value) for o in res.journal)
        bo = isinstance(s.inner, BOStrategy)
        log(f"[20] {run.label}: best {res.best_value:.4f} (optimum "
            f"{run.objective.optimum:.4f}), {res.unique_evals} unique evals "
            f"of {s.proposals} proposals, {n_inv} invalid, "
            f"{run.wall_s:.2f} s, tuner "
            f"{1e3 * s.seconds / max(s.proposals, 1):.3f} ms a proposal"
            + (f"; {s.iterations} BO iterations, GP launches "
               f"{dict(sorted(by.items()))}; suggest by stage: "
               f"{stage_ms(s)}" if bo else ""))
        if len(set(keys)) != len(keys):
            fail(f"{run.label}: a config was evaluated twice")
        if res.unique_evals != run.budget and s.proposals < 50 * run.budget:
            fail(f"{run.label}: {res.unique_evals} of {run.budget} evals "
                 "before the total-call cap")
        if bo and n < s.iterations:
            fail(f"{run.label}: {n} GP-kernel launches for {s.iterations} "
                 "BO iterations, want at least one an iteration")
        if not bo:
            name = run.label.split("/")[-2]
            cpu = run_strategy(make_strategy(
                name, **compare.strategy_kwargs(name, "cpu")),
                run.objective, budget=run.budget, seed=run.seed)
            if [o.key for o in cpu.journal] != keys:
                fail(f"{run.label}: trace differs from the same run on the "
                     "CPU")

    kw = {"device": dev, "on_run": check, "timer": StageTimer}
    n0 = kgp.launches
    # (a) Fig. 4
    t0 = time.perf_counter()
    f4 = compare.fig4(EVAL_SEEDS, **kw)
    log(f"[20a] fig4/ei_target,0.0,best_at_{f4['budget']}="
        f"{f4['target']:.4f}")
    for strat, v in f4["others"].items():
        log(f"[20a] fig4/{strat},0.0,evals_to_match={v['mean_evals']:.0f} "
            f"matched={v['frac_matched']:.0%}")
    log(f"[20a] Fig. 4: {time.perf_counter() - t0:.1f} s")
    # (b) Figs. 6-7
    t0 = time.perf_counter()
    gpu, strategies, _ = compare.FIGURES[6]
    matrix = compare.run_matrix(compare.FIGURE_KERNELS[6], gpu, strategies,
                                EVAL_SEEDS, **kw)
    for kernel, d in matrix.items():
        for strat, v in d.items():
            log(f"[20b] fig6_7/{kernel}/{strat},"
                f"{v['mean_wall_s'] * 1e6:.1f},mae={v['mean_mae']:.4f} "
                f"tuner_ms_per_eval={v['tuner_ms_per_eval']:.3f}")
    for strat, v in compare.mdf_from_matrix(matrix).items():
        log(f"[20b] fig6_7/mdf/{strat},0.0,mdf={v['mdf']:.4f}")
    log(f"[20b] Figs. 6-7: {time.perf_counter() - t0:.1f} s")
    # (c) Table I's ten variants on one kernel: every covariance the
    # variants name reaches the kernel
    t0 = time.perf_counter()
    before = Counter(kgp.launches_by)
    t1 = compare.table1(EVAL_SEEDS, kernels=(EVAL_TABLE1_KERNEL,), **kw)
    covs = Counter()
    for (nu, T), n in kgp.launches_by.items():
        covs[nu] += n - before[nu, T]
    for name in t1["ranked"]:
        log(f"[20c] table1/{name},0.0,mdf={t1['mdf'][name]['mdf']:.4f} "
            f"mae={t1['per_kernel'][EVAL_TABLE1_KERNEL][name]:.4f}")
    log(f"[20c] Table I on {EVAL_TABLE1_KERNEL}: GP launches by covariance "
        f"{dict(covs)}; {time.perf_counter() - t0:.1f} s")
    want = {c.kernel for c in compare.VARIANTS.values()}
    if any(covs[nu] <= 0 for nu in want):
        fail(f"Table I: GP-kernel launches by covariance {dict(covs)}, want "
             f"each of {sorted(want)}")
    # (d) the cross-size warm start at the reference's budget and sources:
    # the reference's ExpDist, then GEMM, whose warm run reaches T 512
    for kernel in (compare.WARM_KERNEL, EVAL_T512_KERNEL):
        t0 = time.perf_counter()
        ws = compare.warm_start(EVAL_SEEDS, kernel=kernel,
                                log=lambda m: log(f"[20d] {kernel} {m}"),
                                **kw)
        cold, _ = seen["runs"]["warm_start/cold/seed0"]
        warm, wby = seen["runs"]["warm_start/warm/seed0"]
        g = warm.strategy.inner.gp.gp
        log(f"[20d] {kernel}: {ws['scenario']['store_records']} source "
            f"records; warm run: GP rebuilt for {g.max_obs} observations, "
            f"{g.t} at its end, launches {dict(sorted(wby.items()))}; "
            f"suggest a proposal by stage: cold {stage_ms(cold.strategy)}; "
            f"warm {stage_ms(warm.strategy)}; reduction "
            f"{ws['reduction']:.1%} (bar {compare.WARM_TARGET_REDUCTION:.0%})"
            f"; {time.perf_counter() - t0:.1f} s")
    n512 = sum(n for (_, T), n in wby.items() if T == 512)
    if n512 <= 0:
        fail(f"the {EVAL_T512_KERNEL} warm run launched the GP kernel at "
             f"{dict(wby)}, never at T 512")
    # (e) the GP kernel at the warm run's last state (T 512), against its
    # plain version (phase 2's rule, and both against float64)
    x_obs, vinv, w, mask, _, _ = ops.gp_inputs_from_incremental(g)
    Xc = g._Xc_dev
    args = [Xc] + [torch.from_numpy(a).to(dev) for a in (x_obs, vinv, w,
                                                         mask)]
    N, T, d = Xc.shape[0], x_obs.shape[0], Xc.shape[1]
    run_k = lambda: kgp.gp_posterior(*args, ell=g.ell, nu=g.kernel,
                                     block_n=g.block_n)
    run_p = lambda: ref.gp_posterior(*args[:4], g.ell, g.kernel,
                                     mask=args[4])
    n_k = kgp.launches
    mean_k, var_k = run_k()
    kgp.launches = n_k                     # the check is not the path's
    mean_r, var_r = run_p()
    mean_x, _ = ref.gp_posterior(*(a.double() for a in args[:4]), g.ell,
                                 g.kernel, mask=args[4].double())
    torch.cuda.synchronize()
    m_rng = float(mean_r.max() - mean_r.min()) + 1e-9
    m_err = float((mean_k - mean_r).abs().max())
    v_err = float((var_k - var_r).abs().max())
    var_bad = int(((var_k - var_r).abs() > 1e-4 + 3e-3 * var_r.abs()).sum())
    x_rng = float(mean_x.max() - mean_x.min()) + 1e-9
    k_x = float((mean_k.double() - mean_x).abs().max()) / x_rng
    p_x = float((mean_r.double() - mean_x).abs().max()) / x_rng
    k_ms = event_ms(run_k)
    # the path's block_n is BOConfig's default (N / 512 blocks: 32 of the
    # card's 132 SMs); phase 3 tunes 128 at T 256, timed beside it
    k128_ms = event_ms(lambda: kgp.gp_posterior(*args, ell=g.ell,
                                                nu=g.kernel, block_n=128))
    kgp.launches = n_k
    p_ms = event_ms(run_p)
    bound, by = gp_bounds(N, T, d, card)[1]
    log(f"[20e] gp N={N} T={T} d={d} t={g.t} {g.kernel} block_n "
        f"{g.block_n}: max|dvar| {v_err:.3e}, max|dmean| {m_err:.3e} "
        f"({m_err / m_rng:.2e} of range); mean against float64: kernel "
        f"{k_x:.2e}, plain {p_x:.2e} of range; kernel {k_ms:.4f} ms "
        f"(block_n 128: {k128_ms:.4f} ms), plain {p_ms:.4f} ms (events), "
        f"bound {bound:.6f} ms ({by}); {n512} launches at T 512 in the "
        f"{EVAL_T512_KERNEL} warm run")
    if var_bad or m_err >= 0.03 * m_rng or k_x >= 0.03:
        fail(f"the GP kernel at T {T} disagrees with its plain version")
    if T != 512:
        fail(f"the warm run's last state packs to T {T}, want 512")
    entry = {"name": "matern_gp@T512", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/matern_gp.cu",
             "replaces": "src/repro/kernels/matern_gp.py:44",
             "launches": n512, "max_abs_err": max(m_err, v_err), "ms": k_ms,
             "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": None}
    return {"launches": kgp.launches - n0, "t512": entry}


def shutil_rmtree(path: str) -> None:
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel-vs-plain checks only")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.spaces import make_objective
    from repro_torch.core.strategies import make_strategy
    from repro_torch.kernels import _build, ops, ref, tuning
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import matern_gp as kgp
    from repro_torch.launch.roofline import bound_ms
    from repro_torch.store.records import TuningRecordStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device and build
    smi = smi_line()
    card = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; device_kind {tuning.device_kind(dev)}")
    lib = _build.lib()
    log(f"[1] build: {_build.build_seconds:.1f} s")
    regs, local = ctypes.c_int(), ctypes.c_int()
    attrs = [("gemm fp32 (3xTF32 mma.sync, cp.async ring)",
              lambda: lib.gemm_attrs(0, regs, local)),
             ("gemm bf16 (mma.sync, cp.async ring)",
              lambda: lib.gemm_attrs(1, regs, local)),
             ("gp (3xTF32 mma.sync, L^-1 ring)",
              lambda: lib.gp_attrs(regs, local))]
    for hd in (64, 80, 128, 256):
        for causal, mask in ((1, "causal"), (0, "full")):
            attrs.append((f"flash hd{hd} fp32 {mask} (CUDA cores)",
                          lambda hd=hd, c=causal: lib.flash_attention_attrs(
                              0, hd, 1, c, regs, local)))
            for nwg in (1, 2):
                attrs.append((f"flash hd{hd} bf16 {mask} (wgmma, {nwg} "
                              f"warpgroup{'s' if nwg > 1 else ''})",
                              lambda hd=hd, nwg=nwg, c=causal:
                              lib.flash_attention_attrs(1, hd, nwg, c, regs,
                                                        local)))
        for dt, dname in ((0, "fp32"), (1, "bf16")):
            for mode, mname in ((0, "partials"), (1, "combine fused in")):
                for G in (8, 16):
                    attrs.append((f"decode split hd{hd} G<={G} {dname}, "
                                  f"{mname}",
                                  lambda hd=hd, dt=dt, mode=mode, G=G:
                                  lib.decode_attrs(mode, dt, hd, G, regs,
                                                   local)))
    for name, get in attrs:
        _build.check(get(), f"{name} attributes")
        log(f"[1] {name}: {regs.value} registers/thread, "
            f"{local.value} B local memory"
            + ("" if local.value == 0 else
               " (spills or a stack frame: an array indexed at run time or "
               "a register ceiling; nvcc -Xptxas -v names which)"))
        if name.startswith("gemm"):
            db = 4 if "fp32" in name else 2
            model = ops.GEMM_REGS_PER_THREAD[db]
            log(f"[1]   resource model: {model} registers/thread")
            if regs.value != model:
                fail(f"{name}: the build uses {regs.value} registers a "
                     f"thread, the resource model {model} "
                     "(kernels/ops.py GEMM_REGS_PER_THREAD): the tuner's "
                     "static invalid configs would not be the card's")

    # 2. kernel vs plain, on the card
    t0 = time.perf_counter()
    errs = check_gemm(dev)
    errs.update(check_gp(dev))
    errs.update(check_flash(dev))
    errs.update(check_decode(dev))
    log(f"[2] kernel-vs-plain checks passed in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.quick:
        log(f"[quick] done in {time.perf_counter() - t_start:.1f} s")
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": card,
            "count": torch.cuda.device_count()}}))
        return 0

    # the store phases 3, 4 and 7 journal into and phase 8 resolves from;
    # removed at exit whatever happens
    store_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    sdir = store_tmp.name
    # 3. the self-hosting cell
    t0 = time.perf_counter()
    t_obs, N_gp, d_gp = MAIN_GP
    gcell = tuning.gp_cell(N=N_gp, T=MAIN_T, d=d_gp, t_obs=t_obs)
    kg.launches = kgp.launches = 0
    gres = tuning.run_kernel_tuning(gcell, sdir, budget=5, init=3,
                                    reps=5)
    gp_tune_launches = kgp.launches
    store = TuningRecordStore(sdir)
    best_bn = tuning.tuned_gp_block_n(store, N=N_gp, T=MAIN_T, d=d_gp)
    want_bn = gcell.space.config(gres.best_idx)["block_n"]
    log(f"[3] gp cell {gcell.objective_id()}: best block_n {want_bn} at "
        f"{gres.best_value * 1e3:.4f} ms over {gres.unique_evals} "
        f"evals ({gp_tune_launches} gp launches); tuned_gp_block_n -> "
        f"{best_bn} ({time.perf_counter() - t0:.1f} s)")
    if best_bn != want_bn:
        fail(f"tuned_gp_block_n returned {best_bn}, store best {want_bn}")

    # 4. the main path
    t0 = time.perf_counter()
    cell = tuning.gemm_cell(*MAIN_GEMM, dtype=torch.float32)
    kg.launches = kgp.launches = 0
    res = tuning.run_kernel_tuning(
        cell, sdir, budget=GEMM_BUDGET, init=3, reps=3,
        gp_backend="cuda", gp_block_n=best_bn)
    launches = {"gemm": kg.launches, "matern_gp": kgp.launches}
    main_s = time.perf_counter() - t0
    best_cfg = cell.space.config(res.best_idx)
    n_static, n_runtime = invalid_split(res, cell)
    default_idx = cell.space.index_of(cell.default)
    default_s = tuning.KernelObjective(cell, reps=5)(default_idx)
    log(f"[4] gemm cell {cell.objective_id()}: {res.unique_evals} evals "
        f"in {main_s:.1f} s; best {best_cfg} "
        f"{res.best_value * 1e3:.4f} ms after {evals_to_best(res)} "
        f"evals; default {cell.default} "
        f"{default_s * 1e3:.4f} ms; invalid {n_static} static, "
        f"{n_runtime} runtime; launches gemm {launches['gemm']}, "
        f"gp {launches['matern_gp']}")
    if launches["gemm"] <= 0 or launches["matern_gp"] <= 0:
        fail(f"main path launch counts {launches}: a kernel of the path "
             "never ran")
    if not math.isfinite(res.best_value) or res.best_value <= 0:
        fail(f"main path best value {res.best_value}")
    got = kg.gemm(*cell.meta["inputs"], **best_cfg)
    want = ref.gemm(*cell.meta["inputs"])
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()) or bool(
            ((got - want).abs() > 1e-3 + 1e-4 * want.abs()).any()):
        fail("tuned gemm output is not finite or disagrees with its "
             "plain version (rtol 1e-4, atol 1e-3)")

    # 5. paper-scale surrogate
    obj = make_objective("gemm", "a100")
    strat = make_strategy("advanced_multi", gp_backend="cuda",
                          gp_block_n=best_bn)
    suggest_s = []
    inner = strat.suggest

    def timed_suggest(n):
        s0 = time.perf_counter()
        out = inner(n)
        if out and out[0].af != "init":        # a BO iteration
            suggest_s.append(time.perf_counter() - s0)
        return out

    strat.suggest = timed_suggest
    kgp.launches, kgp.launch_ms, kgp.time_launches = 0, 0.0, True
    t0 = time.perf_counter()
    cres = run_strategy(strat, obj, budget=220, seed=0)
    wall = time.perf_counter() - t0
    kgp.time_launches = False
    n_gp5, ms_gp5 = kgp.launches, kgp.launch_ms
    t0 = time.perf_counter()
    nres = run_strategy(make_strategy("advanced_multi"), obj, budget=220,
                        seed=0)
    wall_np = time.perf_counter() - t0
    n_it = len(suggest_s)
    sug_ms = 1e3 * sum(suggest_s) / max(n_it, 1)
    ker_ms = ms_gp5 / max(n_it, 1)
    # the host's share that the kernel path adds: packaging the GP state
    # (L^-1 by triangular solve, w, padding) at the run's final t
    g220, _ = gp_state(220, obj.space.size, obj.space.dim, "matern32")
    pack = []
    for _ in range(10):
        s0 = time.perf_counter()
        ops.gp_inputs_from_incremental(g220)
        pack.append(time.perf_counter() - s0)
    log(f"[5] {obj.name} ({obj.space.size} configs), advanced_multi, 220 "
        f"evals: cuda best {cres.best_value:.4f} ms after "
        f"{evals_to_best(cres)} evals in {wall:.1f} s ({n_gp5} gp launches, "
        f"{ms_gp5:.2f} ms in the kernel); numpy best {nres.best_value:.4f} "
        f"ms after {evals_to_best(nres)} evals in {wall_np:.1f} s")
    log(f"[5] per BO iteration ({n_it}): suggest {sug_ms:.3f} ms = kernel "
        f"{ker_ms:.4f} ms + host {sug_ms - ker_ms:.3f} ms; packaging the "
        f"GP state at t=220 takes {1e3 * statistics.median(pack):.3f} ms "
        "(host, median of 10)")
    if n_gp5 < 200:
        fail(f"paper-scale run made {n_gp5} GP-kernel launches, want >= 200")
    if not (math.isfinite(cres.best_value) and cres.unique_evals == 220):
        fail("paper-scale cuda run did not finish its budget with a valid best")

    # 7. BO tunes the serve kernels into the store
    t0 = time.perf_counter()
    tune_serve_kernels(sdir, best_bn)
    log(f"[7] done in {time.perf_counter() - t0:.1f} s")

    # 8. slice 2's main path: serve gemma-2b at full width
    t0 = time.perf_counter()
    served = serve_gemma(sdir, dev)
    log(f"[8] done in {time.perf_counter() - t0:.1f} s")

    # 10. the online loop on a copy of the phase-7 store
    t0 = time.perf_counter()
    online = online_gemma(sdir, dev, served["server"].params, best_bn)
    log(f"[10] done in {time.perf_counter() - t0:.1f} s")

    # 11. this slice's main path: the paper's comparison on the card, the
    # generative backend, and the live comparison on phase 4's cell
    t0 = time.perf_counter()
    n_gp11 = paper_comparison(dev) + generative_on_card(dev)
    n_gemm11 = live_comparison(
        cell, sdir, f"best {best_cfg} {res.best_value * 1e3:.4f} ms after "
        f"{evals_to_best(res)} evals; invalid {n_static} static, "
        f"{n_runtime} runtime")
    log(f"[11] launches: gp {n_gp11}, gemm {n_gemm11}; done in "
        f"{time.perf_counter() - t0:.1f} s")
    if n_gp11 <= 0 or n_gemm11 <= 0:
        fail("phase 11 launched a kernel of its path no time")
    launches["gemm"] += n_gemm11
    launches["matern_gp"] += n_gp11

    # 6. yardsticks at the main-path shapes: CUDA events around one call
    a, b = cell.meta["inputs"]
    M, N, K = MAIN_GEMM
    Xc, x_obs, vinv, w, mask = gp_problem(*MAIN_GP, "matern32", MAIN_T)
    gargs = [torch.from_numpy(x).to(dev) for x in (Xc, x_obs, vinv, w, mask)]
    N_, T_, d_ = Xc.shape[0], MAIN_T, Xc.shape[1]
    gemm_bytes = 4.0 * (M * K + K * N + M * N)
    cores_ms = bound_ms(2.0 * M * N * K, gemm_bytes, card)[0]
    gp_cores, gp_path = gp_bounds(N_, T_, d_, card)
    a16, b16 = a.bfloat16(), b.bfloat16()
    cases = {
        "gemm": (f"gemm {M}x{N}x{K} fp32 {best_cfg} (3xTF32 on the tensor "
                 f"cores; bound on the CUDA cores {cores_ms:.6f} ms); "
                 "library torch.matmul",
                 lambda: kg.gemm(a, b, **best_cfg), lambda: ref.gemm(a, b),
                 lambda: torch.matmul(a, b),
                 *bound_ms(2.0 * M * N * K, gemm_bytes, card, "tf32x3")),
        "gemm bf16": (f"gemm {M}x{N}x{K} bf16 {cell.default} (tensor cores)"
                      "; library torch.matmul",
                      lambda: kg.gemm(a16, b16, **cell.default),
                      lambda: ref.gemm(a16, b16),
                      lambda: torch.matmul(a16, b16),
                      *bound_ms(2.0 * M * N * K, gemm_bytes / 2, card,
                                "bfloat16")),
        "matern_gp": (
            f"gp N={N_} T={T_} d={d_} block_n={best_bn} (the product as "
            f"3xTF32 on the tensor cores; bound on the CUDA cores "
            f"{gp_cores[0]:.6f} ms); library none",
            lambda: kgp.gp_posterior(*gargs, ell=2.0, nu="matern32",
                                     block_n=best_bn),
            lambda: ref.gp_posterior(*gargs[:4], 2.0, "matern32",
                                     mask=gargs[4]), None, *gp_path)}
    cases.update(serve_cases(served["kc"], dev, card))
    event = {}
    for name, (label, *fns, bound, by) in cases.items():
        event[name] = [None if f is None else timed(event_ms, f,
                                                    f"[6] {name} events")
                       for f in fns]
        k_ms, p_ms, l_ms = event[name]
        log(f"[6] {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"library {'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
            f"{bound:.6f} ms ({by})")

    # 9. device time and the device's busy share, from torch.profiler; run
    # last, since a profiler session leaves host overhead behind it. The
    # phase-8 server keeps no logits here: its decode steps replay the
    # graph and copy nothing to the host
    server, batch = served["server"], served["batch"]
    server.keep_logits = 0
    profile_window(lambda: server.prefill_batch(batch), "a prefill")
    rows = profile_window(lambda: [server.decode_step()
                                   for _ in range(PROFILE_STEPS)],
                          f"{PROFILE_STEPS} decode steps after it")
    n_layers = served["server"].cfg.num_layers
    if rows:
        # the decode attention on the trace: one kernel a layer and step
        dec = {name: n for _, n, name in rows if "decode" in name}
        log(f"[9] decode kernels in the window: {dec}")
        if (len(dec) != 1 or "decode_split_kernel" not in next(iter(dec))
                or sum(dec.values()) != n_layers * PROFILE_STEPS):
            fail(f"decode window: want {n_layers * PROFILE_STEPS} launches "
                 f"of decode_split_kernel and no other decode kernel, got "
                 f"{dec}")
    seen = []
    device_ms(cases[FUSED_DECODE][1], kernels=seen)
    log(f"[9] device kernels per fused decode call: {seen}")
    if seen and (len(seen) != 1 or seen[0][1] != 1):
        fail(f"the fused decode call launched {seen}, want one kernel")
    device = {}
    for name, (label, *fns, bound, by) in cases.items():
        device[name] = [None if f is None else timed(device_ms, f,
                                                     f"[9] {name} device")
                        for f in fns]
        k_ms, p_ms, l_ms = (("not measured" if x is None else f"{x:.4f} ms")
                            if f is not None else "none"
                            for x, f in zip(device[name], fns))
        k_d, p_d, l_d = device[name]
        ratio = "".join(f"; kernel / {what} {k_d / x:.3f}"
                        for what, x in (("plain", p_d), ("library", l_d))
                        if k_d is not None and x is not None)
        log(f"[9] {label}: device time kernel {k_ms}, plain {p_ms}, library "
            f"{l_ms}, bound {bound:.6f} ms ({by}){ratio}")

    # 12. the MoE family and the dense configs at full width, each served
    # from the phase-7 store after the gemma-2b server is freed (qwen3-moe's
    # 61 GB of weights beside it would leave little room)
    served["server"] = server = None
    t0 = time.perf_counter()
    families = [(MOE_ARCH, serve_family(MOE_ARCH, None, SERVE_STEPS, sdir,
                                        dev, card))]
    for name, depth in DENSE_RUNS:
        families.append((name, serve_family(name, depth, DENSE_STEPS, sdir,
                                            dev, card)))
    log(f"[12] done in {time.perf_counter() - t0:.1f} s")

    # 13. the last four families at full width, each model freed before
    # the next
    t0 = time.perf_counter()
    for name, depth, prompt, steps, pkw in LAST_RUNS:
        families.append((name, serve_last_family(name, depth, prompt, steps,
                                                 pkw, sdir, dev, card)))
    log(f"[13] done in {time.perf_counter() - t0:.1f} s")

    # 14. training on the card, after the last model is freed
    t0 = time.perf_counter()
    trained = train_on_card(dev, card)
    log(f"[14] done in {time.perf_counter() - t0:.1f} s")

    # 15. the dry-run tooling against the card
    t0 = time.perf_counter()
    dried = dryrun_on_card(dev, card, sdir)
    store_tmp.cleanup()
    log(f"[15] done in {time.perf_counter() - t0:.1f} s")

    # 16. training on a device mesh of one rank, beside phase 14
    t0 = time.perf_counter()
    train_on_mesh(dev, card, trained)
    log(f"[16] done in {time.perf_counter() - t0:.1f} s")

    # 17. xlstm-1.3b whole, off and on a one-rank mesh, 1 and 2 microbatches
    t0 = time.perf_counter()
    train_xlstm_on_mesh(dev, card)
    log(f"[17] done in {time.perf_counter() - t0:.1f} s")

    # 18. the dry-run on the card's production meshes (no kernel)
    t0 = time.perf_counter()
    dryrun_on_meshes(dev, card, dried)
    log(f"[18] done in {time.perf_counter() - t0:.1f} s")

    # 19. gemma-2b served on a one-rank mesh through the kernel gates
    t0 = time.perf_counter()
    serve_on_mesh(dev, card, served["kc"])
    log(f"[19] done in {time.perf_counter() - t0:.1f} s")

    # 20. the rest of the paper's evaluation through launch/compare.py
    t0 = time.perf_counter()
    evaluated = paper_evaluation(dev, card)
    launches["matern_gp"] += evaluated["launches"]
    log(f"[20] GP launches {evaluated['launches']}; done in "
        f"{time.perf_counter() - t0:.1f} s")

    summary = {"kernels": []}
    for name, src, line in (
            ("gemm", "gemm.cu", "gemm.py:21"),
            ("matern_gp", "matern_gp.cu", "matern_gp.py:44"),
            ("flash_attention", "flash_attention.cu", "flash_attention.py:22"),
            ("flash_decode_split", "flash_decode.cu", "flash_decode.py:37"),
            # the combine: the tail fused into the split kernel's launch
            ("flash_decode_combine", "flash_decode.cu", "flash_decode.py:94")):
        n = launches[name] if name in launches else served["launches"][name]
        # device time where the profiler gave one, else the event time
        k_ms, p_ms, l_ms = (e if d is None else d
                            for d, e in zip(device[name], event[name]))
        summary["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{line}", "launches": n,
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": cases[name][-2], "bound_by": cases[name][-1],
            "library_ms": l_ms})
    # every instance phases 12 and 13 served: the flash kernel at each
    # model's prefill, the decode kernel at its decode (one launch a layer
    # and step, the combine fused in where the blocks say so), for the
    # kernels each model's layers reach
    for arch, res in families:
        for name, src, line in (
                ("flash_attention", "flash_attention.cu",
                 "flash_attention.py:22"),
                ("flash_decode_split", "flash_decode.cu", "flash_decode.py:37")):
            if name not in res["kernels"]:
                continue
            summary["kernels"].append({
                "name": f"{name}@{arch}", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": f"src/repro/kernels/{line}",
                "launches": res["launches"][name], **res["kernels"][name]})
    summary["kernels"].append(evaluated["t512"])
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(summary))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
