"""Serving launcher: batched prefill + greedy decode of one model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --batch 4 --prompt-len 1024 --decode-steps 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --smoke --device cpu --batch 2 --prompt-len 16 --decode-steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --smoke --device cpu --kernels --online --store DIR

Port of ``repro/launch/serve.py``: ``DecodeServer`` and ``main``. It runs
on the card unless given ``--device cpu``. On the card, prefill attention
goes through the flash kernel and per-token attention through the split-KV
decode kernels (``KernelConfig(use_flash=True, use_decode=True)``), with
blocks resolved from a tuning-record store (``--kernels --store``) or the
built-in defaults; a shape the kernels do not take (a prompt that is not a
multiple of 64, a head dim they are not built for) raises there rather than
serve plain attention. On the CPU the same dispatch runs the kernels' plain
versions when ``--kernels`` is given, the plain attention paths otherwise.
Weights are random, from ``--seed``.

On the card every decode step replays a captured CUDA graph of the step
function: one graph per kernel config, memoized in a
``CompiledKernelCache`` as the reference memoizes its jitted step
functions, so a hot swap back to a config replays a graph already
captured. A capture that fails raises; there is no eager fallback. On the
CPU the server runs the same step function eagerly.

``--online`` closes the loop as the reference's does (DESIGN.md §12): the
server tails the store between decode steps and hot-swaps tuned kernel
blocks when a better record lands, writes its step latencies back as
``context="prod"`` records, submits a durable retune job when a kernel
cell it serves was never tuned at its own shape (``stale``) or when
latency drifts off the sharding cell's stored prediction, and the
``repro_torch.launch.retune`` daemon services the job. The sharding cell
(``--tuned-shape``) resolves and hot-reloads as in the reference, but its
fields do not apply on one card (``store/resolve.py``). Cut from the
reference: the ``embeddings`` frontend.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import ops, tuning
from repro_torch.kernels.cache import CompiledKernelCache
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.params import DTYPES, init_params
from repro_torch.models.stepfn import make_decode_step, make_prefill_step
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
from repro_torch.store import (DriftMonitor, HotConfigSource, OnlineServeLoop,
                               ProdRecorder, apply_kernel_config,
                               apply_sharding_config, best_sharding_config)


def kernel_launches() -> Dict[str, int]:
    """Launch counts of the serve path's kernels: flash attention, and the
    decode kernel's launches, all of them and those that carry the fused
    combine. A graph replay counts the launches it holds."""
    return {"flash_attention": kfa.launches,
            "flash_decode_split": kfd.split_launches,
            "flash_decode_combine": kfd.combine_launches}


def _set_kernel_launches(n: Dict[str, int]) -> None:
    kfa.launches = n["flash_attention"]
    kfd.split_launches = n["flash_decode_split"]
    kfd.combine_launches = n["flash_decode_combine"]


def reset_kernel_launches() -> None:
    _set_kernel_launches(dict.fromkeys(kernel_launches(), 0))


class _DecodeGraph:
    """One captured decode step: the graph, its static outputs (the logits
    and their argmax, rewritten by each replay), and the kernel launches
    the capture recorded, which every replay adds to the counts."""

    def __init__(self, graph, logits, toks, launches, buffers):
        self.graph = graph
        self.logits = logits
        self.toks = toks
        self.launches = launches
        self._buffers = buffers    # what the graph reads, kept alive

    def replay(self) -> None:
        self.graph.replay()
        _set_kernel_launches({k: v + self.launches[k]
                              for k, v in kernel_launches().items()})


class _StepFns:
    """The step functions of one ParallelConfig, and on the card the
    decode graph captured from them (at the first decode step)."""

    def __init__(self, cfg, pcfg, cache_cap):
        self.prefill = make_prefill_step(cfg, pcfg, cache_cap=cache_cap)
        self.decode = make_decode_step(cfg, pcfg)
        self.graph: Optional[_DecodeGraph] = None


def resolve_pcfg(pcfg: ParallelConfig, store: str, arch: str, shape: str,
                 mesh: str = "single") -> ParallelConfig:
    """Best stored tuning config for this serving cell, else defaults."""
    hit = best_sharding_config(store, arch, shape, mesh=mesh)
    if hit is None:
        print(f"[serve] no tuning record for ({arch}, {shape}, {mesh}) in "
              f"{store} — using built-in defaults")
        return pcfg
    cfg, step_time = hit
    print(f"[serve] tuned config from store ({step_time:.3f}s roofline): "
          f"{cfg}")
    return apply_sharding_config(pcfg, cfg)


class DecodeServer:
    """Data plane of one serving process: weights, KV cache, decode state
    and the step functions of its ``ParallelConfig``.

    ``params`` defaults to random weights from ``seed`` on ``device``.
    ``keep_logits`` keeps a CPU copy of the logits of the prefill and of
    the first that many decode steps (``self.kept``), for parity checks.

    The KV cache, the decode step's token and position inputs are buffers
    the server owns for its lifetime: a prefill copies its cache into
    them, so a decode graph captured before a prefill stays valid after
    it. ``apply_config`` and ``apply_kernel_config`` are the hot-reload
    points the online loop calls between decode steps: they overlay a
    stored config and re-derive the step functions through
    ``kernel_cache`` (keyed by ``_stepfn_key``), so swapping back to a
    config is a cache hit and, on the card, replays the graph captured for
    it. All of a server's graphs share one memory pool.
    """

    def __init__(self, cfg, pcfg: ParallelConfig, *, batch: int,
                 prompt_len: int, decode_steps: int, seed: int = 0,
                 device=None, params=None, keep_logits: int = 0):
        self.cfg = cfg
        self.device = tuning.resolve_device(device)
        self.prompt_len = prompt_len
        self.cache_cap = prompt_len + decode_steps
        self.batch_size = batch
        self.seed = seed
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.keep_logits = keep_logits
        self.kept: List[torch.Tensor] = []
        with torch.inference_mode():
            self.cache = M.init_cache(cfg, batch, self.cache_cap,
                                      device=self.device)
            self._tokens = torch.zeros((batch, 1), dtype=torch.long,
                                       device=self.device)
            self._pos = torch.zeros((), dtype=torch.long, device=self.device)
        self.toks = None
        self.out: List[torch.Tensor] = []
        self.pos = 0
        self.swaps = 0
        self.kernel_swaps = 0
        #: decode graphs captured, and the seconds each capture took (its
        #: warm-up step included)
        self.captures = 0
        self.capture_s: List[float] = []
        self.kernel_cache = CompiledKernelCache()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self.pcfg = pcfg
        self._derive()

    def _stepfn_key(self):
        """Hashable identity of the step functions: the reference's key cut
        to the fields the port's ParallelConfig has, the kernel block
        config."""
        kc = self.pcfg.kernel
        return (() if kc is None else
                ("flash", kc.use_flash, kc.flash_block_q, kc.flash_block_kv,
                 "decode", kc.use_decode, kc.decode_block_kv,
                 kc.decode_num_splits, kc.decode_combine),)

    def _derive(self) -> None:
        self._fns = self.kernel_cache.get(
            self._stepfn_key(),
            lambda: _StepFns(self.cfg, self.pcfg, self.cache_cap))
        self.prefill, self.decode = self._fns.prefill, self._fns.decode

    def apply_config(self, cfg_dict) -> None:
        self.pcfg = apply_sharding_config(self.pcfg, cfg_dict)
        self._derive()
        self.swaps += 1

    def apply_kernel_config(self, cfg_dict) -> None:
        """Hot-swap tuned kernel blocks between decode steps: weights, KV
        cache and generated tokens survive; only the step functions are
        re-derived (or re-used from the cache, with their graph)."""
        self.pcfg = apply_kernel_config(self.pcfg, cfg_dict)
        self._derive()
        self.kernel_swaps += 1

    def _impl(self, gate_open: bool, kernel: str, plain: str) -> str:
        if not gate_open:
            return plain
        if self.device.type == "cuda":
            return f"CUDA {kernel}"
        return f"{kernel} plain version (cpu)"

    @property
    def prefill_dispatch(self) -> str:
        """Which implementation prefill attention runs on."""
        hd = self.cfg.resolved_head_dim
        gate = L._flash_kernel_ok(self.prompt_len, hd, hd, None,
                                  self.pcfg.kernel, self.device)
        return self._impl(gate, "flash-attention kernel",
                          "plain direct attention")

    @property
    def decode_kernel(self) -> bool:
        """Whether decode attention runs the flash-decode kernel (its plain
        version on the CPU); ``ServeStats`` counts the steps it served."""
        hd = self.cfg.resolved_head_dim
        return L._decode_kernel_ok(hd, hd, self.pcfg.kernel, self.device)

    @property
    def decode_dispatch(self) -> str:
        """Which implementation decode attention runs on."""
        kc = self.pcfg.kernel
        gate = self.decode_kernel
        combine = (" with the combine fused in"
                   if gate and kc.decode_combine == "kernel"
                   else " + tensor-op combine")
        graph = (", replayed as a CUDA graph"
                 if self.device.type == "cuda" else "")
        return self._impl(gate, "flash-decode split kernel" + combine,
                          "plain decode attention") + graph

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def input_batch(self) -> Dict[str, torch.Tensor]:
        """A prompt of random token ids from the server's seed."""
        gen = torch.Generator(device="cpu").manual_seed(self.seed + 1)
        toks = torch.randint(0, self.cfg.vocab_size,
                             (self.batch_size, self.prompt_len),
                             generator=gen)
        return {"tokens": toks.to(self.device)}

    def _keep(self, logits: torch.Tensor) -> None:
        if len(self.kept) <= self.keep_logits:
            self.kept.append(logits.float().cpu())

    def prefill_batch(self, batch) -> float:
        """Prefill the prompt into the server's cache; returns measured
        seconds."""
        self._sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, cache = self.prefill(self.params, batch)
            for mine, new in zip(self.cache, cache):
                for name, buf in mine.items():
                    buf.copy_(new[name])
            self.toks = torch.argmax(logits, -1)
        self._sync()
        dt = time.perf_counter() - t0
        self.logits_shape = tuple(logits.shape)
        self.kept = []                # a prefill starts the sequence anew
        self._keep(logits)
        self.out = [self.toks]
        self.pos = self.prompt_len
        return dt

    def _capture(self) -> _DecodeGraph:
        """Capture the decode step of the current step functions on the
        server's capture stream: one warm-up step first, on that stream
        (its launches are real and counted; it writes the cache slot the
        graph then rewrites with the same values), so that what is created
        at first use on a stream (the decode kernel's arrival counters,
        library workspaces) exists before the capture. The capture launches
        nothing: the counts it took are moved to the graph, which adds them
        at each replay."""
        t0 = time.perf_counter()
        fns, s = self._fns, self._stream
        step = {"tokens": self._tokens}
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            fns.decode(self.params, self.cache, step, self._pos)
        before = kernel_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=s):
            logits, _ = fns.decode(self.params, self.cache, step, self._pos)
            toks = torch.argmax(logits, -1)
        held = {k: v - before[k] for k, v in kernel_launches().items()}
        _set_kernel_launches(before)
        self.captures += 1
        self.capture_s.append(time.perf_counter() - t0)
        return _DecodeGraph(graph, logits, toks, held,
                            list(kfd._counters.values()))

    def decode_step(self) -> float:
        """One greedy decode step over the held state; returns seconds."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            self._tokens.copy_(self.toks[:, None])
            self._pos.fill_(self.pos)
            if self.device.type == "cuda":
                if self._fns.graph is None:
                    self._fns.graph = self._capture()
                graph = self._fns.graph
                graph.replay()
                logits, self.toks = graph.logits, graph.toks.clone()
            else:
                logits, _ = self.decode(self.params, self.cache,
                                        {"tokens": self._tokens}, self._pos)
                self.toks = torch.argmax(logits, -1)
        self._sync()
        dt = time.perf_counter() - t0
        self._keep(logits)
        self.out.append(self.toks)
        self.pos += 1
        return dt


def _fit_block(block: int, S: int) -> Optional[int]:
    """The largest flash block of at most ``block`` that tiles ``S``: a
    multiple of the kernel's 64-row sub-tile dividing ``S``, or None."""
    step = kfa.SUB_TILE
    for b in range(block - block % step, 0, -step):
        if S % b == 0:
            return b
    return None


def serving_kernel_config(cfg, *, device: torch.device, prompt_len: int,
                          cache_cap: int, store: Optional[str] = None,
                          log=print) -> KernelConfig:
    """The kernel dispatch of a server: flash and decode on, with the
    built-in blocks or, from ``store``, the best tuned blocks for this
    device that fit the server's shapes. On the card, flash blocks that do
    not tile the prompt shrink to the largest that do, and a shape no
    blocks serve raises ValueError; on the CPU the plain versions take any
    blocks."""
    hd = cfg.resolved_head_dim
    G = cfg.num_heads // cfg.num_kv_heads
    dtype = DTYPES[cfg.dtype]
    kc = KernelConfig(use_flash=True, use_decode=True)
    if store:
        kind = tuning.device_kind(device)
        hit = tuning.kernel_config_from_store(store, S=prompt_len, hd=hd,
                                              dtype=dtype, device=kind,
                                              base=kc)
        if hit is None:
            log("[serve] no usable flash (prefill) kernel record in store — "
                f"default blocks ({kc.flash_block_q}, {kc.flash_block_kv})")
        else:
            kc = hit
            log(f"[serve] tuned flash (prefill) blocks from store: "
                f"block_q={kc.flash_block_q} block_kv={kc.flash_block_kv}")
        hit = tuning.decode_kernel_config_from_store(
            store, cache_cap=cache_cap, H=cfg.num_heads,
            KV=cfg.num_kv_heads, hd=hd, device=kind, base=kc)
        if hit is None:
            log("[serve] no usable decode kernel record in store — default "
                f"blocks (block_kv={kc.decode_block_kv}, "
                f"num_splits={kc.decode_num_splits})")
        else:
            kc = hit
            log(f"[serve] tuned decode blocks from store: "
                f"block_kv={kc.decode_block_kv} "
                f"num_splits={kc.decode_num_splits} "
                f"combine={kc.decode_combine}")
    if device.type != "cuda":
        return kc
    bq, bkv = (_fit_block(b, prompt_len)
               for b in (kc.flash_block_q, kc.flash_block_kv))
    if bq is None or bkv is None:
        raise ValueError(f"the flash kernel tiles a prefill in "
                         f"{kfa.SUB_TILE}-row sub-tiles: a prompt of "
                         f"{prompt_len} is not a multiple of {kfa.SUB_TILE}")
    if (bq, bkv) != (kc.flash_block_q, kc.flash_block_kv):
        log(f"[serve] flash blocks ({kc.flash_block_q}, {kc.flash_block_kv})"
            f" do not tile a prompt of {prompt_len}: ({bq}, {bkv})")
        kc = kc.replace(flash_block_q=bq, flash_block_kv=bkv)
    if not ops.flash_valid({"block_q": bq, "block_kv": bkv}, hd, dtype):
        raise ValueError(f"the flash kernel does not take hd={hd} with "
                         f"blocks ({bq}, {bkv}) in {dtype}")
    if not ops.decode_valid({"block_kv": kc.decode_block_kv}, G, hd):
        raise ValueError(f"the decode kernel does not take hd={hd}, G={G}")
    return kc


def kernel_sources(store: str, cfg, *, batch: int, prompt_len: int,
                   cache_cap: int, device: torch.device,
                   swap_margin: float = 0.0,
                   log=print) -> List[HotConfigSource]:
    """Live sources over the server's two kernel cells, the flash
    (prefill) cell at its prompt and the decode cell at its cache, in the
    model's dtype, each refreshed once (the startup resolution). A shape
    whose cell has no config space (a prompt no flash block tiles) has no
    source: logged and skipped, as the reference does."""
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    dtype = DTYPES[cfg.dtype]
    cells = []
    for make, args, kw in (
            (tuning.flash_cell, (batch, prompt_len, cfg.num_heads, hd),
             {"KV": KV}),
            (tuning.decode_cell, (batch, cache_cap, cfg.num_heads, KV, hd),
             {})):
        try:
            cells.append(make(*args, dtype=dtype, device=device, **kw))
        except ValueError as e:
            log(f"[serve] no tunable kernel cell for this shape ({e}) — "
                "skipping hot-swap source")
    sources = []
    for cell in cells:
        src = HotConfigSource.for_kernel_cell(store, cell,
                                              swap_margin=swap_margin)
        src.refresh()
        sources.append(src)
    return sources


def make_online_loop(server: DecodeServer, store: str, *, arch: str,
                     tuned_shape: str, source: HotConfigSource,
                     kernel_sources: List[HotConfigSource],
                     prefill_s: float, drift_factor: float = 1.5,
                     drift_stat: str = "median", poll_every: int = 4):
    """The reference's online wiring around a prefilled server: a
    ``ProdRecorder`` (the prefill's latency journaled first, configless),
    a ``DriftMonitor`` on the sharding cell's stored prediction, the
    durable ``TuningJobQueue`` appending through the recorder's store
    handle, and the ``OnlineServeLoop`` whose first step is a warm-up (it
    captures the decode graph). Returns (loop, recorder, queue)."""
    from repro_torch.store.queue import TuningJobQueue
    recorder = ProdRecorder(store, arch, tuned_shape)
    # prefill latency is telemetry, not a decode-step observation: it
    # includes one-time costs and is in other units than a step — journaled
    # configless so it never transfers
    recorder.record(None, prefill_s, phase="prefill")
    monitor = DriftMonitor(source.current[1] if source.current else None,
                           factor=drift_factor, stat=drift_stat)
    # durable: a request survives this server's death and is claimed
    # (exactly once, fleet-wide) by `python -m repro_torch.launch.retune`
    # daemons; one live segment per pid, the shape compaction's "sealed"
    # rule assumes
    queue = TuningJobQueue(store, appender=recorder.store)
    loop = OnlineServeLoop(server, source, recorder=recorder,
                           monitor=monitor, retune_queue=queue,
                           cell_key=source.objective_id,
                           poll_every=poll_every, first_step_warmup=True,
                           kernel_sources=kernel_sources)
    return loop, recorder, queue


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the arch's family")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default=None,
                    help="tuning-record store (dir or .jsonl) to resolve "
                         "the serving config from")
    ap.add_argument("--tuned-shape", default="decode_32k",
                    help="dry-run shape whose tuning records configure "
                         "this server")
    ap.add_argument("--online", action="store_true",
                    help="tail the store between decode steps (hot config "
                         "reload), write prod-latency records back, flag "
                         "re-tunes (requires --store)")
    ap.add_argument("--drift-factor", type=float, default=1.5,
                    help="re-tune when windowed prod latency is off the "
                         "stored roofline by this factor either way")
    ap.add_argument("--drift-stat", default="median",
                    choices=["median", "p50", "p99", "mean"],
                    help="window statistic the drift alarm keys off (p99 "
                         "tracks the tail users feel)")
    ap.add_argument("--kernels", action="store_true",
                    help="resolve tuned flash and decode blocks from --store;"
                         " on the CPU, dispatch through the kernels' plain "
                         "versions; in --online mode also tail the store "
                         "for kernel hot-swaps")
    ap.add_argument("--swap-margin", type=float, default=0.0,
                    help="hot-reload hysteresis: a same-tier better record "
                         "must improve the step time by MORE than this many "
                         "seconds to be worth a graph capture")
    ap.add_argument("--poll-every", type=int, default=4,
                    help="decode steps between store polls in --online mode")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.online and not args.store:
        ap.error("--online requires --store")

    device = tuning.resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    cache_cap = args.prompt_len + args.decode_steps
    pcfg = ParallelConfig()
    source = None
    if args.online:
        # one code path for startup resolution AND hot reload: the first
        # refresh replays the store; later refreshes see only new records
        source = HotConfigSource(args.store, args.arch, args.tuned_shape,
                                 swap_margin=args.swap_margin)
        hit = source.refresh()
        if hit is None:
            print(f"[serve] no tuning record for ({args.arch}, "
                  f"{args.tuned_shape}, single) in {args.store} — using "
                  "built-in defaults")
        else:
            print(f"[serve] tuned config from store ({hit[1]:.3f}s "
                  f"roofline): {hit[0]}")
            pcfg = apply_sharding_config(pcfg, hit[0])
    elif args.store:
        pcfg = resolve_pcfg(pcfg, args.store, args.arch, args.tuned_shape)
    if device.type == "cuda" or args.kernels:
        pcfg = pcfg.replace(kernel=serving_kernel_config(
            cfg, device=device, prompt_len=args.prompt_len,
            cache_cap=cache_cap, store=args.store if args.kernels else None))
    ksources = []
    if args.online and args.kernels:
        ksources = kernel_sources(args.store, cfg, batch=args.batch,
                                  prompt_len=args.prompt_len,
                                  cache_cap=cache_cap, device=device,
                                  swap_margin=args.swap_margin)

    server = DecodeServer(cfg, pcfg, batch=args.batch,
                          prompt_len=args.prompt_len,
                          decode_steps=args.decode_steps, seed=args.seed,
                          device=device)
    batch = server.input_batch()
    reset_kernel_launches()
    dt_prefill = server.prefill_batch(batch)
    n_prefill = kernel_launches()
    print(f"[serve] {cfg.name} on {device}: prefill B={args.batch} "
          f"S={args.prompt_len}: {dt_prefill * 1e3:.1f} ms, logits "
          f"{server.logits_shape}; attention: {server.prefill_dispatch}")
    out = {"prefill_s": dt_prefill, "prefill_launches": n_prefill,
           "server": server}
    if args.online:
        loop, recorder, queue = make_online_loop(
            server, args.store, arch=args.arch, tuned_shape=args.tuned_shape,
            source=source, kernel_sources=ksources, prefill_s=dt_prefill,
            drift_factor=args.drift_factor, drift_stat=args.drift_stat,
            poll_every=args.poll_every)
        stats = loop.run(args.decode_steps)
        steps = stats.latencies
        for step, cfg_new, value in stats.swaps:
            print(f"[serve] hot-reload at step {step}: {value:.3f}s "
                  f"roofline {cfg_new}")
        for step, cfg_new, value in stats.kernel_swaps:
            print(f"[serve] kernel hot-swap at step {step}: "
                  f"{value * 1e3:.4f} ms kernel time {cfg_new} "
                  f"(cache {server.kernel_cache.stats()})")
        print(f"[serve] online: {recorder.count} prod records, "
              f"{len(stats.swaps)} hot reloads, "
              f"{len(stats.kernel_swaps)} kernel hot-swaps, "
              f"{stats.retunes_requested} drift and "
              f"{stats.kernel_retunes_requested} stale-cell retune "
              "requests submitted")
        print(f"[serve] decode dispatch: {stats.decode_steps_kernel} steps "
              f"flash-decode kernel, {stats.decode_steps_plain} plain")
        for tk in queue.open_tickets():
            where = " --device cpu" if device.type == "cpu" else ""
            print(f"[serve] durable {tk.reason} retune request {tk.id} open "
                  f"for {tk.key} (service with `python -m "
                  f"repro_torch.launch.retune --store {args.store}{where}`)")
        out.update(stats=stats, recorder=recorder, queue=queue)
    else:
        steps = [server.decode_step() for _ in range(args.decode_steps)]
    launches = kernel_launches()
    med = statistics.median(steps) if steps else float("nan")
    print(f"[serve] decoded {args.decode_steps} steps x B={args.batch}: "
          f"{sum(steps) * 1e3:.1f} ms, median {med * 1e3:.2f} ms/step, "
          f"{args.batch / med:.1f} tokens/s; attention: "
          f"{server.decode_dispatch}")
    print(f"[serve] kernel launches: prefill {n_prefill}, all {launches}; "
          f"decode graphs captured {server.captures}")
    print("[serve] sample tokens:", [int(t[0]) for t in server.out][:12])
    out.update(step_s=steps, launches=launches)
    return out


if __name__ == "__main__":
    main()
