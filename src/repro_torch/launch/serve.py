"""Serving launcher: batched prefill + greedy decode of one model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --batch 4 --prompt-len 1024 --decode-steps 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --smoke --device cpu --batch 2 --prompt-len 16 --decode-steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --smoke --device cpu --kernels --online --store DIR
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --smoke --device cpu --kernels \\
        --batch 2 --prompt-len 128 --decode-steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --smoke --device cpu --kernels \\
        --batch 2 --prompt-len 64 --decode-steps 8

Port of ``repro/launch/serve.py``: ``DecodeServer`` and ``main``. It runs
on the card unless given ``--device cpu``. On the card, prefill attention
goes through the flash kernel and per-token attention through the split-KV
decode kernels (``KernelConfig(use_flash=True, use_decode=True)``), with
blocks resolved from a tuning-record store (``--kernels --store``) or the
built-in defaults; a shape the kernels do not take (a prompt that is not a
multiple of 64, a head dim they are not built for) raises there rather than
serve plain attention. The layers the reference serves outside its kernels
stay plain, as in the reference: windowed and MLA attention in prefill
(the blockwise attention from ``flash_threshold`` tokens, else the
materialized scores), MLA's absorbed decode, cross-attention and the
recurrent blocks. On the CPU the same dispatch runs the kernels' plain
versions when ``--kernels`` is given, the plain attention paths otherwise.
Weights are random, from ``--seed``; so are the ``embeddings`` frontend's
frame embeddings and conditioning, and its decode steps embed each token
as the reference's server does, by ``lm_head.w[:, token]``.

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
(``--tuned-shape``) resolves and hot-reloads as in the reference; of its
fields those the port's ``ParallelConfig`` owns apply on one card
(``store/resolve.py``). ``--arch`` takes every config of the reference
(``configs/registry.py``).

``--trace`` turns on the server's span recorder (``launch/spans.py``),
serves a second batch of the same prompt, and prints what its spans say
there: the median host time to issue a decode step, and on the card the
median device interval of a replay and of the prefill's cache copy, the
device's idle share over the batch, and the device operations a decode
step starts (one decode step after a third prefill, under
``torch.profiler``); then the median self time of each span, the
capture's split between its warm-up and the graph, and the counts.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import ops, tuning
from repro_torch.kernels.cache import CompiledKernelCache
from repro_torch.launch.spans import (SpanRecorder, readings, self_ms,
                                      step_kernels)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.params import DTYPES, init_params, layer_kinds
from repro_torch.models.stepfn import make_decode_step, make_prefill_step
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
from repro_torch.store import (DriftMonitor, HotConfigSource, OnlineServeLoop,
                               ProdRecorder, apply_kernel_config,
                               apply_sharding_config, best_sharding_config)


def kernel_launches() -> Dict[str, int]:
    """Launch counts of the serve path's kernels: flash attention, and the
    decode kernel's launches, all of them, those that carry the fused
    combine and those that ran its K/V ring of two or more stages. A graph
    replay counts the launches it holds."""
    return {"flash_attention": kfa.launches,
            "flash_decode_split": kfd.split_launches,
            "flash_decode_combine": kfd.combine_launches,
            "flash_decode_ring": kfd.ring_launches}


def _set_kernel_launches(n: Dict[str, int]) -> None:
    kfa.launches = n["flash_attention"]
    kfd.split_launches = n["flash_decode_split"]
    kfd.combine_launches = n["flash_decode_combine"]
    kfd.ring_launches = n["flash_decode_ring"]


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


def kernel_paths(cfg) -> set:
    """The kernels a config's layers reach, as the reference's gates send
    them: ``"flash"`` where a GQA layer attends without a window,
    ``"decode"`` where any GQA layer decodes over a KV cache. MLA (q/k and
    v head dims differ) and the recurrent blocks reach neither."""
    if cfg.attention != "gqa":
        return set()
    attn = [k for k in layer_kinds(cfg) if k in ("attn", "attn_dense")]
    paths = {"decode"} if attn else set()
    if any(M.layer_window(cfg, k) is None for k in attn):
        paths.add("flash")
    return paths


def step_batch(cfg, params, toks: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A decode step's batch for the tokens ``toks`` (B,): the ids, or for
    the ``embeddings`` frontend the reference server's embedding of each
    token, ``lm_head.w[:, token]``."""
    if cfg.frontend != "embeddings":
        return {"tokens": toks[:, None]}
    emb = params["lm_head"]["w"][:, toks].T[:, None, :]
    return {"frame_embeddings": emb.to(DTYPES[cfg.dtype])}


def resolve_pcfg(pcfg: ParallelConfig, store: str, arch: str, shape: str,
                 mesh: Optional[str] = None) -> ParallelConfig:
    """Best stored tuning config for this serving cell, else defaults.
    ``mesh`` None keys the cell by this process's device kind
    (``dryrun[arch×shape×cuda-<card>]``, what ``DryRunObjective`` journals
    on the card): a record tuned for the reference's pod mesh
    (``single``) configures one card only when the caller names it."""
    if mesh is None:
        mesh = tuning.device_kind()
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

    ``trace`` turns on ``self.recorder`` (:class:`SpanRecorder`): spans at
    the prefill's, the decode step's and the capture's boundaries, and
    device intervals on the card. Off (``recorder`` None), each boundary
    costs one test of the attribute: no clock read, CUDA event or profiler
    range more. On, it adds no synchronise either, and the recorder holds
    every span for the server's life (a few hundred bytes a step).
    """

    def __init__(self, cfg, pcfg: ParallelConfig, *, batch: int,
                 prompt_len: int, decode_steps: int, seed: int = 0,
                 device=None, params=None, keep_logits: int = 0,
                 trace: bool = False):
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
        #: warm-up step included; the ``serve.capture`` spans' durations)
        self.captures = 0
        self.capture_s: List[float] = []
        self.recorder = SpanRecorder(self.device) if trace else None
        self.kernel_cache = CompiledKernelCache()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self.pcfg = pcfg
        self._derive()

    def _stepfn_key(self):
        """Hashable identity of the step functions: the reference's key cut
        to the fields the port's ParallelConfig has (the blockwise
        attention's and the mLSTM's knobs, the MoE capacity factor) and the
        kernel block config."""
        p, kc = self.pcfg, self.pcfg.kernel
        return (p.capacity_factor, p.attn_block_kv, p.attn_q_chunks,
                p.flash_threshold, p.mlstm_chunk, p.mlstm_bf16_streams) + (
            () if kc is None else
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

    def _report(self, attention: str, rglru: str, mlstm: str,
                slstm: str) -> str:
        """One part a layer kind of the config: its attention (prefixed
        ``MLA:`` or ``windowed:`` where the layers are), the recurrent
        blocks, then cross-attention."""
        cfg = self.cfg
        kinds = set(layer_kinds(cfg))
        parts = []
        if kinds & {"attn", "attn_dense"}:
            prefix = ("MLA: " if cfg.attention == "mla" else
                      "windowed: " if "flash" not in kernel_paths(cfg)
                      else "")
            parts.append(prefix + attention)
        parts += [what for kind, what in (("rglru", rglru), ("mlstm", mlstm),
                                          ("slstm", slstm)) if kind in kinds]
        if cfg.cross_attention:
            parts.append("cross-attention: plain")
        return "; ".join(parts)

    @property
    def prefill_dispatch(self) -> str:
        """Which implementation prefill runs each layer kind on."""
        S, p = self.prompt_len, self.pcfg
        plain = ("plain blockwise attention" if S >= p.flash_threshold
                 else "plain direct attention")
        if "flash" in kernel_paths(self.cfg):
            hd = self.cfg.resolved_head_dim
            gate = L._flash_kernel_ok(S, hd, hd, None, p.kernel, self.device)
            attention = self._impl(gate, "flash-attention kernel", plain)
        else:
            attention = plain + ", as the reference"
        c = p.mlstm_chunk
        mlstm = (f"mLSTM: chunkwise scan (chunk {c})"
                 if c and S % c == 0 and S > c else "mLSTM: step scan")
        return self._report(attention, "RG-LRU: doubling scan", mlstm,
                            "sLSTM: step scan")

    @property
    def decode_kernel(self) -> bool:
        """Whether decode attention runs the flash-decode kernel (its plain
        version on the CPU); ``ServeStats`` counts the steps it served."""
        if "decode" not in kernel_paths(self.cfg):
            return False
        hd = self.cfg.resolved_head_dim
        return L._decode_kernel_ok(hd, hd, self.pcfg.kernel, self.device)

    @property
    def decode_dispatch(self) -> str:
        """Which implementation a decode step runs each layer kind on."""
        kc = self.pcfg.kernel
        gate = self.decode_kernel
        combine = (" with the combine fused in"
                   if gate and kc.decode_combine == "kernel"
                   else " + tensor-op combine")
        if self.cfg.attention == "mla":
            attention = "plain absorbed latent decode, as the reference"
        else:
            attention = self._impl(gate, "flash-decode split kernel"
                                   + combine, "plain decode attention")
        graph = (", replayed as a CUDA graph"
                 if self.device.type == "cuda" else "")
        return self._report(attention, "RG-LRU: one recurrence step",
                            "mLSTM: one step", "sLSTM: one step") + graph

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def input_batch(self) -> Dict[str, torch.Tensor]:
        """A prompt from the server's seed: random token ids, or for the
        ``embeddings`` frontend random normal frame embeddings and, with
        cross-attention, conditioning embeddings, in the model dtype."""
        cfg, B = self.cfg, self.batch_size
        gen = torch.Generator(device="cpu").manual_seed(self.seed + 1)
        if cfg.frontend != "embeddings":
            toks = torch.randint(0, cfg.vocab_size, (B, self.prompt_len),
                                 generator=gen)
            return {"tokens": toks.to(self.device)}
        dt = DTYPES[cfg.dtype]

        def normal(*shape):
            return torch.randn(shape, generator=gen).to(self.device, dt)

        batch = {"frame_embeddings": normal(B, self.prompt_len, cfg.d_model)}
        if cfg.cross_attention:
            batch["cond"] = normal(B, cfg.cross_seq, cfg.d_model)
        return batch

    def _step_batch(self) -> Dict[str, torch.Tensor]:
        """A decode step's input from the server's token buffer
        (:func:`step_batch`; gathered on the device, so a captured graph
        embeds the token of each replay)."""
        return step_batch(self.cfg, self.params, self._tokens[:, 0])

    def _keep(self, logits: torch.Tensor) -> None:
        if len(self.kept) <= self.keep_logits:
            self.kept.append(logits.float().cpu())

    def prefill_batch(self, batch) -> float:
        """Prefill the prompt into the server's cache; returns measured
        seconds."""
        self._sync()
        t0 = time.perf_counter_ns()
        rec = self.recorder
        if rec is not None:
            rec.batch += 1
            top = rec.open("serve.prefill", t0)
            rec.open("serve.prefill.step", t0, device=True)
        with torch.inference_mode():
            logits, cache = self.prefill(self.params, batch)
            if rec is not None:
                rec.then("serve.prefill.cache_copy", device=True)
            for mine, new in zip(self.cache, cache):
                for name, buf in mine.items():
                    buf.copy_(new[name])
            if rec is not None:
                rec.then("serve.prefill.sample", device=True)
            self.toks = torch.argmax(logits, -1)
            if rec is not None:
                rec.then("serve.prefill.sync")
        self._sync()
        t1 = time.perf_counter_ns()
        if rec is not None:
            rec.close(top, t1)
        dt = (t1 - t0) / 1e9
        self.logits_shape = tuple(logits.shape)
        self.kept = []                # a prefill starts the sequence anew
        self._keep(logits)
        self.out = [self.toks]
        self.pos = self.prompt_len
        return dt

    def _capture(self) -> _DecodeGraph:
        """Capture the decode step of the current step functions on the
        server's capture stream: one warm-up step first, on that stream
        (its launches are real and counted), so that what is created at
        first use on a stream (the decode kernel's arrival counters, library
        workspaces) exists before the capture. The warm-up's writes to the
        cache are undone before the capture: a recurrent state advanced
        twice for one token would be wrong. The capture launches nothing:
        the counts it took are moved to the graph, which adds them at each
        replay."""
        t0 = time.perf_counter_ns()
        rec = self.recorder
        if rec is not None:
            top = rec.open("serve.capture", t0)
            rec.open("serve.capture.warmup", t0)
        fns, s = self._fns, self._stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            saved = [{k: t.clone() for k, t in layer.items()}
                     for layer in self.cache]
            fns.decode(self.params, self.cache, self._step_batch(),
                       self._pos)
            for layer, old in zip(self.cache, saved):
                for k, t in layer.items():
                    t.copy_(old[k])
            del saved
        if rec is not None:
            rec.then("serve.capture.graph")
        before = kernel_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=s):
            logits, _ = fns.decode(self.params, self.cache,
                                   self._step_batch(), self._pos)
            toks = torch.argmax(logits, -1)
        held = {k: v - before[k] for k, v in kernel_launches().items()}
        _set_kernel_launches(before)
        self.captures += 1
        t1 = time.perf_counter_ns()
        if rec is not None:
            rec.close(top, t1)
        self.capture_s.append((t1 - t0) / 1e9)
        return _DecodeGraph(graph, logits, toks, held,
                            list(kfd._counters.values()))

    def decode_step(self) -> float:
        """One greedy decode step over the held state; returns seconds."""
        t0 = time.perf_counter_ns()
        rec = self.recorder
        if rec is not None:
            top = rec.open("serve.decode_step", t0,
                           step=self.pos - self.prompt_len)
            rec.open("serve.decode.issue", t0)
        with torch.inference_mode():
            self._tokens.copy_(self.toks[:, None])
            self._pos.fill_(self.pos)
            if self.device.type == "cuda":
                if self._fns.graph is None:
                    self._fns.graph = self._capture()
                graph = self._fns.graph
                if rec is not None:
                    rec.device_start(top)
                graph.replay()
                if rec is not None:
                    rec.device_stop(top)
                    rec.then("serve.decode.sync")
                logits, self.toks = graph.logits, graph.toks.clone()
            else:
                logits, _ = self.decode(self.params, self.cache,
                                        self._step_batch(), self._pos)
                if rec is not None:
                    rec.then("serve.decode.sync")
                self.toks = torch.argmax(logits, -1)
        self._sync()
        t1 = time.perf_counter_ns()
        if rec is not None:
            rec.close(top, t1)
        dt = (t1 - t0) / 1e9
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
                          cache_cap: int, batch: int,
                          store: Optional[str] = None,
                          log=print) -> KernelConfig:
    """The kernel dispatch of a server: flash and decode on, with the
    built-in blocks or, from ``store``, the best tuned blocks for this
    device that fit the server's shapes (the records of its own cells at
    ``batch`` first; the decode cell at the attention layers' own cache
    capacity, a windowed layer's ``min(cap, window)``). Only the kernels
    the config's layers reach (:func:`kernel_paths`) are resolved and
    checked. On the card, flash blocks that do not tile the prompt shrink
    to the largest that do, and a shape no blocks serve raises
    ValueError; on the CPU the plain versions take any blocks."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = H // KV
    dtype = DTYPES[cfg.dtype]
    paths = kernel_paths(cfg)
    dcap = M.attention_cache_cap(cfg, cache_cap)
    kc = KernelConfig(use_flash=True, use_decode=True)
    if store:
        kind = tuning.device_kind(device)
        if "flash" in paths:
            hit = tuning.kernel_config_from_store(
                store, S=prompt_len, hd=hd, dtype=dtype, device=kind,
                base=kc, shape_sig=tuning.flash_shape_sig(batch, prompt_len,
                                                          H, hd, KV))
            if hit is None:
                log("[serve] no usable flash (prefill) kernel record in "
                    f"store — default blocks ({kc.flash_block_q}, "
                    f"{kc.flash_block_kv})")
            else:
                kc = hit
                log(f"[serve] tuned flash (prefill) blocks from store: "
                    f"block_q={kc.flash_block_q} "
                    f"block_kv={kc.flash_block_kv}")
        if "decode" in paths:
            hit = tuning.decode_kernel_config_from_store(
                store, cache_cap=dcap, H=H, KV=KV, hd=hd, device=kind,
                base=kc, shape_sig=tuning.decode_shape_sig(batch, dcap, H,
                                                           KV, hd))
            if hit is None:
                log("[serve] no usable decode kernel record in store — "
                    f"default blocks (block_kv={kc.decode_block_kv}, "
                    f"num_splits={kc.decode_num_splits})")
            else:
                kc = hit
                log(f"[serve] tuned decode blocks from store: "
                    f"block_kv={kc.decode_block_kv} "
                    f"num_splits={kc.decode_num_splits} "
                    f"combine={kc.decode_combine}")
    if device.type != "cuda":
        return kc
    if "flash" in paths:
        bq, bkv = (_fit_block(b, prompt_len)
                   for b in (kc.flash_block_q, kc.flash_block_kv))
        if bq is None or bkv is None:
            raise ValueError(f"the flash kernel tiles a prefill in "
                             f"{kfa.SUB_TILE}-row sub-tiles: a prompt of "
                             f"{prompt_len} is not a multiple of "
                             f"{kfa.SUB_TILE}")
        if (bq, bkv) != (kc.flash_block_q, kc.flash_block_kv):
            log(f"[serve] flash blocks ({kc.flash_block_q}, "
                f"{kc.flash_block_kv}) do not tile a prompt of "
                f"{prompt_len}: ({bq}, {bkv})")
            kc = kc.replace(flash_block_q=bq, flash_block_kv=bkv)
        if not ops.flash_valid({"block_q": bq, "block_kv": bkv}, hd, dtype):
            raise ValueError(f"the flash kernel does not take hd={hd} with "
                             f"blocks ({bq}, {bkv}) in {dtype}")
    if "decode" in paths and not ops.decode_valid(
            {"block_kv": kc.decode_block_kv}, G, hd):
        raise ValueError(f"the decode kernel does not take hd={hd}, G={G}")
    return kc


def kernel_sources(store: str, cfg, *, batch: int, prompt_len: int,
                   cache_cap: int, device: torch.device,
                   swap_margin: float = 0.0,
                   log=print) -> List[HotConfigSource]:
    """Live sources over the server's kernel cells that its layers reach
    (:func:`kernel_paths`), the flash (prefill) cell at its prompt and the
    decode cell at its attention layers' cache capacity, in the model's
    dtype, each refreshed once (the startup resolution). A shape whose cell
    has no config space (a prompt no flash block tiles) has no source:
    logged and skipped, as the reference does."""
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    dtype = DTYPES[cfg.dtype]
    paths = kernel_paths(cfg)
    dcap = M.attention_cache_cap(cfg, cache_cap)
    cells = []
    for path, make, args, kw in (
            ("flash", tuning.flash_cell,
             (batch, prompt_len, cfg.num_heads, hd), {"KV": KV}),
            ("decode", tuning.decode_cell,
             (batch, dcap, cfg.num_heads, KV, hd), {})):
        if path not in paths:
            continue
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
    ap.add_argument("--trace", action="store_true",
                    help="record the server's spans and print what they "
                         "say after the launch counts")
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
                                 mesh=tuning.device_kind(device),
                                 swap_margin=args.swap_margin)
        hit = source.refresh()
        if hit is None:
            print(f"[serve] no tuning record for {source.objective_id} in "
                  f"{args.store} — using built-in defaults")
        else:
            print(f"[serve] tuned config from store ({hit[1]:.3f}s "
                  f"roofline): {hit[0]}")
            pcfg = apply_sharding_config(pcfg, hit[0])
    elif args.store:
        pcfg = resolve_pcfg(pcfg, args.store, args.arch, args.tuned_shape,
                            mesh=tuning.device_kind(device))
    if device.type == "cuda" or args.kernels:
        pcfg = pcfg.replace(kernel=serving_kernel_config(
            cfg, device=device, prompt_len=args.prompt_len,
            cache_cap=cache_cap, store=args.store if args.kernels else None,
            batch=args.batch))
    ksources = []
    if args.online and args.kernels:
        ksources = kernel_sources(args.store, cfg, batch=args.batch,
                                  prompt_len=args.prompt_len,
                                  cache_cap=cache_cap, device=device,
                                  swap_margin=args.swap_margin)

    server = DecodeServer(cfg, pcfg, batch=args.batch,
                          prompt_len=args.prompt_len,
                          decode_steps=args.decode_steps, seed=args.seed,
                          device=device, trace=args.trace)
    batch = server.input_batch()
    reset_kernel_launches()
    dt_prefill = server.prefill_batch(batch)
    n_prefill = kernel_launches()
    print(f"[serve] {cfg.name} on {device}: prefill B={args.batch} "
          f"S={args.prompt_len}: {dt_prefill * 1e3:.1f} ms, logits "
          f"{server.logits_shape}; dispatch: {server.prefill_dispatch}")
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
          f"{args.batch / med:.1f} tokens/s; dispatch: "
          f"{server.decode_dispatch}")
    print(f"[serve] kernel launches: prefill {n_prefill}, all {launches}; "
          f"decode graphs captured {server.captures}")
    print("[serve] sample tokens:", [int(t[0]) for t in server.out][:12])
    out.update(step_s=steps, launches=launches)
    if args.trace:
        out["trace"] = print_trace(server, batch)
    return out


#: what ``--trace`` prints, in order
TRACE_READINGS = (
    ("decode_issue_ms", "decode issue {:.3f} ms (median)"),
    ("decode_device_ms", "decode device {:.3f} ms (median replay)"),
    ("prefill_copy_ms", "prefill cache copy {:.3f} ms (device)"),
    ("device_idle_pct", "device idle {:.2f}% of the batch"),
    ("decode_kernels", "decode kernels {} a step"))


def print_trace(server: DecodeServer, batch) -> Dict[str, float]:
    """Print and return the readings of a traced server
    (:func:`repro_torch.launch.spans.readings`; off the card only the host's
    ``decode_issue_ms``) over one more batch of ``batch``, whose decode
    steps replay the graph the first batch captured. On the card a third
    prefill follows, then one decode step under ``torch.profiler`` for
    ``decode_kernels``, the device operations a decode step starts. Then
    the median self time of each span of that batch and of the capture's
    spans, and the counts: prefills, decode steps and replays by the
    spans, the step functions' cache and the library's build seconds."""
    rec = server.recorder
    server.prefill_batch(batch)
    for _ in range(server.cache_cap - server.prompt_len):
        server.decode_step()
    read = rec.batch
    got = readings(rec.spans, batches={read})
    if server.device.type == "cuda" and server.cache_cap > server.prompt_len:
        from torch.profiler import ProfilerActivity, profile
        server.prefill_batch(batch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            server.decode_step()
        got["decode_kernels"] = step_kernels(
            prof.profiler.kineto_results.events())
    shown = [fmt.format(got[key]) for key, fmt in TRACE_READINGS
             if got.get(key) is not None]
    print("[serve] trace: " + ("; ".join(shown) or "no decode step"))
    own = self_ms(rec.spans, batches={read})
    own.update((k, v) for k, v in self_ms(rec.spans).items()
               if k.startswith("serve.capture"))
    print("[serve] self ms (median): "
          + "; ".join(f"{k} {v:.3f}" for k, v in own.items()))
    steps = [s for s in rec.spans if s.name == "serve.decode_step"]
    n = kernel_launches()
    print(f"[serve] counts: prefills {rec.batch}, decode steps {len(steps)}"
          f", replays {sum(s.device_ms is not None for s in steps)}; "
          f"decode kernel launches {n['flash_decode_split']}, of them with "
          f"its K/V ring {n['flash_decode_ring']}; "
          f"step functions {server.kernel_cache.stats()}; kernels' library "
          f"build {_build.build_seconds:.1f} s (0 where loaded or unused)")
    return got


if __name__ == "__main__":
    main()
