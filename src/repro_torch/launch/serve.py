"""Serving launcher: batched prefill + greedy decode of one model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --batch 4 --prompt-len 1024 --decode-steps 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --smoke --device cpu --batch 2 --prompt-len 16 --decode-steps 8

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

Cut from the reference, each waiting in ROADMAP: ``--online`` (store tail,
hot reload, ``ProdRecorder``, ``DriftMonitor``, the retune queue), the
sharding-config resolution (``--tuned-shape``), ``CompiledKernelCache``
(eager PyTorch has no jit to memoize: a kernel block change takes effect at
the next step) and the ``embeddings`` frontend.
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
from repro_torch.models import layers as L
from repro_torch.models.params import DTYPES, init_params
from repro_torch.models.stepfn import make_decode_step, make_prefill_step
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig


def kernel_launches() -> Dict[str, int]:
    """Launch counts of the serve path's kernels: flash attention, and the
    decode kernel's launches, all of them and those that carry the fused
    combine."""
    return {"flash_attention": kfa.launches,
            "flash_decode_split": kfd.split_launches,
            "flash_decode_combine": kfd.combine_launches}


def reset_kernel_launches() -> None:
    kfa.launches = kfd.split_launches = kfd.combine_launches = 0


class DecodeServer:
    """Data plane of one serving process: weights, KV cache, decode state
    and the step functions of its ``ParallelConfig``.

    ``params`` defaults to random weights from ``seed`` on ``device``.
    ``keep_logits`` keeps a CPU copy of the logits of the prefill and of
    the first that many decode steps (``self.kept``), for parity checks.
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
        self.cache = None
        self.toks = None
        self.out: List[torch.Tensor] = []
        self.pos = 0
        self.pcfg = pcfg
        self.prefill = make_prefill_step(cfg, pcfg, cache_cap=self.cache_cap)
        self.decode = make_decode_step(cfg, pcfg)

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
    def decode_dispatch(self) -> str:
        """Which implementation decode attention runs on."""
        hd = self.cfg.resolved_head_dim
        kc = self.pcfg.kernel
        gate = L._decode_kernel_ok(hd, hd, kc, self.device)
        combine = (" with the combine fused in"
                   if gate and kc.decode_combine == "kernel"
                   else " + tensor-op combine")
        return self._impl(gate, "flash-decode split kernel" + combine,
                          "plain decode attention")

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
        """Prefill the prompt; returns measured seconds."""
        self._sync()
        t0 = time.perf_counter()
        logits, self.cache = self.prefill(self.params, batch)
        self.toks = torch.argmax(logits, -1)
        self._sync()
        dt = time.perf_counter() - t0
        self.logits_shape = tuple(logits.shape)
        self.kept = []                # a prefill starts the sequence anew
        self._keep(logits)
        self.out = [self.toks]
        self.pos = self.prompt_len
        return dt

    def decode_step(self) -> float:
        """One greedy decode step over the held state; returns seconds."""
        t0 = time.perf_counter()
        logits, self.cache = self.decode(self.params, self.cache,
                                         {"tokens": self.toks[:, None]},
                                         self.pos)
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
                    help="tuning-record store to resolve kernel blocks from "
                         "(with --kernels)")
    ap.add_argument("--kernels", action="store_true",
                    help="resolve tuned flash and decode blocks from --store;"
                         " on the CPU, dispatch through the kernels' plain "
                         "versions")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = tuning.resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    cache_cap = args.prompt_len + args.decode_steps
    kc = None
    if device.type == "cuda" or args.kernels:
        kc = serving_kernel_config(
            cfg, device=device, prompt_len=args.prompt_len,
            cache_cap=cache_cap, store=args.store if args.kernels else None)
    pcfg = ParallelConfig(kernel=kc)

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
    steps = [server.decode_step() for _ in range(args.decode_steps)]
    launches = kernel_launches()
    med = statistics.median(steps) if steps else float("nan")
    print(f"[serve] decoded {args.decode_steps} steps x B={args.batch}: "
          f"{sum(steps) * 1e3:.1f} ms, median {med * 1e3:.2f} ms/step, "
          f"{args.batch / med:.1f} tokens/s; attention: "
          f"{server.decode_dispatch}")
    print(f"[serve] kernel launches: prefill {n_prefill}, all {launches}")
    print("[serve] sample tokens:", [int(t[0]) for t in server.out][:12])
    return {"prefill_s": dt_prefill, "step_s": steps, "launches": launches,
            "prefill_launches": n_prefill, "server": server}


if __name__ == "__main__":
    main()
