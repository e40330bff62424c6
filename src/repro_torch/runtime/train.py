"""Fault-tolerant training loop.

Port of ``repro/runtime/train.py``, on one device or on a device mesh:
  * checkpoint/restart — async checkpoints every N steps carrying params,
    optimizer state and the data cursor; `TrainLoop` restores from the
    latest manifest automatically (crash → rerun the same command);
  * straggler mitigation — per-step wall time tracked against an EWMA; steps
    slower than `straggler_factor ×` EWMA are logged as straggler events and
    surface in metrics (the first step, which on the card includes the
    kernels' first launches, seeds nothing);
  * elastic rescale — checkpoints hold whole tensors; restoring onto a
    different mesh, or onto none, places them anew
    (``ckpt.restore_sharded``), so the same job continues at another scale;
  * failure injection — `fail_at_step` raises mid-run to exercise all of the
    above in tests.
Weights come from a ``torch.Generator`` seeded with ``LoopConfig.seed`` on
the loop's device, which is the card unless the caller passes
``device="cpu"``. With ``mesh`` (a ``DeviceMesh`` of the process group's
ranks, ``launch/mesh.make_host_mesh``) every rank makes the same weights
from the seed and keeps its slice of each, placed by ``param_shardings``;
the moments follow their weights, and each batch leaf is placed by its
logical axes (``stepfn.BATCH_AXES``), as the reference places them.
AdamW keeps fp32 moments whatever ``ParallelConfig.opt_moment_dtype``
says, as the reference's loop builds it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.arch import ArchConfig
from repro_torch.data.pipeline import DataConfig, DataIterator, make_source
from repro_torch.kernels.tuning import resolve_device
from repro_torch.models.params import (init_params, leaves, map_tree,
                                       model_specs, shard_params)
from repro_torch.models.stepfn import make_train_step, place_batch
from repro_torch.optim.optimizers import AdamW, warmup_cosine
from repro_torch.parallel.sharding import ParallelConfig, ShardCtx


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    fail_at_step: Optional[int] = None     # failure injection (tests/demo)
    peak_lr: float = 3e-3
    warmup: int = 100


@dataclass
class LoopMetrics:
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    straggler_events: List[int] = field(default_factory=list)
    restored_from: Optional[str] = None
    start_step: int = 0


class TrainLoop:
    def __init__(self, arch: ArchConfig, data_cfg: DataConfig,
                 loop_cfg: LoopConfig, pcfg: Optional[ParallelConfig] = None,
                 device=None, mesh=None):
        self.arch = arch
        self.data_cfg = data_cfg
        self.loop_cfg = loop_cfg
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a loop on "
                             f"{self.device}")
        self.pcfg = pcfg or ParallelConfig(flash_threshold=1 << 30,
                                           logits_chunk=0)
        self.mesh = mesh
        self.px = ShardCtx(mesh=mesh, pcfg=self.pcfg)
        # a warmup longer than the whole run would cap LR at a fraction of
        # peak (sub-bf16-resolution updates on short smoke runs: nothing
        # learns). Only the degenerate case is clamped — an explicit warmup
        # that fits inside the run is honored as configured.
        warmup = (max(loop_cfg.steps // 10, 1)
                  if loop_cfg.warmup >= loop_cfg.steps else loop_cfg.warmup)
        self.optimizer = AdamW(
            schedule=warmup_cosine(loop_cfg.peak_lr, warmup,
                                   max(loop_cfg.steps, 1)),
            weight_decay=0.01)
        self.metrics = LoopMetrics()

        gen = torch.Generator(device=self.device).manual_seed(loop_cfg.seed)
        self.params = init_params(arch, gen, self.device)
        if mesh is not None:
            self.params = shard_params(self.params, model_specs(arch), mesh,
                                       self.pcfg)
        self.opt_state = self.optimizer.init(self.params)
        self.data = DataIterator(make_source(data_cfg))
        self.step = 0

        if loop_cfg.ckpt_dir:
            path = ckpt.latest(loop_cfg.ckpt_dir)
            if path:
                self._restore(path)

        self._step_fn = make_train_step(arch, self.pcfg, self.optimizer,
                                        px=self.px)
        self._ckpt = (ckpt.AsyncCheckpointer(loop_cfg.ckpt_dir)
                      if loop_cfg.ckpt_dir else None)

    # -- checkpoint/restore --------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def _restore(self, path: str):
        """The checkpoint placed as the loop's own tensors are (on the
        loop's mesh, or its device), then copied into them."""
        from torch.distributed.tensor import DTensor
        targets = map_tree(lambda t: (t.device_mesh, tuple(t.placements))
                           if isinstance(t, DTensor) else t.device,
                           self._state_tree())
        state, extras = ckpt.restore_sharded(path, self._state_tree(),
                                             targets)
        for (_, dst), (_, src) in zip(leaves(self._state_tree()),
                                      leaves(state)):
            dst.copy_(src)
        self.step = int(extras["step"])
        self.data.restore(extras["data"])
        self.metrics.restored_from = path
        self.metrics.start_step = self.step

    def _save(self):
        if not self._ckpt:
            return
        self._ckpt.save(self.step, self._state_tree(),
                        extras={"step": self.step, "data": self.data.state()})

    def _to_device(self, batch_np):
        """A host batch on the loop's device: integer arrays (token ids,
        labels) as int64, the index type of torch. On a mesh each rank
        keeps its block of each leaf, placed by its logical axes
        (``stepfn.place_batch``)."""
        out = {}
        for k, v in batch_np.items():
            t = torch.from_numpy(v)
            out[k] = (t if t.is_floating_point() else t.long()).to(
                self.device)
        return place_batch(out, self.px)

    # -- main loop -------------------------------------------------------------
    def run(self) -> LoopMetrics:
        lc = self.loop_cfg
        ewma = None
        first_timed = True   # first step includes first launches — exclude
        while self.step < lc.steps:
            if lc.fail_at_step is not None and self.step == lc.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {self.step}")
            batch = self._to_device(next(self.data))
            t0 = time.time()
            self.params, self.opt_state, m = self._step_fn(
                self.params, self.opt_state, batch, self.step)
            loss = m["loss"].item()      # waits for the device's work
            dt = time.time() - t0
            self.metrics.losses.append(loss)
            self.metrics.step_times.append(dt)
            if ewma is not None and dt > lc.straggler_factor * ewma:
                self.metrics.straggler_events.append(self.step)
            if first_timed:
                first_timed = False   # first step: seed nothing
            elif ewma is None:
                ewma = dt
            else:
                ewma = lc.ewma_alpha * dt + (1 - lc.ewma_alpha) * ewma
            self.step += 1
            if lc.log_every and self.step % lc.log_every == 0:
                print(f"[train] step {self.step} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
            if self._ckpt and self.step % lc.ckpt_every == 0:
                self._save()
        if self._ckpt:
            self._save()
            self._ckpt.wait()
        return self.metrics


def run_with_restarts(make_loop: Callable[[int], TrainLoop],
                      max_restarts: int = 3) -> LoopMetrics:
    """Supervisor: restart from the latest checkpoint on failure.

    `make_loop(attempt)` builds a fresh loop; with a ckpt_dir set it restores
    automatically. Failure injection should be conditioned on `attempt` so a
    deterministic injected fault doesn't re-fire after the restart.
    """
    attempt = 0
    while True:
        loop = make_loop(attempt)
        try:
            return loop.run()
        except SimulatedFailure as e:
            # drain in-flight async checkpoint writes before the next attempt
            # scans ckpt_dir: an unfinished .tmp write is invisible to
            # latest(), so restarting immediately would lose the newest step
            if loop._ckpt is not None:
                loop._ckpt.wait()
            attempt += 1
            if attempt > max_restarts:
                raise
            print(f"[train] {e} — restarting ({attempt}/{max_restarts})")
