"""In-process CUDA kernel autotuning cells (DESIGN.md §14).

Port of ``repro/kernels/tuning.py``. This is the source paper's literal
problem — tune GPU kernel parameters (thread-block tile shapes) with BO
against measured runtimes — run for real on the card: the tunable cells are
the port's own hand-written CUDA kernels (gemm ``block_m/n/k``, matern_gp
``block_n``, flash attention ``block_q/kv``, flash decode ``block_kv``,
``num_splits`` and the combine), the objective is the kernel's time
measured with CUDA events, and a config the Hopper resource model rejects,
or that the card refuses to launch, is the paper's invalid configuration:
journaled as NaN, never fed to the surrogate.

Runs journal into the ``TuningRecordStore`` under ``kernel[name×shape×
device]`` fingerprints, where the device is a normalized card name, so a
CPU record or a TPU record never resolves on the H100. The gp cell closes
the self-hosting loop: its tuned ``block_n`` feeds the tuner's own §III-G
exhaustive-prediction loop (``IncrementalGP(backend="cuda")``).

Entry points run on the card unless the caller passes ``device="cpu"``
(the plain kernel versions, for tests); left at the default with no CUDA
device present they raise. The serve path reads tuned flash and decode
blocks back with ``kernel_config_from_store`` and
``decode_kernel_config_from_store``: the server's own cell's record where
the store has one, else, as the reference does, the best record over every
cell of the kernel. ``default_cells`` is the
reference benchmark's four-cell matrix at the reference's shapes.
"""
from __future__ import annotations

import math
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.objectives import Objective
from repro_torch.core.searchspace import SearchSpace
from repro_torch.kernels import _build, ops


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; None means the card, and raises when
    no CUDA device is present rather than running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "passes device='cpu'")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def device_kind(device=None) -> str:
    """Device context kernel timings are keyed under: ``"cpu"`` or the
    normalized card name (``cuda-NVIDIA_H100_80GB_HBM3``), free of ``:``,
    ``×``, ``]`` and spaces so it embeds in a ``kernel[...]`` key. With no
    argument: the card when one is present, else ``"cpu"``."""
    if device is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    return card_kind(torch.cuda.get_device_name(dev))


def card_kind(card_name: str) -> str:
    """The device kind of a card named as ``torch.cuda.get_device_name``
    names it (``NVIDIA H100 80GB HBM3`` -> ``cuda-NVIDIA_H100_80GB_HBM3``),
    with no card present: what :func:`device_kind` gives on that card."""
    return "cuda-" + re.sub(r"[^A-Za-z0-9_.-]", "_", card_name)


def kernel_cell_objective(kernel: str, shape_sig: str,
                          device: Optional[str] = None) -> str:
    """Objective id of one kernel-tuning cell, mirroring the sharding cells'
    ``dryrun[arch×shape×mesh]`` convention: ``kernel[name×shape×device]``."""
    return f"kernel[{kernel}×{shape_sig}×{device or device_kind()}]"


@dataclass
class KernelCell:
    """One tunable kernel at one problem shape on one device.

    ``run(cfg)`` launches the kernel under a block config and returns its
    output; ``valid(cfg)`` is the static Hopper resource model (threads,
    shared memory, registers, tiling). ``default`` is the block config the
    kernel uses untuned — the thing tuning must beat.
    """

    kernel: str
    shape_sig: str
    space: SearchSpace
    run: Callable[[Dict[str, Any]], Any]
    valid: Callable[[Dict[str, Any]], bool]
    default: Dict[str, Any]
    device: torch.device
    meta: Dict[str, Any] = field(default_factory=dict)

    def objective_id(self) -> str:
        return kernel_cell_objective(self.kernel, self.shape_sig,
                                     device_kind(self.device))


# -- cell factories ----------------------------------------------------------


def gemm_cell(M: int = 512, N: int = 512, K: int = 512,
              dtype=torch.float32, device=None, seed: int = 0) -> KernelCell:
    """The paper's GEMM target at one problem shape. The default block
    config is {128, 128, 64}: the reference's 256³ default needs 512 KiB of
    fp32 tiles, over Hopper's 227 KB of shared memory per block."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(M, K))).to(dev, dtype)
    b = torch.from_numpy(rng.normal(size=(K, N))).to(dev, dtype)
    dtype_bytes = torch.empty((), dtype=dtype).element_size()

    def run(cfg):
        return ops.gemm(a, b, block_m=cfg["block_m"], block_n=cfg["block_n"],
                        block_k=cfg["block_k"])

    def valid(cfg):
        aligned = (M % cfg["block_m"] == 0 and N % cfg["block_n"] == 0
                   and K % cfg["block_k"] == 0)
        return aligned and ops.gemm_valid(cfg, dtype_bytes)

    return KernelCell(
        kernel="gemm", shape_sig=f"{M}x{N}x{K}",
        space=ops.gemm_config_space(M, N, K), run=run, valid=valid,
        default={"block_m": 128, "block_n": 128, "block_k": 64}, device=dev,
        meta={"M": M, "N": N, "K": K, "dtype_bytes": dtype_bytes,
              "inputs": (a, b)})


def flash_shape_sig(B: int, S: int, H: int, hd: int, KV: int) -> str:
    """The flash cell's shape key: the reference's, plus ``_KV{KV}`` when
    KV < H."""
    return f"B{B}_S{S}_H{H}_hd{hd}" + (f"_KV{KV}" if KV != H else "")


def decode_shape_sig(B: int, S: int, H: int, KV: int, hd: int) -> str:
    """The decode cell's shape key, the reference's."""
    return f"B{B}_S{S}_H{H}_KV{KV}_hd{hd}"


def flash_cell(B: int = 1, S: int = 1024, H: int = 4, hd: int = 64,
               KV: Optional[int] = None, dtype=torch.float32,
               causal: bool = True, device=None,
               seed: int = 0) -> KernelCell:
    """Prefill attention at one shape, causal unless ``causal=False``
    (the reference's full mode; as there, the shape key does not name
    it). ``KV`` (default H) is the
    number of KV heads the kernel reads; the shape key is the reference's, plus
    ``_KV{KV}`` when KV < H. The default {128, 128} fits every head dim the
    kernel takes (the reference's 512 / 512 needs 590 KB at hd 256)."""
    dev = resolve_device(device)
    KV = H if KV is None else KV
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd))).to(dev, dtype)
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(dev, dtype)
            for _ in range(2))
    dtype_bytes = torch.empty((), dtype=dtype).element_size()

    def run(cfg):
        return ops.flash_attention(q, k, v, block_q=cfg["block_q"],
                                   block_kv=cfg["block_kv"], causal=causal)

    def valid(cfg):
        aligned = S % cfg["block_q"] == 0 and S % cfg["block_kv"] == 0
        return aligned and ops.flash_valid(cfg, hd, dtype)

    return KernelCell(
        kernel="flash", shape_sig=flash_shape_sig(B, S, H, hd, KV),
        space=ops.flash_config_space(S), run=run, valid=valid,
        default={"block_q": 128, "block_kv": 128}, device=dev,
        meta={"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
              "causal": causal, "dtype_bytes": dtype_bytes,
              "inputs": (q, k, v)})


def decode_cell(B: int = 4, S: int = 2048, H: int = 8, KV: int = 2,
                hd: int = 64, fill: float = 0.95,
                window: Optional[int] = None, dtype=torch.float32,
                device=None, seed: int = 0) -> KernelCell:
    """The per-token serve hot path: split-KV flash decode over a KV cache
    of capacity ``S`` at ``fill`` occupancy (empty slots carry
    ``cache_pos = -1`` exactly like a live server's cache). Shape key =
    batch × capacity × heads × KV heads × head dim, as the reference's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, hd))).to(dev, dtype)
    k = torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(dev, dtype)
    v = torch.from_numpy(rng.normal(size=(B, S, KV, hd))).to(dev, dtype)
    cur = max(int(S * fill) - 1, 0)
    pos = np.where(np.arange(S) <= cur, np.arange(S), -1)
    cache_pos = torch.from_numpy(np.broadcast_to(pos, (B, S)).copy()).to(dev)
    cur_pos = torch.full((B,), cur, dtype=torch.long, device=dev)
    dtype_bytes = torch.empty((), dtype=dtype).element_size()
    G = H // max(KV, 1)
    #: the validity bias is an input of the cell, built once per tile
    biases: Dict[int, torch.Tensor] = {}

    def run(cfg):
        tile = cfg["block_kv"] * cfg["num_splits"]
        if tile not in biases:
            biases[tile] = ops.decode_bias(cache_pos, cur_pos, window, tile)
        return ops.decode_attention(q, k, v, cache_pos, cur_pos,
                                    window=window, block_kv=cfg["block_kv"],
                                    num_splits=cfg["num_splits"],
                                    combine=cfg["combine"],
                                    bias=biases[tile])

    def valid(cfg):
        # padding tiles any capacity, but splits past the cache are pure
        # combine overhead — the alignment face of the resource model
        covered = cfg["block_kv"] * (cfg["num_splits"] - 1) < S
        return covered and ops.decode_valid(cfg, G, hd)

    return KernelCell(
        kernel="decode", shape_sig=decode_shape_sig(B, S, H, KV, hd),
        space=ops.decode_config_space(S), run=run, valid=valid,
        default={"block_kv": 512, "num_splits": 1, "combine": "kernel"},
        device=dev,
        meta={"B": B, "S": S, "H": H, "KV": KV, "hd": hd, "fill": fill,
              "window": window, "dtype_bytes": dtype_bytes,
              "inputs": (q, k, v, cache_pos, cur_pos)})


def gp_cell(N: int = 4096, T: int = 128, d: int = 15, t_obs: int = 37,
            nu: str = "matern32", ell: float = 2.0, device=None,
            seed: int = 0) -> KernelCell:
    """The self-hosting cell: the tuner's own §III-G exhaustive-prediction
    loop, as a tuning target. Inputs are a real packaged IncrementalGP
    state (t_obs observations over an N-candidate panel)."""
    from repro_torch.core.gp_fast import IncrementalGP
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Xc = rng.random((N, d)).astype(np.float32)
    g = IncrementalGP(Xc, max_obs=max(t_obs, 1), kernel=nu, ell=ell)
    for _ in range(t_obs):
        g.add(Xc[rng.integers(N)], float(rng.normal(10, 2)))
    x_obs, vinv, w, mask, _, _ = ops.gp_inputs_from_incremental(g, pad_T=T)
    args = tuple(torch.from_numpy(x).to(dev)
                 for x in (Xc, x_obs, vinv, w, mask))

    def run(cfg):
        return ops.gp_posterior(*args, ell=ell, nu=nu,
                                block_n=cfg["block_n"])

    def valid(cfg):
        return N % cfg["block_n"] == 0 and ops.gp_valid(cfg, T, d)

    return KernelCell(
        kernel="gp", shape_sig=f"N{N}_T{T}_d{d}",
        space=ops.gp_config_space(N), run=run, valid=valid,
        default={"block_n": 512}, device=dev,
        meta={"N": N, "T": T, "d": d, "t_obs": t_obs, "nu": nu, "ell": ell,
              "inputs": args})


def default_cells(smoke: bool = False, device=None) -> Tuple[KernelCell, ...]:
    """The reference's standard four-cell matrix (its
    ``benchmarks/kernel_tuning.py`` runs it), at its shapes: all of them hd
    64 and at most 2 query heads per KV head, so every cell runs on the
    CUDA kernels."""
    if smoke:
        return (gemm_cell(256, 256, 256, device=device),
                flash_cell(1, 512, 2, 64, device=device),
                decode_cell(1, 512, 4, 2, 64, device=device),
                gp_cell(2048, 128, 15, device=device))
    return (gemm_cell(512, 512, 512, device=device),
            flash_cell(1, 1024, 4, 64, device=device),
            decode_cell(4, 2048, 8, 2, 64, device=device),
            gp_cell(4096, 128, 15, device=device))


# -- the measured objective --------------------------------------------------

_spin_rates: Dict[int, float] = {}


def _spin_rate(device: torch.device) -> float:
    """Cycles a second of ``torch.cuda._sleep`` on ``device``, timed once
    with CUDA events."""
    idx = torch.cuda._get_device_index(device, optional=True)
    if idx not in _spin_rates:
        cycles = 1 << 22
        with torch.cuda.device(idx):
            torch.cuda._sleep(cycles)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            torch.cuda._sleep(cycles)
            t1.record()
            t1.synchronize()
        _spin_rates[idx] = cycles / (t0.elapsed_time(t1) * 1e-3)
    return _spin_rates[idx]



class KernelObjective(Objective):
    """Measured kernel time (seconds, lower better).

    The Hopper resource model is checked FIRST: a config over the card's
    threads, shared memory or registers, or that mis-tiles the problem,
    returns NaN without running — the paper's invalid configuration,
    journaled by the runner, skipped by the surrogate. A config the model
    passes but the card refuses to launch (``cudaErrorLaunchOutOfResources``
    or ``cudaErrorInvalidConfiguration``) is likewise NaN. Any other CUDA
    error is raised, never journaled: a fault such as an illegal address
    poisons the context.

    The value is one call's time, as the reference's is. On the card, after
    ``warmup`` runs, each of ``reps`` reps times ``n`` back-to-back launches
    between one pair of CUDA events and divides by ``n``; the best rep
    counts. One launch timed alone is mostly the host's launch for kernels
    of 0.01-0.2 ms, so ``n`` is taken from one more timed launch: enough to
    fill about ``TARGET_S``, at least 1 and at most ``MAX_LAUNCHES`` (a
    2.4 ms GEMM keeps n = 1). The n launches queue behind a spin on the
    card (``torch.cuda._sleep``) twice as long as the host takes to issue
    them, so the events see the card's time and not the host's pace. On
    the CPU (``device="cpu"``, tests) each rep times one call of the plain
    version with the host clock.
    """

    #: the span a rep's back-to-back launches should fill, and their cap
    TARGET_S = 1e-3
    MAX_LAUNCHES = 64
    #: the shortest spin the launches queue behind
    LEAD_MIN_S = 5e-5

    def __init__(self, cell: KernelCell, *, reps: int = 3, warmup: int = 1,
                 device=None, verbose: bool = False):
        dev = resolve_device(device)
        if dev.type != cell.device.type:
            raise ValueError(f"objective on {dev}, cell tensors on "
                             f"{cell.device}")
        self.cell = cell
        self.space = cell.space
        self.device = dev
        self.name = cell.objective_id()
        self.reps = max(int(reps), 1)
        self.warmup = max(int(warmup), 1)
        self.verbose = verbose
        #: a CUDA context must not be shipped to a worker process, and
        #: concurrent launches would share the card's time
        self.in_process_only = dev.type == "cuda"

    def _time_once(self, cfg, n: int = 1, lead_s: float = 0.0) -> float:
        """One rep: seconds per call over ``n`` back-to-back launches
        between one pair of CUDA events, queued behind a spin of ``lead_s``
        seconds; on the CPU, one call."""
        if self.device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            if lead_s > 0:
                torch.cuda._sleep(int(lead_s * _spin_rate(self.device)))
            t0.record()
            for _ in range(n):
                self.cell.run(cfg)
            t1.record()
            t1.synchronize()
            return t0.elapsed_time(t1) * 1e-3 / n
        t0 = time.perf_counter()
        self.cell.run(cfg)
        return time.perf_counter() - t0

    def _rep_plan(self, cfg) -> Tuple[int, float]:
        """``(n, lead_s)`` for the card's reps: ``n`` from one timed launch
        after the warm-up, the spin from the host's time to issue a call."""
        if self.device.type != "cuda":
            return 1, 0.0
        h0 = time.perf_counter()
        self.cell.run(cfg)
        host = time.perf_counter() - h0
        torch.cuda.synchronize(self.device)
        one = self._time_once(cfg)
        n = max(1, min(self.MAX_LAUNCHES,
                       math.ceil(self.TARGET_S / max(one, 1e-9))))
        return n, 2.0 * host * n + self.LEAD_MIN_S

    def __call__(self, idx: int) -> float:
        cfg = self.space.config(int(idx))
        if not self.cell.valid(cfg):
            if self.verbose:
                print(f"  [kernel-tune] {cfg} -> INVALID (resource model)")
            return math.nan
        try:
            for _ in range(self.warmup):
                self.cell.run(cfg)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            n, lead = self._rep_plan(cfg)
            best = min(self._time_once(cfg, n, lead)
                       for _ in range(self.reps))
        except _build.LaunchRefused as e:         # runtime-discovered invalid
            if self.verbose:
                print(f"  [kernel-tune] {cfg} -> INVALID ({e})")
            return math.nan
        if self.verbose:
            print(f"  [kernel-tune] {cfg} -> {best*1e3:.3f} ms "
                  f"({n} launches a rep)")
        return best


# -- store integration -------------------------------------------------------


def run_kernel_tuning(cell: KernelCell, store=None, *, budget: int = 12,
                      init: int = 4, seed: int = 0, reps: int = 3,
                      warm_start: bool = True, device=None,
                      gp_backend: Optional[str] = None, gp_block_n: int = 512,
                      verbose: bool = False):
    """Tune one kernel cell with the standard BO engine, journaling into the
    shared store under the cell's ``kernel[...]`` fingerprint. The BO
    surrogate runs on the card's GP kernel (``gp_backend="cuda"``) when the
    cell does, on numpy otherwise. Returns the engine's TuneResult."""
    from repro_torch.core.runner import run_strategy
    from repro_torch.core.strategies.bo import BOConfig, BOStrategy
    obj = KernelObjective(cell, reps=reps, device=device, verbose=verbose)
    if gp_backend is None:
        gp_backend = "cuda" if obj.device.type == "cuda" else "numpy"
    n_init = min(init, budget)
    strat = BOStrategy(BOConfig(initial_samples=n_init, gp_backend=gp_backend,
                                gp_block_n=gp_block_n,
                                gp_device=str(obj.device)))
    run_id = f"kernel_{cell.kernel}_{cell.shape_sig}-s{seed}"
    return run_strategy(strat, obj, budget=budget, seed=seed, store=store,
                        run_id=run_id, warm_start=warm_start)


def best_kernel_config(store, kernel: str, shape_sig: Optional[str] = None,
                       device: Optional[str] = None
                       ) -> Optional[Tuple[Dict[str, Any], float]]:
    """Best stored (block config, measured time) for a kernel cell.

    ``device`` is a device-kind key (``device_kind()``), defaulting to this
    host's. ``shape_sig=None`` relaxes to any tuned shape of this kernel on
    this device (minimum over cells). Returns None on a cold store."""
    from repro_torch.store.records import TuningRecordStore
    if isinstance(store, str):
        if not os.path.exists(store):
            return None
        store = TuningRecordStore(store, lazy=True)
    device = device or device_kind()
    want = (kernel_cell_objective(kernel, shape_sig, device)
            if shape_sig is not None else None)
    prefix = f"kernel[{kernel}×"
    suffix = f"×{device}]"
    best: Optional[Tuple[Dict[str, Any], float]] = None
    for digest, desc in store.fingerprints().items():
        obj = desc.objective
        if want is not None:
            if obj != want:
                continue
        elif not (obj.startswith(prefix) and obj.endswith(suffix)):
            continue
        hit = store.best_config(digest)
        if hit is not None and (best is None or hit[1] < best[1]):
            best = hit
    return best


def tuned_gp_block_n(store, N: Optional[int] = None, T: Optional[int] = None,
                     d: Optional[int] = None, device: Optional[str] = None,
                     default: int = 512) -> int:
    """Tuned matern_gp ``block_n`` for the self-hosted GP backend; the
    kernel default on a cold store. ``N`` (candidate count) filters to
    blocks that could tile it; ``T``/``d`` (padded observations, dimension)
    to blocks the resource model says this problem can run. Raises when
    not even the default can run at that ``T``."""
    hit = best_kernel_config(store, "gp", None, device)
    bn = default if hit is None else int(hit[0]["block_n"])
    if N is not None and bn > N:
        bn = default
    if T is not None:
        dim = 16 if d is None else d
        if not ops.gp_valid({"block_n": bn}, T, dim):
            bn = default
        if not ops.gp_valid({"block_n": bn}, T, dim):
            raise ValueError(f"no block_n runs the GP kernel at T={T}, "
                             f"d={dim} on this card's resources")
    return bn


def _stored(store, kernel: str, shape_sig: str, device: Optional[str],
            usable: Callable[[Dict], bool]):
    """The best stored config of the server's own cell (``shape_sig``)
    where the store has one that ``usable`` takes, else the best over every
    cell of the kernel on this device, as the reference resolves it (times
    of cells at other shapes are not comparable, so the own cell comes
    first). None when neither is usable."""
    for sig in (shape_sig, None):
        hit = best_kernel_config(store, kernel, sig, device)
        if hit is not None and usable(hit[0]):
            return hit[0]
    return None


def kernel_config_from_store(store, *, S: int, hd: int, dtype: torch.dtype,
                             shape_sig: str, device: Optional[str] = None,
                             base=None):
    """A ``KernelConfig`` with the best stored flash (prefill) blocks for a
    server's prompt length ``S``, head dim ``hd`` and activation ``dtype``,
    overlaid on ``base``: those of its own cell ``shape_sig`` where stored.
    None when the store has no record whose blocks tile ``S`` and pass the
    resource model on this device (the caller keeps its defaults)."""
    from repro_torch.parallel.sharding import KernelConfig

    def usable(cfg):
        bq, bkv = int(cfg["block_q"]), int(cfg["block_kv"])
        # blocks that tile this server's S and pass the resource model
        return (S % bq == 0 and S % bkv == 0 and ops.flash_valid(
            {"block_q": bq, "block_kv": bkv}, hd, dtype))

    cfg = _stored(store, "flash", shape_sig, device, usable)
    if cfg is None:
        return None
    base = base if base is not None else KernelConfig()
    return base.replace(use_flash=True, flash_block_q=int(cfg["block_q"]),
                        flash_block_kv=int(cfg["block_kv"]))


def decode_kernel_config_from_store(store, *, cache_cap: int, H: int, KV: int,
                                    hd: int, shape_sig: str,
                                    device: Optional[str] = None, base=None):
    """Tuned decode blocks for a server's cache shape, overlaid on ``base``
    (so one ``KernelConfig`` carries tuned flash AND decode blocks): those
    of its own cell ``shape_sig`` where stored. None when no stored record
    is usable for this cache."""
    from repro_torch.parallel.sharding import KernelConfig

    def usable(cfg):
        bkv, ns = int(cfg["block_kv"]), int(cfg["num_splits"])
        # splits that do not overhang this server's cache, blocks that pass
        # the resource model
        return (bkv * (ns - 1) < cache_cap and ops.decode_valid(
            {"block_kv": bkv}, H // max(KV, 1), hd))

    cfg = _stored(store, "decode", shape_sig, device, usable)
    if cfg is None:
        return None
    bkv, ns = int(cfg["block_kv"]), int(cfg["num_splits"])
    base = base if base is not None else KernelConfig()
    return base.replace(use_decode=True, decode_block_kv=bkv,
                        decode_num_splits=ns,
                        decode_combine=str(cfg["combine"]))
