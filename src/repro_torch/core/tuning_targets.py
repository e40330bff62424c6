"""The sharding (distribution-config) tuning target of a cell.

Port of ``repro/core/tuning_targets.py``: ``sharding_space`` in its
narrow, wide and hard forms, and ``DryRunObjective``. The grids,
constraint names and space names are the reference's, so a cell's
fingerprint is the same digest in both packages and one store serves
both; the hard grid's predicates are the reference's arithmetic
(``parallel/sharding.flash_vmem_bytes``, ``attn_tile_occupancy``,
``VMEM_BYTES``), which model the TPU's VMEM and cores, not the card, and
are kept so that ``sharding_hard[...]`` digests match. The wide MoE grids
(cartesian 9·10^7 to 1.1·10^9) build as a ``GenerativeSpace``, as the
reference's do.

``DryRunObjective`` is the reference's objective, for one card or for a
production mesh of the card (``launch/mesh.PRODUCTION_MESHES``: 256 or
512 of them): a config runs ``launch/dryrun.run_cell``, and its value is
the roofline ``step_time``, NaN where the record's status is not ``ok``
or its per-card ``peak_live_bytes`` exceed the card's memory. One card
traces in process (a meta-tensor trace takes seconds); a mesh cell runs
the dry-run's CLI in a child process, as the reference's objective
does, so that its fake world of ranks never meets the caller's process
group. Its id is ``dryrun[arch×shape×<key>]`` with
``store/resolve.mesh_key``: the card's device kind
(``cuda-NVIDIA_H100_80GB_HBM3``), or the mesh before it
(``single-cuda-NVIDIA_H100_80GB_HBM3``), so a record tuned for a TPU pod
(``single``, ``multi``), for one card or for another mesh never resolves
for this one. Records are cached on disk under the reference's
``_cache_key`` scheme, that key in place of the mesh. A config becomes a
``ParallelConfig`` as the reference's does: ``_config_args`` gives the
dry-run CLI's flags, which ``launch/dryrun._pcfg_from_args`` reads;
``embed_rule`` and ``experts_rule`` become ``param_rules`` overrides
(``--rules``), which change no shape on one card (the record says so)
and the placements on a mesh.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
import subprocess
import sys
from typing import Any, Dict, List, Optional

from repro_torch.core.objectives import Objective
from repro_torch.core.searchspace import Param, SearchSpace, VectorConstraint
from repro_torch.parallel.sharding import (VMEM_BYTES, attn_tile_occupancy,
                                           flash_vmem_bytes)

REPO = os.path.join(os.path.dirname(__file__), "..", "..", "..")

#: Tokens per global batch for the train shapes — microbatching must divide it.
GLOBAL_BATCH = 32


def sharding_space(arch: str, shape: str, wide: bool = False,
                   hard: bool = False) -> SearchSpace:
    """Distribution knobs applicable to the given cell.

    ``wide=True`` opens the full chunk-size grids (cartesian >10^6, >2M for
    MoE cells) with the physically-required combinations expressed as
    vectorized ``VectorConstraint`` column predicates — the scale the old
    per-row Python enumeration could not reach. The default narrow space is
    unchanged, so existing tuning caches and journals stay valid.

    ``hard=True`` (implies ``wide``) is the tightly-constrained variant the
    propagating sampler (DESIGN.md §15) unlocks: every cell gets the
    ``attn_block_q`` grid plus VMEM-residency and occupancy constraints
    coupling four-plus knobs at once (double-buffered flash tiles and the
    chunked-logits tile must co-reside in per-core VMEM; the attention grid
    must keep every core busy). Rejection sampling stalls on grids like
    these — feasible fractions sink orders of magnitude below the wide
    variant's — so the space is published under a NEW fingerprint family
    (``sharding_hard[...]``): hard-grid journals never mix with wide ones.
    Its VMEM and core bounds model the reference's TPU.
    """
    if hard:
        wide = True
    if not wide:
        params = [
            Param("remat", ("none", "dots", "full")),
            Param("attn_q_chunks", (1, 2, 4)),
            Param("logits_chunk", (512, 2048, 8192)),
            Param("attn_block_kv", (512, 1024, 2048)),
            Param("flash", (1, 0)),   # 1: blockwise flash; 0: direct attention
        ]
        if shape == "train_4k":
            params.append(Param("opt_moment_dtype", ("float32", "bfloat16")))
            params.append(Param("microbatches", (1, 2, 4)))
        if arch.startswith(("deepseek", "qwen3")):
            params.append(Param("capacity_factor", (1.0, 1.25, 1.5)))
            params.append(Param("experts_rule", ("model", "model+data")))
        if arch.startswith("xlstm"):
            params.append(Param("mlstm_chunk", (0, 32, 64, 128)))
        params.append(Param("embed_rule", ("data", "none")))  # ZeRO-3 on/off
        return SearchSpace(params, (), name=f"sharding[{arch}×{shape}]")

    params = [
        Param("remat", ("none", "dots", "full")),
        Param("attn_q_chunks", (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)),
        Param("logits_chunk", (128, 192, 256, 384, 512, 768, 1024, 1536,
                               2048, 3072, 4096, 6144, 8192, 12288, 16384,
                               32768)),
        Param("attn_block_kv", (128, 192, 256, 384, 512, 768, 1024, 1536,
                                2048, 3072, 4096)),
        Param("flash", (1, 0)),
    ]
    cons = [
        # blockwise flash needs at least a 256-token KV block per grid step
        VectorConstraint(lambda c: (c["flash"] == 0)
                         | (c["attn_block_kv"] >= 256),
                         name="flash_min_kv_block"),
        # direct attention materializes the (q, kv) block: cap the KV tile
        VectorConstraint(lambda c: (c["flash"] == 1)
                         | (c["attn_block_kv"] <= 2048),
                         name="direct_max_kv_block"),
        # combined q-chunk × kv-block tiling degenerates past this product
        VectorConstraint(lambda c: c["attn_q_chunks"] * c["attn_block_kv"]
                         <= 32768, name="tile_product"),
    ]
    if shape == "train_4k":
        params.append(Param("opt_moment_dtype", ("float32", "bfloat16")))
        params.append(Param("microbatches", tuple(
            m for m in (1, 2, 4, 8, 16, 32) if GLOBAL_BATCH % m == 0)))
        # vacuous for the derived grid above; keeps the coupling declared if
        # the grid is ever widened past the divisors
        cons.append(VectorConstraint(
            lambda c: GLOBAL_BATCH % c["microbatches"] == 0,
            name="microbatch_divides_batch"))
    if arch.startswith(("deepseek", "qwen3")):
        # MoE cells get the full distribution-knob grid: cartesian goes past
        # 10^9 on train_4k, which the generative backend (DESIGN.md §15)
        # serves without enumeration. Narrow/trimmed MoE fingerprints are
        # intentionally incompatible with this wide grid (extra params), so
        # cross-width transfer is off for MoE cells — by design, not drift.
        params.append(Param("capacity_factor", (1.0, 1.05, 1.1, 1.25, 1.4,
                                                1.5, 1.6, 1.75, 2.0)))
        params.append(Param("experts_rule", ("model", "model+data")))
        params.append(Param("attn_block_q", (128, 192, 256, 384, 512, 768,
                                             1024, 1536, 2048, 3072, 4096)))
        params.append(Param("moe_combine", ("gather", "a2a")))
        params.append(Param("grad_compression", ("none", "topk", "int8")))
        params.append(Param("grad_compression_topk", (0.01, 0.05, 0.1)))
        cons += [
            # blockwise flash keeps a q×kv f32 accumulator tile in VMEM
            VectorConstraint(lambda c: (c["flash"] == 0)
                             | (c["attn_block_q"] * c["attn_block_kv"]
                                <= 2 ** 21),
                             name="flash_q_kv_vmem"),
            # the top-k ratio only exists under top-k compression; pin it to
            # its default otherwise so the knob can't split identical configs
            VectorConstraint(lambda c: (c["grad_compression"] == "topk")
                             | (c["grad_compression_topk"] == 0.05),
                             name="topk_ratio_coupling"),
        ]
    if arch.startswith("xlstm"):
        params.append(Param("mlstm_chunk", (0, 16, 32, 48, 64, 96, 128,
                                            192, 256)))
    params.append(Param("embed_rule", ("data", "none")))  # ZeRO-3 on/off
    if hard:
        if not any(p.name == "attn_block_q" for p in params):
            params.append(Param("attn_block_q", (128, 192, 256, 384, 512,
                                                 768, 1024, 1536, 2048,
                                                 3072, 4096)))
        seq = _seq_tokens(shape)
        cons += [
            # double-buffered flash tiles plus the chunked-logits tile
            # (bf16 activations + f32 accumulator over a 128-row block)
            # must co-reside in per-core VMEM — couples flash, both
            # attention blocks, and logits_chunk in one predicate
            VectorConstraint(
                lambda c: (c["flash"] * 2
                           * flash_vmem_bytes(c["attn_block_q"],
                                              c["attn_block_kv"])
                           + c["logits_chunk"] * 128 * 6) <= VMEM_BYTES,
                name="vmem_coresidency"),
            # the q×kv attention grid (after q-chunking) must keep every
            # core busy each wave
            VectorConstraint(
                lambda c: attn_tile_occupancy(
                    seq // c["attn_q_chunks"], c["attn_block_q"],
                    c["attn_block_kv"]) >= 1.0,
                name="occupancy_floor"),
            # direct attention has no streaming stats: its full q-block of
            # logits must fit outright, steeply capping the block product
            VectorConstraint(
                lambda c: (c["flash"] == 1)
                | (c["attn_block_q"] * c["attn_block_kv"] * 4
                   <= VMEM_BYTES // 4),
                name="direct_logits_fit"),
            # no ragged tiles: the q-chunking times the q block must divide
            # the sequence exactly, and so must the kv block — the
            # divisibility restrictions of real kernel grids (the paper's
            # own constraint family), and what makes this grid tightest
            VectorConstraint(
                lambda c: seq % (c["attn_q_chunks"] * c["attn_block_q"]) == 0,
                name="q_tiles_divide_seq"),
            VectorConstraint(lambda c: seq % c["attn_block_kv"] == 0,
                             name="kv_tiles_divide_seq"),
        ]
        return SearchSpace(params, cons, name=f"sharding_hard[{arch}×{shape}]")
    return SearchSpace(params, cons, name=f"sharding_wide[{arch}×{shape}]")


def _seq_tokens(shape: str) -> int:
    """Sequence length a cell shape implies (``train_4k`` → 4096);
    unknown shapes use the production default."""
    m = re.search(r"(\d+)k$", shape)
    return int(m.group(1)) * 1024 if m else 4096


def _config_args(cfg: Dict[str, Any]) -> List[str]:
    """The dry-run CLI's flags of a sharding config (the reference's map)."""
    args = []
    if cfg.get("remat") and cfg["remat"] != "none":
        args += ["--remat", cfg["remat"]]
    if cfg.get("attn_q_chunks", 1) != 1:
        args += ["--q-chunks", str(cfg["attn_q_chunks"])]
    if cfg.get("microbatches", 1) != 1:
        args += ["--microbatches", str(cfg["microbatches"])]
    if cfg.get("capacity_factor"):
        args += ["--capacity-factor", str(cfg["capacity_factor"])]
    if cfg.get("logits_chunk") is not None:
        args += ["--logits-chunk", str(cfg["logits_chunk"])]
    if cfg.get("attn_block_kv"):
        args += ["--attn-block-kv", str(cfg["attn_block_kv"])]
    if cfg.get("opt_moment_dtype"):
        args += ["--opt-moment-dtype", cfg["opt_moment_dtype"]]
    if cfg.get("flash", 1) == 0:
        args += ["--no-flash"]
    if cfg.get("mlstm_chunk"):
        args += ["--mlstm-chunk", str(cfg["mlstm_chunk"])]
    if cfg.get("attn_block_q"):
        args += ["--attn-block-q", str(cfg["attn_block_q"])]
    if cfg.get("moe_combine") and cfg["moe_combine"] != "gather":
        args += ["--moe-combine", cfg["moe_combine"]]
    if cfg.get("grad_compression") and cfg["grad_compression"] != "none":
        args += ["--grad-compression", cfg["grad_compression"]]
        if cfg["grad_compression"] == "topk" and cfg.get("grad_compression_topk"):
            args += ["--grad-compression-topk",
                     str(cfg["grad_compression_topk"])]
    rules = []
    if cfg.get("experts_rule") == "model+data":
        rules.append("experts=model+data")
    if cfg.get("embed_rule") == "none":
        rules.append("embed=None")
    if rules:
        args += ["--rules", ",".join(rules)]
    return args


def pcfg_of(cfg: Dict[str, Any]):
    """The ``ParallelConfig`` the dry-run runs a sharding config at: its
    CLI flags (:func:`_config_args`) read by the dry-run's parser."""
    from repro_torch.launch import dryrun
    return dryrun._pcfg_from_args(
        dryrun.build_parser().parse_args(_config_args(cfg)))


class DryRunObjective(Objective):
    """Roofline step time (s) of the traced cell under a distribution
    config, on one card (``mesh`` None) or on the named production mesh of
    the card; NaN where the record is not ``ok`` or a card's peak does not
    fit the card's memory."""

    def __init__(self, arch: str, shape: str, mesh: Optional[str] = None,
                 card: Optional[str] = None,
                 cache_dir: str = "results/tune_cache",
                 check_hbm: bool = True, repo_root: Optional[str] = None,
                 verbose: bool = True, wide: bool = False, arch_cfg=None,
                 timeout_s: int = 2400):
        from repro_torch.kernels.tuning import card_kind
        from repro_torch.launch.dryrun import present_card
        from repro_torch.launch.mesh import PRODUCTION_MESHES
        from repro_torch.store.resolve import mesh_key
        if mesh is not None and mesh not in PRODUCTION_MESHES:
            raise ValueError(f"unknown mesh {mesh!r} (only "
                             f"{sorted(PRODUCTION_MESHES)}, or None)")
        if mesh is not None and arch_cfg is not None:
            raise ValueError("a mesh cell is traced in a child process, "
                             "from the registry's config: no arch_cfg")
        self.arch, self.shape = arch, shape
        self.card = card or present_card()
        #: the production mesh (None: one card)
        self.mesh_name = mesh
        self.mesh = mesh_key(card_kind(self.card), mesh)
        self.timeout_s = timeout_s
        self.space = sharding_space(arch, shape, wide=wide)
        self.cache_dir = cache_dir
        self.check_hbm = check_hbm
        self.verbose = verbose
        self.root = repo_root or os.path.abspath(REPO)
        self.name = f"dryrun[{arch}×{shape}×{self.mesh}]"
        #: a config traced in place of the registry's (a smoke config);
        #: its name keys the cache
        self.arch_cfg = arch_cfg
        #: configs this objective traced (not from the disk cache, nor
        #: sharing another config's trace)
        self.traced = 0
        os.makedirs(os.path.join(self.root, cache_dir), exist_ok=True)

    def _cache_key(self, cfg: Dict[str, Any]) -> str:
        arch = self.arch_cfg.name if self.arch_cfg else self.arch
        blob = json.dumps([arch, self.shape, self.mesh, cfg], sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def record_for(self, cfg: Dict[str, Any]) -> Dict:
        """The cell's dry-run record at ``cfg``, from the cache when it
        holds one, else traced (one card: in process; a mesh: in a child
        process) and cached."""
        from repro_torch.launch.dryrun import run_cell
        path = os.path.join(self.root, self.cache_dir,
                            self._cache_key(cfg) + ".json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        if self.mesh_name is None:
            rec = run_cell(self.arch, self.shape, self.card, pcfg_of(cfg),
                           cfg=self.arch_cfg)
            self.traced += not rec.get("memo")
        else:
            rec = self._run_child(cfg, path[:-len(".json")] + ".d")
            self.traced += 1
        with open(path, "w") as f:
            json.dump(rec, f)
        return rec

    def _run_child(self, cfg: Dict[str, Any], tagdir: str) -> Dict:
        """The mesh cell's record from the dry-run's CLI in a child
        process (the reference's objective runs its compile so)."""
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", self.arch, "--shape", self.shape,
               "--mesh", self.mesh_name, "--card", self.card,
               "--out", tagdir, "--tag", "tune"] + _config_args(cfg)
        env = dict(os.environ, PYTHONPATH=os.path.join(self.root, "src"))
        try:
            r = subprocess.run(cmd, cwd=self.root, env=env,
                               timeout=self.timeout_s, capture_output=True,
                               text=True)
        except subprocess.TimeoutExpired:
            return {"status": "timeout"}
        out = os.path.join(tagdir, f"tune__{self.arch}__{self.shape}__"
                                   f"{self.mesh}.json")
        if not os.path.exists(out):
            return {"status": "crash", "stderr": r.stderr[-4000:]}
        with open(out) as f:
            return json.load(f)

    def __call__(self, idx: int) -> float:
        cfg = self.space.config(idx)
        rec = self.record_for(cfg)
        if rec.get("status") != "ok":
            if self.verbose:
                print(f"  [tune] {cfg} -> INVALID ({rec.get('status')})")
            return math.nan
        if self.check_hbm:
            mem = rec["memory"]
            if mem["peak_live_bytes"] > mem["card_bytes"]:
                if self.verbose:
                    print(f"  [tune] {cfg} -> INVALID (peak "
                          f"{mem['peak_live_bytes'] / 2**30:.1f} GiB > "
                          f"{mem['card_bytes'] / 2**30:.1f} GiB)")
                return math.nan
        t = rec["roofline"]["step_time"]
        if self.verbose:
            rf = rec["roofline"]
            print(f"  [tune] {cfg} -> {t:.3f}s "
                  f"(c={rf['t_compute']:.2f} m={rf['t_memory']:.2f} "
                  f"x={rf['t_collective']:.2f})")
        return float(t)
