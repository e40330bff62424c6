"""Serve/launch-side config resolution from the record store.

The launchers ask the store for the best prior tuning result of their exact
problem — ``(arch, shape, mesh)`` distribution tuning fingerprint — before
falling back to built-in defaults, so a production deployment never re-pays
tuning cost for a scenario any earlier run (tuner, benchmark, or another
host writing to the same store) has already explored.

Port of ``repro/store/resolve.py``. The sharding cell's space and
fingerprint are the reference's (``core/tuning_targets.sharding_space``),
so records resolve across the two packages. A cell's mesh part names
where it was planned (:func:`mesh_key`): the reference's TPU pods
(``single``, ``multi``), one card (its device kind,
``cuda-NVIDIA_H100_80GB_HBM3``), or a production mesh of cards
(``single-cuda-NVIDIA_H100_80GB_HBM3``), so a record of one never
resolves for another. ``apply_sharding_config``
overlays every field the reference's does (the port's ``ParallelConfig``
has them all), ``flash`` as ``flash_threshold``. The mesh rules
(``embed_rule``, ``experts_rule``) are not ``ParallelConfig`` fields: the
reference applies them nowhere here either (its dry-run takes them as
``--rules`` overrides of ``param_rules``); they are logged, since the
server runs off a mesh. ``apply_kernel_config`` is the
reference's, but for the decode combine's name: the reference calls its
tensor-op combine ``"jax"``, the port ``"torch"``, and a record of either
package reads as the port's name (:func:`decode_combine`).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

from repro_torch.store.records import SpaceFingerprint, TuningRecordStore

#: sharding-space parameters that map 1:1 onto ParallelConfig fields
_PCFG_FIELDS = ("remat", "attn_q_chunks", "logits_chunk", "attn_block_kv",
                "microbatches", "capacity_factor", "opt_moment_dtype",
                "mlstm_chunk", "attn_block_q", "moe_combine",
                "grad_compression", "grad_compression_topk")


#: The reference's names of the decode cell's ``combine`` values that the
#: port names otherwise.
_COMBINE_NAMES = {"jax": "torch"}


def decode_combine(name) -> str:
    """The port's name of a stored decode ``combine``: the reference's
    ``"jax"`` is the port's ``"torch"``; any other name is kept (the
    kernel refuses an unknown one)."""
    return _COMBINE_NAMES.get(str(name), str(name))


def mesh_key(card_kind: str, mesh: Optional[str] = None) -> str:
    """The mesh part of a dry-run cell's id for a card of ``card_kind``
    (``kernels.tuning.card_kind``): the kind itself for one card, else
    ``<mesh>-<kind>`` for that production mesh of the card."""
    return card_kind if mesh is None else f"{mesh}-{card_kind}"


def cell_objective(arch: str, shape: str, mesh: str = "single") -> str:
    """Tuning-objective id of one serving cell — the string every layer
    (dry-run tuner, store resolution, hot reload) keys the cell's
    fingerprints on."""
    return f"dryrun[{arch}×{shape}×{mesh}]"


def best_sharding_config(store, arch: str, shape: str, mesh: str = "single",
                         wide: bool = False
                         ) -> Optional[Tuple[Dict[str, Any], float]]:
    """(config, roofline step time) of the best prior tuning record for this
    (arch, shape, mesh) cell, or None when the store has never seen it."""
    if isinstance(store, str):
        if not os.path.exists(store):
            return None
        # indexed open: resolution touches one cell's fingerprints, so a
        # fleet-scale store must not be parsed wholesale per lookup
        store = TuningRecordStore(store, lazy=True)
    from repro_torch.core.tuning_targets import sharding_space
    space = sharding_space(arch, shape, wide=wide)
    fp = SpaceFingerprint.of(space, objective=cell_objective(arch, shape, mesh))
    hit = store.best_config(fp)
    if hit is not None:
        return hit
    # a narrow-space record also serves a wide lookup (and vice versa): any
    # same-named sharding fingerprint for this cell beats the defaults —
    # minimum over ALL compatible fingerprints, not the first one seen
    best: Optional[Tuple[Dict[str, Any], float]] = None
    for digest, desc in store.fingerprints().items():
        if desc.objective == fp.objective and digest != fp.digest:
            alt = store.best_config(digest)
            if alt is not None and (best is None or alt[1] < best[1]):
                best = alt
    return best


def apply_sharding_config(pcfg, cfg: Dict[str, Any], log=print):
    """Overlay a stored tuning config onto a ParallelConfig (dataclass
    ``replace``): only the knobs ParallelConfig owns, ``flash`` as the
    reference maps it to ``flash_threshold``; the mesh rules
    (experts/embed) are the launch layer's, as in the reference, and are
    logged as not applicable on one card."""
    kw = {k: cfg[k] for k in _PCFG_FIELDS if k in cfg}
    if "flash" in cfg:
        # flash=1: blockwise attention always on; flash=0: never
        kw["flash_threshold"] = 0 if cfg["flash"] else 1 << 30
    applied = set(kw) | ({"flash"} if "flash" in cfg else set())
    skipped = sorted(k for k in cfg if k not in applied)
    if skipped:
        log(f"[serve] sharding fields {skipped} do not apply on one card "
            "(mesh rules: the server runs off a mesh)")
    return pcfg.replace(**kw)


def apply_kernel_config(pcfg, cfg: Dict[str, Any]):
    """Overlay a stored *kernel-cell* block config (DESIGN.md §14/§16) onto
    a ParallelConfig as a ``KernelConfig``. Decode-cell keys
    (``num_splits``/``combine``) enable Pallas flash-decode dispatch;
    flash-cell keys (``block_q``/``block_kv`` without split keys) enable
    Pallas flash; a config carrying neither shape of key (e.g. a gemm
    cell's) leaves the kernel field untouched. Overlays compose: applying a
    decode config on top of a flash-enabled KernelConfig keeps the flash
    blocks (and vice versa), so one server carries both tuned paths."""
    from repro_torch.parallel.sharding import KernelConfig
    base = pcfg.kernel or KernelConfig()
    if "num_splits" in cfg or "combine" in cfg:
        return pcfg.replace(kernel=base.replace(
            use_decode=True,
            decode_block_kv=int(cfg.get("block_kv", base.decode_block_kv)),
            decode_num_splits=int(cfg.get("num_splits",
                                          base.decode_num_splits)),
            decode_combine=decode_combine(cfg.get("combine",
                                                  base.decode_combine))))
    if "block_q" not in cfg and "block_kv" not in cfg:
        return pcfg
    return pcfg.replace(kernel=base.replace(
        use_flash=True,
        flash_block_q=int(cfg.get("block_q", base.flash_block_q)),
        flash_block_kv=int(cfg.get("block_kv", base.flash_block_kv))))
