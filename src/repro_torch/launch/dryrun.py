"""Dry-run of every (arch × shape × mesh) cell, on meta tensors.

Port of ``repro/launch/dryrun.py`` for an NVIDIA card: one card, or the
card's production meshes (``--mesh``). For each cell the
step function (``models/stepfn.make_{train,prefill,decode}_step``) runs on
the cell's inputs as meta tensors (``launch/specs.input_specs``): shapes
and dtypes, no storage, so a pod-sized cell is traced without allocating
a byte. The record has the reference's parts:

  * ``memory``: ``argument_size_in_bytes`` (params, optimizer state, cache,
    batch), of which ``cache_size_in_bytes`` is a decode cell's cache (0
    in the other cells), ``temp_size_in_bytes`` (the most bytes of
    storage the step itself held at once, its outputs included) and
    ``peak_live_bytes``
    (the two together: the counterpart of XLA's arguments plus temps),
    beside ``card_bytes``, the card's memory. Allocations are counted as
    each op's outputs get new storage, frees with ``weakref.finalize`` on
    the storages. A cell that does not fit the card is an ``ok`` record
    with its bytes (the reference's cells are pod-sized);
  * ``roofline`` (``launch/roofline.Roofline``, the reference's keys):
    FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` over the step,
    the train step's backward and recompute (``remat``) included; bytes
    as each op's inputs read plus its outputs written, views free: the
    traffic of the eager program the port runs, the counterpart of
    ``hlo_cost``'s bytes and an upper bound against a fused program;
  * ``top_scopes`` / ``top_bytes_scopes``: FLOPs and bytes by ATen op (the
    port's step functions hold no ``nn.Module`` s for ``FlopCounterMode``
    to attribute to: its per-op counts are the counterpart);
  * ``t_trace_s`` in place of the lower and compile times;
  * on a mesh, ``coll_by_kind`` and ``links`` (below).

On a mesh (``launch/mesh.PRODUCTION_MESHES``: ``single``, 32 nodes of 8
cards as (data 32, model 8); ``multi``, (pod 2, data 32, model 8)) the
step runs as rank 0 of a fake world of that many ranks
(``launch/mesh.fake_mesh``, opened and closed by ``run_cell``) on meta
DTensors placed as the training loop places real ones. Every count is a
card's: ``TraceCounter`` counts the rank's local ops (replicated work on
every rank, a sharded product's share), and each functional collective
at its operand bytes (the reference's count of HLO collectives), by
kind, across nodes where its group holds ranks of two nodes of
``roofline.NODE_CARDS``. Every card's groups are alike on a regular
mesh, so rank 0's counts are a card's; the roofline takes them x chips,
as the reference's does, and prices the collectives over NVLink within
a node and InfiniBand across (``links``: a card's bytes of each).

A meta trace dispatches every op in Python (about 0.2 ms an op on a
host CPU core), so the program is cut where it repeats and the counts
carried to the whole (``measure``; ``scaled`` lists each cut): the most
repeated segment of layers is traced at 1 and 2 repeats (``DEPTHS``),
and the per-step scans (the sLSTM, the mLSTM without chunks: 32,768
Python steps a layer at ``prefill_32k``) at 4 and 8 steps
(``SCAN_STEPS``, ``models/layers.trace_scan_steps``). FLOPs and bytes
carry over exactly; the peak as ``measure`` says. The chunkwise mLSTM's
loop over chunks and the blockwise attention's over KV blocks are traced
whole. No op of the
step functions reads a tensor's values (the MoE dispatch and the AdamW
loop included), so nothing is counted by formula (``by_formula`` is
empty). ``pcfg.kernel`` must be None, as the reference's dry-run leaves
it: the kernels take CPU or CUDA tensors, and the gates raise on meta
tensors. On one card the mesh rules (``param_rules``, ``act_rules``; the
tuner's ``embed_rule`` and ``experts_rule`` reach them through
``--rules``), ``attn_block_q``, ``moe_combine`` and gradient compression
change no shape or value: ``one_card_noop`` lists those that differ from
the defaults. On a mesh the rules and ``moe_combine`` place the step;
``mesh_noop`` lists the others (``MESH_NOOP``).

Cells are the reference's (``configs/arch.SHAPES``: pod-sized, so on one
card most do not fit whatever the knobs) and ``CARD_SHAPES``, a
reference cell's sequence at a batch one card serves, where the knobs
decide. In one process a cell is traced once for the knobs its step
reads (``_traced_knobs``): configs that differ only in knobs it never
reads share the trace (``memo`` in the record).

``--card`` names the card (its peaks, links and memory); ``--mesh``
takes the reference's names. Cut, with reasons: HLO parsing
(``launch/hlo.py``, ``launch/hlo_cost.py``: the port never produces
HLO; ``FlopCounterMode``, the byte count and the collective count above
are their counterparts) and ``--save-hlo`` with it.

Usage (on the CPU, name the card; on the card it defaults to the card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k --card "NVIDIA H100 80GB HBM3" --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --card "NVIDIA H100 80GB HBM3" --workers 4 --out DIR
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.arch import (SHAPES_BY_NAME, ShapeConfig,
                                     shape_applicable)
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.kernels.tuning import card_kind
from repro_torch.launch.mesh import PRODUCTION_MESHES, fake_mesh
from repro_torch.launch.roofline import (NODE_CARDS, Roofline, card_memory,
                                         dtype_peak_flops, links_for,
                                         model_flops_for)
from repro_torch.launch.specs import input_specs
from repro_torch.models import layers as L
from repro_torch.models.stepfn import (make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.optim.optimizers import AdamW, constant_lr
from repro_torch.parallel.sharding import ParallelConfig, ShardCtx

#: steps of each per-step scan in the two traces a scanning cell takes
#: (every step runs the same ops, the first included; each op site's
#: peak is linear in the steps from 4 on, not from 2)
SCAN_STEPS = (4, 8)
#: repeats of a config's most repeated segment in its two traces
DEPTHS = (1, 2)
#: knobs that change no shape or value on one card
ONE_CARD_NOOP = ("param_rules", "act_rules", "attn_block_q", "moe_combine",
                 "grad_compression", "grad_compression_topk")
#: knobs that change no shape or value on a mesh either: no model path
#: reads ``attn_block_q``, and gradient compression runs on no training
#: path (the reference's neither)
MESH_NOOP = ("attn_block_q", "grad_compression", "grad_compression_topk")
#: the reference's collective kinds by the functional collective's name
COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "collective-broadcast",
               "broadcast_": "collective-broadcast"}
#: functional-collective ops that move no data (waits, autograd wrappers)
_COLL_NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd"}
BYTES_NOTE = ("hbm_bytes: each op's inputs read and outputs written, views "
              "free, in the eager program the port runs; an upper bound "
              "against a fused program")
#: ops that allocate or relabel without moving data
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat_tensors(x, out: list) -> list:
    """The tensors under ``x``, a DTensor as this rank's local tensor."""
    if isinstance(x, DTensor):
        out.append(x._local_tensor)
    elif isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat_tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat_tensors(y, out)
    return out


#: the model's loops over layers (file, functions), whose local ``i`` is
#: the layer an op runs in
_LAYER_LOOP = ("models/model.py", ("layer", "forward"))
#: DTensor's planning code (sharding propagation), whose ops run on
#: tensors of global shapes that no rank holds
_PLANNER_FILES = ("_sharding_prop.py", "_decompositions.py")


def _next_sequence_nr() -> int:
    """The autograd sequence number the next node made here takes."""
    return torch._C._autograd._get_sequence_nr()


def _dtensor_planning(depth: int = 16) -> bool:
    """Whether the op being dispatched was called from DTensor's planner
    (within ``depth`` frames): its factory ops carry no tensor to tell."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        name = f.f_code.co_filename
        if "distributed" in name and name.endswith(_PLANNER_FILES):
            return True
        f = f.f_back
    return False


class TraceCounter(TorchDispatchMode):
    """Counts, over the ops dispatched inside it, the bytes each reads and
    writes (``bytes``, by op in ``by_op``), the bytes of storage alive
    that the ops allocated (``live``, its maximum ``peak``) and, through
    ``flops`` (a ``FlopCounterMode``, its formulas and its counts), the
    FLOPs: one dispatch mode for both, which halves the trace's time
    against nesting the two. Storages of ``known`` tensors (the step's
    arguments) are not counted.

    On a mesh every count is this rank's: an op on DTensors is handed on
    to DTensor (``NotImplemented``), which plans it and runs the rank's
    local op on its local tensors, and any redistribution it needs, with
    this mode still active, so FLOPs, bytes and storage are counted on the
    local shards (replicated work on every rank, a sharded product's
    share) and DTensor's global-shape planning (on fake tensors, or on
    meta tensors that carry a ``_spec``) is not.
    Each functional collective adds its operand bytes to ``coll`` (by
    kind in ``coll_by_kind``, the reference's names), and to ``dcn`` where
    its group holds ranks of more than one node of ``NODE_CARDS``: the
    reference's count of collective operands in the HLO."""

    def __init__(self, flops: FlopCounterMode, known=()):
        super().__init__()
        self.flops = flops
        #: the most live bytes after an op of each site (its autograd
        #: node, its caller in the port, its layer, the op), which
        #: ``measure`` carries site by site across scan cuts
        self.site_peak: Dict[str, int] = {}
        #: the first autograd sequence number at each change of the layer
        #: the forward runs in, and that layer: a backward node's layer
        self._starts: List[int] = []
        self._layers: List[Optional[int]] = []
        self.bytes = 0
        self.by_op: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._seen = {id(t.untyped_storage()) for t in known}
        self.coll = 0
        self.dcn = 0
        self.coll_by_kind: Dict[str, int] = defaultdict(int)
        self._spans: Dict[str, bool] = {}

    def _site(self, func) -> None:
        """Record the live bytes after ``func`` under its site: the
        backward node running it (None in the forward), the nearest frame
        of the port's model code, the layer, the op. The layer keeps apart
        the repeats of one line, whose peaks grow alike in steps from
        bases of their own: the model's loop says it in the forward and in
        a recompute; a backward node takes the layer whose forward made
        it (its autograd sequence number)."""
        node = torch._C._current_autograd_node()
        f, where, layer = sys._getframe(2), None, None
        while f is not None:
            name = f.f_code.co_filename
            if where is None and "repro_torch" in name and \
                    not name.endswith("dryrun.py"):
                if f.f_code.co_qualname.startswith("_FillSteps."):
                    return      # the cut's own fill, absent from S steps
                where = f"{name.rsplit('/', 1)[-1]}:{f.f_lineno}"
            if name.endswith(_LAYER_LOOP[0]) and \
                    f.f_code.co_name in _LAYER_LOOP[1]:
                layer = f.f_locals.get("i")
                break
            f = f.f_back
        if layer is not None or node is None:
            if (self._layers[-1] if self._layers else None) != layer:
                self._starts.append(_next_sequence_nr())
                self._layers.append(layer)
        else:
            at = bisect.bisect_right(self._starts, node._sequence_nr()) - 1
            layer = self._layers[at] if at >= 0 else None
        key = (f"{node.name() if node is not None else ''}|{where}|{layer}|"
               f"{func}")
        if self.live > self.site_peak.get(key, -1):
            self.site_peak[key] = self.live

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _spans_nodes(self, group_name: str) -> bool:
        if group_name not in self._spans:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
            self._spans[group_name] = len({r // NODE_CARDS
                                           for r in ranks}) > 1
        return self._spans[group_name]

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if name in _COLL_NO_TRAFFIC:
            return
        if name not in COLLECTIVES:
            raise NotImplementedError(f"no collective kind for {func}")
        ins = _flat_tensors((args, kwargs), [])
        n = sum(map(_nbytes, ins))
        bound = dict(zip((a.name for a in func._schema.arguments), args),
                     **kwargs)
        kind = COLLECTIVES[name]
        self.coll += n
        self.coll_by_kind[kind] += n
        if self._spans_nodes(bound["group_name"]):
            self.dcn += n
        moved = n + sum(map(_nbytes, _flat_tensors(out, [])))
        self.bytes += moved
        self.by_op[name] += moved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _flat_tensors((args, kwargs), [])
        if any(issubclass(t, FakeTensor) for t in types) or any(
                hasattr(t, "_spec") for t in ins) or (
                    not ins and _dtensor_planning()):
            # DTensor planning an op: on fake tensors, or (a composite op)
            # through its decomposition on meta tensors that carry a spec
            # (made by a factory op of the planner's own)
            return func(*args, **kwargs)
        # a composite op reaches the mode whole where autograd is off
        # (inference mode): count the ops it decomposes into, as
        # FlopCounterMode's own dispatch does; on DTensors too, so that
        # DTensor plans the ops a train step's autograd would hand it
        if (func not in self.flops.flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace in ("_c10d_functional", "c10d"):
            out = func(*args, **kwargs)
            self._collective(func, args, kwargs, out)
            for o in _flat_tensors(out, []):
                self._track(o)
            self._site(func)
            return out
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        outs = _flat_tensors(out, [])
        if not any(t.device.type == "meta" for t in outs + ins):
            return out          # host-side scalars: no device work
        packet = func._overloadpacket
        self.flops._count_flops(packet, out, args, kwargs)
        for o in outs:
            self._track(o)
        self._site(func)
        if func in _NO_TRAFFIC:
            return out
        n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += n
        self.by_op[packet.__name__] += n
        return out


def _tensors(tree) -> List[torch.Tensor]:
    return _flat_tensors(tree, [])


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _step_and_args(cfg, shape, pcfg: ParallelConfig, mesh=None):
    """(step function, its arguments as meta tensors; meta DTensors placed
    on ``mesh`` when it is given)."""
    px = ShardCtx(mesh=mesh, pcfg=pcfg)
    if shape.kind == "train":
        opt = AdamW(schedule=constant_lr(1e-4),
                    moment_dtype=pcfg.opt_moment_dtype)
        specs = input_specs(cfg, shape, mesh, pcfg, optimizer=opt)
        return make_train_step(cfg, pcfg, opt, px=px), (
            specs["params"], specs["opt_state"], specs["batch"],
            specs["step"])
    specs = input_specs(cfg, shape, mesh, pcfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, pcfg, cache_cap=shape.seq_len,
                                 px=px), (specs["params"], specs["batch"])
    return make_decode_step(cfg, pcfg, px=px), (
        specs["params"], specs["cache"], specs["batch"], specs["pos"])


def trace_step(cfg, shape, pcfg: ParallelConfig,
               scan_steps: Optional[int] = None, mesh=None) -> Dict:
    """One trace of the cell's step on meta tensors (on ``mesh``: meta
    DTensors, every count this rank's): FLOPs (total and by op), bytes
    moved (total and by op), argument bytes, the temps' peak, collective
    bytes (total, across nodes, by kind) and the scans it cut
    (``models/layers.scans_cut``)."""
    step, args = _step_and_args(cfg, shape, pcfg, mesh)
    L.trace_scan_steps, L.scans_cut[:] = scan_steps, []
    fc = FlopCounterMode(display=False)
    try:
        with TraceCounter(fc, _tensors(args)) as tc:
            out = step(*args)
            del out
    finally:
        L.trace_scan_steps = None
    flops_by_op = {str(k).split(".")[-1]: v for k, v in
                   fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": fc.get_total_flops(), "bytes": tc.bytes,
            "flops_by_op": flops_by_op, "bytes_by_op": dict(tc.by_op),
            "args": storage_bytes(args), "temp": tc.peak,
            "site_peak": tc.site_peak,
            "coll": tc.coll, "dcn": tc.dcn,
            "coll_by_kind": dict(tc.coll_by_kind), "cut": list(L.scans_cut)}


def _lin(a, b, x1: int, x2: int, x: int):
    """The value at x of a count linear in x, from its values ``a`` at x1
    and ``b`` at x2 (dicts key by key)."""
    if isinstance(a, dict):
        return {k: _lin(a.get(k, 0), b.get(k, 0), x1, x2, x)
                for k in set(a) | set(b)}
    return a + (b - a) * (x - x1) // (x2 - x1)


def _depth_plan(cfg):
    """(index, repeats, cycle length) of the config's most repeated
    segment (``ArchConfig.pattern_layers``), or None when it repeats at
    most ``DEPTHS[-1]`` times (the whole depth is traced)."""
    segs = cfg.pattern_layers()
    i = max(range(len(segs)), key=lambda j: segs[j][0])
    if segs[i][0] <= DEPTHS[-1]:
        return None
    return i, segs[i][0], len(segs[i][1])


def _at_depth(cfg, plan, r: int):
    """``cfg`` with its most repeated segment cut to ``r`` repeats, every
    other segment as it is."""
    i, n, cyc = plan
    out = cfg.replace(num_layers=cfg.num_layers - (n - r) * cyc)
    want = list(cfg.pattern_layers())
    want[i] = (r, want[i][1])
    assert list(out.pattern_layers()) == want, (cfg.name, r)
    return out


def measure(cfg, shape, pcfg: ParallelConfig, mesh=None) -> Dict:
    """The cell's counts from traces of a cut program, carried to the
    whole one (on ``mesh``, a rank's). Depth: a config whose most repeated segment repeats more
    than twice is traced at ``DEPTHS`` repeats of it and every count
    carried linearly to its repeats (each repeat runs the same ops).
    Scans: where a per-step scan was cut, each depth is traced at each of
    ``SCAN_STEPS`` and carried linearly to the scan's length S. FLOPs and
    bytes are exact (bilinear in repeats and steps). The temps' peak is
    carried linearly in repeats (a repeat adds the same saved activations
    and leaves the peak where it was). In steps it is carried site by
    site (``TraceCounter.site_peak``): the most live bytes after each op
    site, linear in the steps traced, carried to S, and the largest
    taken (the cut's fill of the steps not run is no site: S steps have
    none). Where the peak falls moves with the steps (under remat "full"
    the recompute of a scan's steps outgrows, at S, a peak that a few
    steps leave at the head), so one carried peak misses it; each site's
    own peak is linear from 4 steps on. Collective bytes carry as FLOPs
    do (each repeat and step runs the same collectives). The arguments'
    bytes are counted on the whole cell's inputs."""
    plan = _depth_plan(cfg)
    depths = [None] if plan is None else list(DEPTHS)
    cfgs = {r: cfg if r is None else _at_depth(cfg, plan, r) for r in depths}
    t1, t2 = SCAN_STEPS
    runs = {(depths[-1], t1): trace_step(cfgs[depths[-1]], shape, pcfg,
                                         scan_steps=t1, mesh=mesh)}
    cut = runs[(depths[-1], t1)]["cut"]
    if cut and max(S for _, S, _ in cut) <= t2:
        # a scan of at most t2 steps: traced whole, nothing carried
        runs = {(depths[-1], t1): trace_step(cfgs[depths[-1]], shape, pcfg,
                                             mesh=mesh)}
        cut = []
    steps = [t1, t2] if cut else [t1]
    for r in depths:
        for t in steps:
            if (r, t) not in runs:
                runs[(r, t)] = trace_step(cfgs[r], shape, pcfg,
                                          scan_steps=t if cut else None,
                                          mesh=mesh)
    seqs = {S for _, S, _ in cut}
    if len(seqs) > 1:
        raise ValueError(f"scans of different lengths in one step: {seqs}")
    S = seqs.pop() if seqs else None

    def whole(key):
        per = [runs[(r, t1)][key] if not cut else
               _lin(runs[(r, t1)][key], runs[(r, t2)][key], t1, t2, S)
               for r in depths]
        return per[0] if plan is None else _lin(per[0], per[1], DEPTHS[0],
                                                DEPTHS[1], plan[1])

    def temp_at(r):
        a = runs[(r, t1)]
        if not cut:
            return a["temp"]
        b = runs[(r, t2)]
        sa, sb = a["site_peak"], b["site_peak"]
        return max(_lin(sa[k], sb[k], t1, t2, S) if k in sa else sb[k]
                   for k in sb)

    out = {k: whole(k) for k in ("flops", "bytes", "flops_by_op",
                                 "bytes_by_op", "coll", "dcn",
                                 "coll_by_kind")}
    temps = [temp_at(r) for r in depths]
    out["temp"] = temps[0] if plan is None else _lin(
        temps[0], temps[1], DEPTHS[0], DEPTHS[1], plan[1])
    args = _step_and_args(cfg, shape, pcfg, mesh)[1]
    out["args"] = storage_bytes(args)
    out["cache"] = storage_bytes(args[1]) if shape.kind == "decode" else 0
    out["cut"] = cut
    counts = ["flops", "hbm_bytes", "temp_size_in_bytes", "top_scopes",
              "top_bytes_scopes"] + (["coll_bytes", "dcn_bytes",
                                      "coll_by_kind"] if mesh else [])
    out["scaled"] = ([] if plan is None else [
        {"block": "layers", "segment": list(cfg.pattern_layers()[plan[0]][1]),
         "repeats": plan[1], "traced": list(DEPTHS), "counts": counts}]) + [
        {"block": b, "steps": S, "traced": [t1, t2], "counts": counts}
        for b in sorted({b for b, _, _ in cut})]
    return out


def _top(d: Dict[str, float], n: int = 8):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def mesh_layout(mesh) -> Tuple[str, Tuple[int, ...], Tuple[str, ...]]:
    """(name, shape, axis names) of a mesh: a production mesh's name
    (``single``, ``multi``) or a {axis: size} dict in mesh order (named
    ``data2-model4``)."""
    if isinstance(mesh, str):
        if mesh not in PRODUCTION_MESHES:
            raise ValueError(f"unknown mesh {mesh!r} (only "
                             f"{sorted(PRODUCTION_MESHES)})")
        return (mesh,) + PRODUCTION_MESHES[mesh]
    return ("-".join(f"{a}{n}" for a, n in mesh.items()),
            tuple(mesh.values()), tuple(mesh))


def run_cell(arch_name: str, shape_name: str, card: str,
             pcfg: Optional[ParallelConfig] = None, cfg=None,
             mesh=None) -> dict:
    """Trace one cell for the named card; returns the dry-run record.
    ``cfg`` replaces the registry's config of ``arch_name`` (a smoke
    config, say) at the cell's shape. ``mesh`` (a production mesh's name
    or an {axis: size} dict, :func:`mesh_layout`): the cell's sharded
    step on that many of the card, traced as rank 0 of a fake world the
    call opens and closes (so not in a process that holds a process
    group); memory and the ``coll_by_kind`` are a card's, the roofline's
    counts the sum over the cards, as the reference's record has them.
    None: one card, the record keyed by the card's kind."""
    cfg = cfg or get_arch(arch_name)
    shape = cell_shape(shape_name)
    kind = card_kind(card)
    name, dims, axes = (kind, (), ()) if mesh is None else mesh_layout(mesh)
    chips = math.prod(dims)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": name,
                "card": card, "chips": chips, "status": "skip",
                "reason": why}
    pcfg = pcfg or ParallelConfig()
    if pcfg.kernel is not None:
        raise ValueError("the dry-run traces with kernel=None, as the "
                         "reference's does: the kernels take CPU or CUDA "
                         "tensors, not meta tensors")
    default = ParallelConfig()
    rec = {"arch": arch_name, "shape": shape_name, "mesh": name,
           "card": card, "chips": chips,
           "pcfg": {k: str(v) for k, v in dataclasses.asdict(pcfg).items()}}
    t0 = time.time()
    try:
        key = (repr(cfg), shape, card, dims, axes,
               _traced_knobs(pcfg, shape, mesh is not None))
        if key not in _MEMO:
            if mesh is None:
                _MEMO[key] = measure(cfg, shape, pcfg)
            else:
                with fake_mesh(dims, axes) as dm:
                    _MEMO[key] = measure(cfg, shape, pcfg, dm)
        else:
            rec["memo"] = True
        m = _MEMO[key]
        t_trace = time.time() - t0
        nvlink, ib = links_for(card)
        roof = Roofline(flops=float(m["flops"]) * chips,
                        hbm_bytes=float(m["bytes"]) * chips,
                        coll_bytes=float(m["coll"]) * chips,
                        dcn_bytes=float(m["dcn"]) * chips, chips=chips,
                        model_flops=model_flops_for(cfg, shape),
                        peak_flops=dtype_peak_flops(cfg.dtype, card),
                        ici_bw=nvlink, dcn_bw=ib)
        mem = {"argument_size_in_bytes": int(m["args"]),
               "cache_size_in_bytes": int(m["cache"]),
               "temp_size_in_bytes": int(m["temp"]),
               "peak_live_bytes": int(m["args"] + m["temp"]),
               "card_bytes": card_memory(card)}
        rec.update({
            "status": "ok", "t_trace_s": round(t_trace, 3), "memory": mem,
            "fits": mem["peak_live_bytes"] <= mem["card_bytes"],
            "roofline": roof.to_dict(), "bytes_note": BYTES_NOTE,
            "top_scopes": _top(m["flops_by_op"]),
            "top_bytes_scopes": _top(m["bytes_by_op"]),
            "scaled": m["scaled"], "by_formula": [],
        })
        noop = ONE_CARD_NOOP if mesh is None else MESH_NOOP
        rec["one_card_noop" if mesh is None else "mesh_noop"] = [
            k for k in noop if getattr(pcfg, k) != getattr(default, k)]
        if mesh is not None:
            rec["coll_by_kind"] = m["coll_by_kind"]
            rec["links"] = {"nvlink_bytes": m["coll"] - m["dcn"],
                            "ib_bytes": m["dcn"]}
        print(f"[dryrun] {arch_name} × {shape_name} × {name}: OK "
              f"trace={t_trace:.1f}s peak={mem['peak_live_bytes'] / 1e9:.1f}"
              f"/{mem['card_bytes'] / 1e9:.1f} GB dominant={roof.dominant} "
              f"t=({roof.t_compute:.4f},{roof.t_memory:.4f},"
              f"{roof.t_collective:.4f})s")
    except Exception as e:  # noqa: BLE001 — a failing cell is a finding
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[dryrun] {arch_name} × {shape_name} × {name}: "
              f"FAIL {type(e).__name__}: {e}")
    return rec


#: one-card cells: a reference cell's sequence at the batch one card
#: serves (phase 8 of chip_smoke.py serves gemma-2b at B 4), where the
#: sharding knobs decide whether the step fits, and the train cells the
#: card trains (chip_smoke.py: phase 14's B 4 x S 1,024, and phase 17's
#: S 256, where xlstm-1.3b's host-bound sLSTM loop fits the script's
#: time); the reference's cells (``configs/arch.SHAPES``) are pod-sized
CARD_SHAPES = {"prefill_32k_b4": ShapeConfig("prefill_32k_b4", 32_768, 4,
                                             "prefill"),
               "train_1k_b4": ShapeConfig("train_1k_b4", 1024, 4, "train"),
               "train_256_b4": ShapeConfig("train_256_b4", 256, 4, "train")}
#: the ParallelConfig fields only a train step reads
_TRAIN_ONLY = ("remat", "microbatches", "logits_chunk", "opt_moment_dtype")
#: counts of the cells traced in this process, by the knobs they read
_MEMO: Dict = {}


def cell_shape(name: str) -> ShapeConfig:
    """A cell's shape: one of the reference's or of ``CARD_SHAPES``."""
    return SHAPES_BY_NAME[name] if name in SHAPES_BY_NAME else \
        CARD_SHAPES[name]


def _traced_knobs(pcfg: ParallelConfig, shape, on_mesh: bool = False) -> str:
    """The knobs the cell's step reads, as a key: two configs that differ
    only in others (``ONE_CARD_NOOP`` on one card, ``MESH_NOOP`` on a
    mesh; the train-only fields outside a train step) trace the same
    program, once."""
    skip = (MESH_NOOP if on_mesh else ONE_CARD_NOOP) + (
        () if shape.kind == "train" else _TRAIN_ONLY)
    return repr(dataclasses.replace(pcfg, **{
        k: getattr(ParallelConfig(), k) for k in skip}))


def _run_cell_args(a):
    return run_cell(*a)


def run_cells(cells, card: str, pcfg: Optional[ParallelConfig] = None,
              workers: int = 1, mesh=None) -> List[dict]:
    """``run_cell`` for each (arch, shape) of ``cells`` on ``mesh`` (None:
    one card), in order; with ``workers`` > 1 in that many spawned
    processes at once (a trace is single-threaded Python, and a process
    starts clean of the caller's CUDA state and process group)."""
    jobs = [(a, s, card, pcfg, None, mesh) for a, s in cells]
    if workers <= 1:
        return [run_cell(*j) for j in jobs]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        return list(ex.map(_run_cell_args, jobs))


def _pcfg_from_args(args) -> ParallelConfig:
    kw = {}
    if args.remat:
        kw["remat"] = args.remat
    if args.q_chunks:
        kw["attn_q_chunks"] = args.q_chunks
    if args.microbatches:
        kw["microbatches"] = args.microbatches
    if args.capacity_factor:
        kw["capacity_factor"] = args.capacity_factor
    if args.logits_chunk is not None:
        kw["logits_chunk"] = args.logits_chunk
    if args.attn_block_kv:
        kw["attn_block_kv"] = args.attn_block_kv
    if getattr(args, "opt_moment_dtype", None):
        kw["opt_moment_dtype"] = args.opt_moment_dtype
    if getattr(args, "no_flash", False):
        kw["flash_threshold"] = 1 << 30
    if getattr(args, "mlstm_chunk", None):
        kw["mlstm_chunk"] = args.mlstm_chunk
    if getattr(args, "mlstm_bf16", False):
        kw["mlstm_bf16_streams"] = True
    if getattr(args, "moe_combine", None):
        kw["moe_combine"] = args.moe_combine
    if getattr(args, "attn_block_q", None):
        kw["attn_block_q"] = args.attn_block_q
    if getattr(args, "grad_compression", None):
        kw["grad_compression"] = args.grad_compression
    if getattr(args, "grad_compression_topk", None):
        kw["grad_compression_topk"] = args.grad_compression_topk
    if args.rules:
        # "act_cache_seq=model,embed=None" style overrides
        pr = dict(ParallelConfig().param_rules)
        ar = dict(ParallelConfig().act_rules)
        for item in args.rules.split(","):
            k, v = item.split("=")
            tgt = None if v in ("None", "none", "") else (
                tuple(v.split("+")) if "+" in v else v)
            (ar if k.startswith("act_") else pr)[k] = tgt
        kw["param_rules"] = pr
        kw["act_rules"] = ar
    return ParallelConfig(**kw)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--card", default=None,
                    help="the card to plan for, as torch.cuda.get_device_name "
                         "names it (default: the card present)")
    ap.add_argument("--mesh", default=None,
                    choices=["single", "multi", "both"],
                    help="a production mesh of the card (single: 32 nodes x "
                         "8, multi: 2 x 32 x 8) or both; default one card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--q-chunks", dest="q_chunks", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--capacity-factor", dest="capacity_factor", type=float,
                    default=None)
    ap.add_argument("--logits-chunk", dest="logits_chunk", type=int,
                    default=None)
    ap.add_argument("--attn-block-kv", dest="attn_block_kv", type=int,
                    default=None)
    ap.add_argument("--opt-moment-dtype", dest="opt_moment_dtype",
                    default=None)
    ap.add_argument("--no-flash", dest="no_flash", action="store_true")
    ap.add_argument("--mlstm-chunk", dest="mlstm_chunk", type=int,
                    default=None)
    ap.add_argument("--mlstm-bf16", dest="mlstm_bf16", action="store_true")
    ap.add_argument("--moe-combine", dest="moe_combine", default=None,
                    choices=["gather", "a2a"])
    ap.add_argument("--attn-block-q", dest="attn_block_q", type=int,
                    default=None)
    ap.add_argument("--grad-compression", dest="grad_compression",
                    default=None, choices=["none", "topk", "int8"])
    ap.add_argument("--grad-compression-topk", dest="grad_compression_topk",
                    type=float, default=None)
    ap.add_argument("--rules", default=None,
                    help="logical=mesh overrides, comma-sep")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells traced at once, each in its own process")
    return ap


def present_card() -> str:
    """The name of the card present; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card present: name the card to plan for "
                           "with --card (e.g. --card \"NVIDIA H100 80GB "
                           "HBM3\")")
    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    card = args.card or present_card()
    card_memory(card)                    # a card with no recorded size raises
    pcfg = _pcfg_from_args(args)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = (list(SHAPES_BY_NAME) if (args.all or not args.shape)
              else [args.shape])
    cells = [(a, s) for a in archs for s in shapes]
    meshes = ([None] if args.mesh is None else ["single", "multi"]
              if args.mesh == "both" else [args.mesh])
    errors = 0
    for mesh in meshes:
        for rec in run_cells(cells, card, pcfg, workers=args.workers,
                             mesh=mesh):
            errors += rec["status"] == "error"
            tail = rec["mesh"] if mesh is None else \
                f"{rec['mesh']}-{card_kind(card)}"
            fname = outdir / (f"{args.tag}__{rec['arch']}__{rec['shape']}__"
                              f"{tail}.json")
            fname.write_text(json.dumps(rec, indent=1))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
