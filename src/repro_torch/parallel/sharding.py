"""Logical-axis sharding rules on a device mesh, kernel-dispatch, serving
and training knobs.

Port of ``repro/parallel/sharding.py``. ``ParallelConfig`` holds every
field of the reference's, with its defaults: ``param_rules`` and
``act_rules`` (the logical-axis rule tables), ``remat``, ``microbatches``,
``attn_block_q``, ``attn_block_kv``, ``attn_q_chunks``,
``capacity_factor``, ``logits_chunk``, ``opt_moment_dtype``,
``grad_compression`` and ``grad_compression_topk``, ``flash_threshold``,
``mlstm_chunk``, ``mlstm_bf16_streams``, ``moe_combine`` and ``kernel``.
``resolve_spec`` is the reference's pure rule resolution: it takes a
``torch.distributed`` ``DeviceMesh`` (``launch/mesh.make_host_mesh``), or
any object with ``axis_names`` and ``devices.shape``, and returns a tuple
where the reference returns a ``PartitionSpec``.

A JAX ``Mesh`` and ``NamedSharding`` become a ``DeviceMesh`` and DTensor
placements: :func:`placements` turns a resolved spec into one placement a
mesh dim, and a sharding is the pair ``(mesh, placements)``.
``param_shardings``, ``act_sharding``, ``ShardCtx`` and ``constrain`` are
the reference's on top of it; ``constrain`` is the identity off a mesh
(``px`` None, or a ``ShardCtx`` whose mesh is None) and otherwise
redistributes a DTensor to the resolved placements, the counterpart of
``with_sharding_constraint``: where a value lives changes, not what it is.
``block_local`` runs a block on each rank's own shard in plain tensors
(GSPMD computes it there too), for what DTensor does not place.
``shard_dims``, ``block_index``, ``gather_blocks`` and ``tokens_local``
serve the sequence rules (``act_seq``, ``act_cache_seq``): which mesh
dims split a sequence, a rank's block of it, the blocks gathered, and
products on a rank's rows.

``scan_layers`` is cut: a compile knob with no eager counterpart (the port
loops over layers). On a mesh ``moe_combine`` picks the constraint around
the experts' outputs as the reference's does; gradient compression runs
over the mesh's ``pod`` dim (``parallel/compression.py``) and, as in the
reference, on no training path. ``flash_vmem_bytes`` and
``attn_tile_occupancy`` are the reference's column arithmetic for the hard
sharding grids (``core/tuning_targets.sharding_space(hard=True)``); they
model the TPU's VMEM and cores, as the reference's do. The kernels'
resource models live in ``kernels/ops.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]

# Parameter logical axes. "embed" on weights is the ZeRO-3/FSDP axis.
DEFAULT_PARAM_RULES: Dict[str, Axis] = {
    "vocab": "model",
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "lora": None,
    "layers": None,
}

# Activation logical axes.
DEFAULT_ACT_RULES: Dict[str, Axis] = {
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_experts": "model",
    "act_group": "data",       # MoE dispatch groups
    "act_cache_seq": None,
    "act_vocab": "model",
}


@dataclass(frozen=True)
class KernelConfig:
    """Tuned kernel dispatch knobs.

    ``ParallelConfig.kernel is None`` (the default) keeps every model path on
    the plain PyTorch implementations. Block sizes come from the kernel
    tuning cells in ``repro_torch.kernels.tuning``. The defaults are blocks
    the CUDA kernels run at every head dim they take (the reference's 512 /
    512 prefill default needs 256 KB of shared memory at head dim 256), and
    the kernel's fused combine for the cross-split merge (the reference
    defaults to its tensor-op merge). The reference's ``interpret`` field
    has no counterpart: a CPU tensor takes the plain version, a CUDA tensor
    launches the kernel.
    """

    use_flash: bool = False          # flash attention on prefill
    flash_block_q: int = 128
    flash_block_kv: int = 128
    use_decode: bool = False         # split-KV flash decode per token
    decode_block_kv: int = 512
    decode_num_splits: int = 1
    # cross-split merge: "kernel" = fused into the split kernel's launch
    # (the reference's combine kernel), "torch" = tensor ops
    # (the reference's "jax" strategy); a tuning dimension of the decode cell
    decode_combine: str = "kernel"

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution + performance knobs, the reference's fields and
    defaults (``scan_layers`` cut). Every field is BO-tunable."""

    param_rules: Mapping[str, Axis] = field(
        default_factory=lambda: dict(DEFAULT_PARAM_RULES))
    act_rules: Mapping[str, Axis] = field(
        default_factory=lambda: dict(DEFAULT_ACT_RULES))
    remat: str = "none"              # none | dots | full
    microbatches: int = 1
    attn_block_q: int = 1024         # flash q block (read by no model path)
    attn_block_kv: int = 1024        # blockwise attention's kv block
    attn_q_chunks: int = 1           # causal q-chunking (1 = off)
    capacity_factor: Optional[float] = None  # override ArchConfig.moe
    logits_chunk: int = 1024         # chunked-softmax xent chunk (0 = unchunked)
    opt_moment_dtype: str = "float32"
    grad_compression: str = "none"   # none | topk | int8 (pod axis)
    grad_compression_topk: float = 0.05
    flash_threshold: int = 2048      # blockwise attention when seq >= this
    # chunkwise-parallel mLSTM chunk length (0 = per-step scan)
    mlstm_chunk: int = 0
    mlstm_bf16_streams: bool = False  # bf16 intra-chunk streams (state fp32)
    moe_combine: str = "gather"       # gather | a2a (a mesh reshard)
    kernel: Optional[KernelConfig] = None

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShardCtx:
    """Threaded through model code; mesh=None disables constraints."""

    mesh: Any
    pcfg: ParallelConfig

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {} if self.mesh is None else axis_sizes(self.mesh)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a JAX-like mesh (an
    object with ``axis_names`` and ``devices.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _pick(dims: Sequence[int], cand: Axis, sizes: Mapping[str, int],
          used: set) -> Tuple[str, ...]:
    """The mesh axes of the rule ``cand`` that split every one of ``dims``,
    in rule order: an axis the mesh lacks, one in ``used``, or one whose
    product with those picked before does not divide a dim is dropped."""
    if cand is None:
        return ()
    picked, prod = [], 1
    for ax in ((cand,) if isinstance(cand, str) else tuple(cand)):
        if ax in sizes and ax not in used and not any(
                d % (prod * sizes[ax]) for d in dims):
            picked.append(ax)
            prod *= sizes[ax]
    return tuple(picked)


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 rules: Mapping[str, Axis], mesh) -> Tuple:
    """Map logical axes to a partition spec, dropping invalid assignments:
    a mesh axis the mesh lacks, one another dimension of the tensor took,
    or one that does not divide the dimension. The result is the
    reference's ``PartitionSpec`` entries as a tuple (trailing ``None``
    dropped)."""
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        assign = _pick([dim], rules.get(name) if name is not None else None,
                       sizes, used)
        used.update(assign)
        out.append(None if not assign else
                   assign[0] if len(assign) == 1 else assign)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: Tuple, mesh) -> Tuple:
    """DTensor placements of a resolved spec, one a mesh dim: ``Shard(d)``
    where the mesh dim is assigned to tensor dim ``d``, ``Replicate()``
    elsewhere and on a mesh dim of size 1 (one shard is the whole tensor;
    DTensor would refuse to reshape a dim sharded one way). A dim sharded
    over several mesh dims (``("pod", "data")``) is split over them in
    mesh order, the outer mesh dim first, as the reference's rule tables
    name them."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, axes in enumerate(spec):
        for ax in ((axes,) if isinstance(axes, str) else axes or ()):
            where[ax] = d
    return tuple(Shard(where[n]) if n in where and size > 1 else Replicate()
                 for n, size in zip(mesh.mesh_dim_names, mesh.shape))


def param_shardings(specs_tree: Any, mesh, pcfg: ParallelConfig) -> Any:
    """A ``(mesh, placements)`` tree matching a ``ParamSpec`` tree."""
    from repro_torch.models.params import map_tree
    return map_tree(lambda spec: (mesh, placements(resolve_spec(
        spec.shape, spec.logical, pcfg.param_rules, mesh), mesh)), specs_tree)


def act_sharding(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh, pcfg: ParallelConfig) -> Tuple:
    """``(mesh, placements)`` of an activation by its logical axes."""
    return mesh, placements(resolve_spec(shape, logical, pcfg.act_rules,
                                         mesh), mesh)


def constrain(x, logical: Sequence[Optional[str]], px: Optional[ShardCtx]):
    """The reference's ``with_sharding_constraint`` by logical activation
    axes: the identity off a mesh, else ``x`` (a DTensor on the mesh)
    redistributed to the resolved placements, and its gradient back to
    the placements ``x`` had (the transpose of a sharding constraint is one
    on the cotangent), also where the two are equal. A pending sum
    (``Partial``) is reduced on the way."""
    if px is None or px.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("constrain on a mesh takes a DTensor; a plain "
                        "tensor here would be silently replicated")
    mesh, pl = act_sharding(x.shape, logical, px.mesh, px.pcfg)
    return x.redistribute(mesh, pl)


def gather_embed(tree: Any, specs: Any, px: Optional[ShardCtx]) -> Any:
    """The reference's ZeRO-3 on the weights a layer is about to use:
    each DTensor leaf's dims named ``embed`` (the FSDP axis of
    ``param_rules``) gathered whole, its other placements kept, as GSPMD
    gathers a weight whose contraction dim is split over the mesh axis
    that also splits the rows (``data``); the gather's backward
    reduce-scatters the gradient back to the weight's shards. ``specs``:
    the ``ParamSpec`` tree of ``tree``. Off a mesh, or where no leaf is so
    split (``embed_rule`` "none"), ``tree`` as it is. Without it DTensor
    plans each product alone and may move the activations instead (a
    head product then holds every row's logits on each rank)."""
    if px is None or px.mesh is None:
        return tree
    from torch.distributed.tensor import Replicate
    from repro_torch.models.params import leaves, map_tree_paths
    names = {path: s.logical for path, s in leaves(specs)}

    def whole(path, t):
        pl = tuple(Replicate() if q.is_shard() and
                   names[path][q.dim] == "embed" else q
                   for q in t.placements)
        return t if pl == tuple(t.placements) else t.redistribute(
            t.device_mesh, pl)
    return map_tree_paths(tree, {path: whole(path, t)
                                 for path, t in leaves(tree)})


def shard_dims(pl: Sequence, dim: int) -> Tuple[int, ...]:
    """The mesh dims whose placement in ``pl`` splits tensor dim ``dim``,
    in mesh order: of a resolved spec's placements (:func:`act_sharding`)
    and the sequence dim, the mesh dims its ``act_seq`` or
    ``act_cache_seq`` rule splits it over, none where no mesh axis of the
    rule divides it (a decode step's one token)."""
    return tuple(i for i, q in enumerate(pl) if q.is_shard(dim))


def block_index(mesh, dims: Sequence[int]) -> int:
    """This rank's block of a tensor dim split over the mesh dims ``dims``,
    as :func:`placements` splits it (the outer mesh dim first)."""
    coord, idx = mesh.get_coordinate(), 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def gather_blocks(t, mesh, dims: Sequence[int], dim: int):
    """Each rank's plain block ``t``, concatenated along ``dim`` over the
    mesh dims ``dims`` (an all-gather in each of them, in the order of
    :func:`block_index`); the other mesh dims keep what each rank holds.
    No gradient: for the serving paths."""
    if not dims:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = [Shard(dim) if i in dims else Replicate() for i in range(mesh.ndim)]
    return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


def local_block(t, mesh, pl: Tuple):
    """This rank's block, under placements ``pl``, of a plain tensor every
    rank built alike (positions): ``t`` itself where no placement splits
    it (a replicated block is the whole tensor, no copy), else its slice
    (``distribute_tensor``, no rank sending any)."""
    if not any(q.is_shard() for q in pl):
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, pl, src_data_rank=None).to_local()


def block_split(dims: Mapping[str, Sequence[int]], rules: Mapping[str, Axis],
                mesh) -> Dict[str, Tuple[str, ...]]:
    """The mesh axes that split each logical name of a block, ``dims``
    giving the sizes of the dims that bear it, in the order the names
    first appear: the axes of its rule that divide every one of those
    dims, each mesh axis going to one name at most (the first to claim
    it); a name with no axis left is whole."""
    sizes = axis_sizes(mesh)
    split: Dict[str, Tuple[str, ...]] = {}
    used: set = set()
    for n, ds in dims.items():
        split[n] = _pick(ds, rules.get(n), sizes, used)
        used.update(split[n])
    return split


def block_local(px: Optional[ShardCtx], fn, operands: Sequence,
                axes: Sequence, out_axes: Sequence):
    """``fn(*operands)``, which returns a tuple of tensors. Off a mesh, the
    call. On a mesh each rank runs ``fn`` on its own block, in plain
    tensors: for what DTensor does not place (index scatters, sorts, pads,
    concatenations) or places wrongly, and for loops of many small ops.

    ``axes`` holds each operand's logical activation axes: a tuple (one
    name or None a dim, trailing dims None where it is shorter), a tree of
    such tuples matching an operand that is a tree (a block's parameters),
    or None (every dim whole). Each name is split once for the whole
    block (:func:`block_split` of ``act_rules``); a dim whose name is
    split by no mesh axis, or that has none, is whole on every rank. A
    DTensor operand is redistributed to its block (an explicit
    redistribution), a plain tensor every rank built alike (positions)
    cut to it. Each output of ``fn`` is placed by its
    ``out_axes`` entry under the same split. The gradient of an operand's
    block is that rank's share of a sum (``Partial``) over the mesh dims
    that split a name the operand lacks (a parameter's over the rows'
    mesh dims), as GSPMD sums the blocks' contributions."""
    if px is None or px.mesh is None:
        return fn(*operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.models.params import leaves, map_tree_paths
    mesh, sizes = px.mesh, axis_sizes(px.mesh)

    def full(names, ndim):
        names = tuple(names or ())
        return names + (None,) * (ndim - len(names))

    flat = [[(path, t, full(dict(leaves(ax)).get(path) if ax is not None
                            else None, t.ndim)) for path, t in leaves(op)]
            for op, ax in zip(operands, axes)]
    dims: Dict[str, list] = {}
    for _, t, names in (leaf for op in flat for leaf in op):
        for n, d in zip(names, t.shape):
            if n is not None:
                dims.setdefault(n, []).append(d)
    split = block_split(dims, px.pcfg.act_rules, mesh)
    cut = {ax for picked in split.values() for ax in picked
           if sizes[ax] > 1}

    def place(names):
        return placements(tuple(split.get(n) if n else None for n in names),
                          mesh)

    def local(t, names):
        pl = place(names)
        if not isinstance(t, DTensor):
            return local_block(t, mesh, pl)
        share = tuple(q if isinstance(q, Shard) else
                      Partial() if ax in cut else Replicate()
                      for q, ax in zip(pl, mesh.mesh_dim_names))
        return t.redistribute(mesh, pl).to_local(grad_placements=share)

    out = fn(*(map_tree_paths(op, {path: local(t, names)
                                   for path, t, names in op_leaves})
               for op, op_leaves in zip(operands, flat)))
    if len(out) != len(out_axes):
        raise ValueError(f"block_local: {len(out)} outputs, "
                         f"{len(out_axes)} out_axes")
    return tuple(DTensor.from_local(o, mesh, place(full(names, o.ndim)),
                                    run_check=False)
                 for o, names in zip(out, out_axes))


def tokens_local(px: Optional[ShardCtx], fn, x, *weights, n_out: int = 1):
    """``fn(x, *weights)``: products of an activation x (B, S, ...) with
    weights. Where ``act_seq`` splits x's sequence on a mesh, each rank
    runs ``fn`` on its block of rows with every weight gathered whole
    (:func:`block_local`: a weight's gradient is that rank's share of a sum
    over the rows' mesh dims), and its ``n_out`` outputs are placed by
    rows, as x is: no product there flattens B and S, which torch 2.11's
    DTensor refuses where S is split (2.13 places it). Elsewhere, the
    call."""
    from torch.distributed.tensor import DTensor
    if px is None or px.mesh is None or not isinstance(x, DTensor) or \
            not shard_dims(x.placements, 1):
        return fn(x, *weights)
    rows = ("act_batch", "act_seq")
    out = block_local(
        px, lambda t, *w: (lambda o: o if n_out > 1 else (o,))(fn(t, *w)),
        (x,) + weights, (rows,) + (None,) * len(weights), (rows,) * n_out)
    return out if n_out > 1 else out[0]


@contextlib.contextmanager
def on_mesh(px: Optional[ShardCtx]):
    """Off a mesh nothing; on one, DTensor's implicit replication: a plain
    tensor that meets a DTensor is taken as replicated over the mesh, which
    is right for what every rank builds alike from shapes (positions,
    masks, step counts) and for nothing else. Usable as a decorator."""
    if px is None or px.mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


# ---------------------------------------------------------------------------
# kernel-residency arithmetic for HARD-constrained tuning grids
# ---------------------------------------------------------------------------
# Pure column arithmetic (ints or numpy arrays), the reference's, so the
# same expressions work as vectorized ``VectorConstraint`` predicates over a
# GenerativeSpace's candidate columns. They model the TPU (v5e) the
# reference's grids were built for, not the card: the hard space's
# fingerprint is the reference's only if its predicates are.

#: per-core on-chip vector memory (v5e)
VMEM_BYTES = 16 * 2 ** 20


def flash_vmem_bytes(block_q, block_kv, head_dim=128, *,
                     dtype_bytes=2, acc_bytes=4):
    """Per-grid-step VMEM residency of the blockwise flash-attention kernel:
    the bf16 Q/K/V tiles, the f32 logits tile, the f32 output accumulator,
    and the running max/denominator stats. Vectorizes over numpy columns."""
    q_tile = block_q * head_dim * dtype_bytes
    kv_tiles = 2 * block_kv * head_dim * dtype_bytes      # K and V
    logits = block_q * block_kv * acc_bytes
    acc = block_q * head_dim * acc_bytes
    stats = 2 * block_q * acc_bytes                       # rowmax + denom
    return q_tile + kv_tiles + logits + acc + stats


def attn_tile_occupancy(seq_len, block_q, block_kv, *, cores=8):
    """Grid steps per core of a (seq/block_q) x (seq/block_kv) attention
    tiling. Below 1.0 some cores idle every wave — the occupancy floor the
    hard grids enforce. Ceil-divides, so oversized blocks count as one."""
    q_steps = -(-seq_len // block_q)
    kv_steps = -(-seq_len // block_kv)
    return (q_steps * kv_steps) / cores
