"""Forward functions of every layer family.

Port of ``repro/models/layers.py``: ``rms_norm``, ``mlp``, RoPE, the plain
attention cores
(``_direct_attention``, the blockwise ``_flash_attention`` as a Python loop
over KV blocks where the reference runs ``lax.scan``, and
``_decode_attention``), ``gqa_attention`` with its kernel dispatch gates,
cross-attention, MLA (``mla_attention``), the KV-cache helpers,
``moe_block``, the RG-LRU block (its ``lax.associative_scan`` as a
log-depth doubling scan of the same combine) and the mLSTM and sLSTM
blocks (their ``lax.scan`` s as Python loops).

Functions take ``(params, x, *, cfg, pcfg, mode, cache, positions)`` and
return ``(y, new_cache)``; ``pcfg`` is the port's ``ParallelConfig``. On a
device mesh the training path also passes ``px``, a ``ShardCtx``
(``parallel/sharding.py``): every block places the reference's activation
constraints through it, ``moe_block`` splits its dispatch into the
reference's data x pod groups, and what DTensor does not place (the
attention cores, routing, the recurrences' convs, scans and loops) runs
on each rank's own block in plain tensors (``_heads_local``,
``sharding.block_local``), as GSPMD computes it there. ``px=None`` (every
serving path, as the reference serves off a mesh) places nothing and
dispatches in one group.
In decode every cache entry is updated in place (the reference returns
new arrays): a KV or latent cache has one slot a step written, a
recurrent state is copied into its buffer, so that a captured CUDA graph
of the step replays into the same buffers. Train mode (no cache) writes
nothing in place, so autograd differentiates every block; the flash gate
refuses a gradient (the kernel, as the reference's Pallas kernel, has no
backward).

For the dry-run (``launch/dryrun.py``), which traces the steps on meta
tensors, the per-step scans (the sLSTM, the mLSTM without chunks) run at
most ``trace_scan_steps`` steps on meta tensors (:func:`_scan_len`); the
dry-run scales what those steps cost to the whole sequence. The kernel
gates raise on meta tensors: the kernels take CPU or CUDA tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.arch import ArchConfig
from repro_torch.parallel.sharding import (ParallelConfig, ShardCtx,
                                           act_sharding, block_index,
                                           block_local, constrain,
                                           gather_blocks, local_block,
                                           shard_dims, tokens_local)

Cache = Optional[Dict[str, torch.Tensor]]

#: Steps a per-step scan runs on meta tensors, or None for all of them;
#: set by the dry-run around a trace, and read by no other path.
trace_scan_steps: Optional[int] = None
#: (block, sequence length, steps run) of each scan cut since the dry-run
#: last cleared it
scans_cut: list = []


def _scan_len(x: torch.Tensor, S: int, block: str) -> int:
    """Steps a per-step scan over ``S`` positions runs: all of them, but on
    meta tensors while the dry-run bounds them (``trace_scan_steps``).
    The steps not run produce no values (a meta tensor holds none):
    :func:`_stack_steps` fills their place."""
    if trace_scan_steps is None or S <= trace_scan_steps:
        return S
    if x.device.type != "meta":
        raise RuntimeError("trace_scan_steps bounds scans on meta tensors "
                           "only")
    scans_cut.append((block, S, trace_scan_steps))
    return trace_scan_steps


class _FillSteps(torch.autograd.Function):
    """The output of a scan the dry-run cut, at its whole length: a new
    (B, S, ...) tensor in place of the stack of all S steps' outputs (on
    meta tensors no value is read), whose gradient is the first T steps'.
    The stack of the T steps run plus this moves the bytes the whole
    stack would move a step, so the dry-run carries them to S exactly."""

    @staticmethod
    def forward(ctx, y, S):
        ctx.T = y.shape[1]
        return y.new_empty((y.shape[0], S) + tuple(y.shape[2:]))

    @staticmethod
    def backward(ctx, g):
        return g[:, :ctx.T], None


def _stack_steps(hs, S: int) -> torch.Tensor:
    """The steps' outputs stacked along dim 1, S of them; a scan the
    dry-run cut (fewer than S outputs, on meta tensors) is filled to S
    by :class:`_FillSteps`, so every shape downstream is whole."""
    y = torch.stack(hs, dim=1)
    return y if len(hs) == S else _FillSteps.apply(y, S)


def _refuse_meta(device) -> None:
    if torch.device(device).type == "meta":
        raise ValueError("a KernelConfig opts into a kernel, and the kernels "
                         "take CPU or CUDA tensors, not meta tensors: the "
                         "dry-run traces with kernel=None, as the "
                         "reference's does")

# ---------------------------------------------------------------------------
# basics


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """In fp32 with an fp32 scale, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
    if name == "geglu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def mlp(p, x: torch.Tensor, cfg: ArchConfig,
        px: Optional[ShardCtx] = None) -> torch.Tensor:
    h = tokens_local(px, lambda t, wg, wu: _act(cfg.mlp_act)(t @ wg)
                     * (t @ wu), x, p["wg"], p["wu"])
    h = constrain(h, ("act_batch", "act_seq", "act_mlp"), px)
    return tokens_local(px, lambda t, w: t @ w, h, p["wd"])


# ---------------------------------------------------------------------------
# RoPE


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (B,S) -> cos/sin (B,S,head_dim/2), fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B,S,H,hd); rotate-half convention; cos/sin cast to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# attention cores


def _direct_attention(q, k, v, *, q_pos, k_pos, window, scale):
    """Materialized-scores attention. q (B,Sq,H,hd), k (B,Sk,KV,hd), v
    (B,Sk,KV,hd_v) (MLA: hd_v differs from hd); GQA by head grouping."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    mask = k_pos[:, None, :] <= q_pos[:, :, None]           # (B,Sq,Sk) causal
    if window is not None:
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
    scores = scores.masked_fill(~mask[:, None, None, :, :], -math.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def _flash_attention(q, k, v, *, q_pos, k_pos, window, scale,
                     pcfg: ParallelConfig):
    """Blockwise online-softmax attention over KV blocks of
    ``pcfg.attn_block_kv`` (the reference's ``lax.scan``, here a Python
    loop): O(Sq x block) scores at a time instead of O(Sq x Sk). With
    ``pcfg.attn_q_chunks > 1`` each causal q-chunk reads the KV blocks up
    to its own end only. Shapes as :func:`_direct_attention`; the sequence
    must be a whole number of KV blocks, as the reference's reshape
    requires."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // KV
    bk = min(pcfg.attn_block_kv, Sk)
    nq = pcfg.attn_q_chunks
    n_chunks = nq if (Sq == Sk and Sq % nq == 0) else 1

    def run_chunk(qc, qc_pos, k_part, v_part, kp_part):
        if k_part.shape[1] % bk:
            raise ValueError(f"blockwise attention: {k_part.shape[1]} keys "
                             f"are not a whole number of blocks of {bk}")
        Sqc = qc.shape[1]
        qg = qc.reshape(B, Sqc, KV, G, hd)
        m = torch.full((B, KV, G, Sqc), -math.inf, device=q.device)
        l = torch.zeros((B, KV, G, Sqc), device=q.device)
        acc = torch.zeros((B, KV, G, Sqc, hd_v), device=q.device)
        for j in range(0, k_part.shape[1], bk):
            k_j, v_j = k_part[:, j:j + bk], v_part[:, j:j + bk]
            kp_j = kp_part[:, j:j + bk]
            s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_j).float() * scale
            msk = kp_j[:, None, :] <= qc_pos[:, :, None]
            if window is not None:
                msk &= kp_j[:, None, :] > qc_pos[:, :, None] - window
            s = s.masked_fill(~msk[:, None, None, :, :], -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # fully masked rows (m_new = -inf) contribute nothing
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v_j.dtype), v_j)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        return out.permute(0, 3, 1, 2, 4).reshape(B, Sqc, H, hd_v).to(q.dtype)

    if n_chunks == 1:
        return run_chunk(q, q_pos, k, v, k_pos)
    # causal q-chunking: chunk i sees KV up to its own end, rounded up to a
    # whole block
    outs = []
    cq = Sq // n_chunks
    for i in range(n_chunks):
        hi = (i + 1) * cq
        hi_k = -(-hi // bk) * bk
        outs.append(run_chunk(q[:, i * cq:hi], q_pos[:, i * cq:hi],
                              k[:, :hi_k], v[:, :hi_k], k_pos[:, :hi_k]))
    return torch.cat(outs, dim=1)


def _refuse_on_card(device, what: str) -> bool:
    """A kernel gate that is closed although the caller opted in: on the
    CPU the plain path runs, as the reference's gate sends it there
    (dispatch never changes semantics); on the card it raises, so that a
    caller who asked for the kernel never runs plain attention there."""
    if torch.device(device).type == "cuda":
        raise ValueError(f"the {what}; on the card a KernelConfig that "
                         "opts in runs the kernel or raises")
    return False


def _flash_kernel_ok(S: int, hd: int, hd_v: int, window, kc,
                     device, grad: bool = False) -> bool:
    """Static preconditions for the flash kernel (the reference's
    ``_pallas_flash_ok``): opted in via KernelConfig, plain causal attention
    (no local window) and equal q/k/v head dims, on either device: the
    kernel, like the Pallas one, has neither, so those layers run the
    plain attention the reference runs (``_prefill_attention``). Where the
    kernel would run and a gradient is wanted (``grad``: grad mode on and
    an operand requires grad), the gate raises on both devices: the kernel
    has no backward, as the Pallas kernel has none, and the plain path
    would be a silent substitute. A kernel shape whose sequence the blocks
    do not tile: see ``_refuse_on_card``."""
    if kc is None or not kc.use_flash or window is not None or hd != hd_v:
        return False
    _refuse_meta(device)
    if grad:
        raise ValueError("the flash kernel has no backward (nor has the "
                         "reference's Pallas kernel): train with "
                         "KernelConfig(use_flash=False)")
    bq, bkv = kc.flash_block_q, kc.flash_block_kv
    if S % bq or S % bkv:
        return _refuse_on_card(device, f"flash blocks ({bq}, {bkv}) do not "
                                       f"tile a prefill of {S}")
    return True


def _kernel_flash_attention(q, k, v, kc):
    """Prefill attention through the flash kernel. The kernel reads KV head
    ``h // G`` itself, so K and V go in unexpanded: for MQA that avoids the
    reference's ``jnp.repeat`` copy of G x the cache. Positions are
    contiguous from 0, as prefill produces them."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.flash_attention(
        q, k, v, block_q=kc.flash_block_q, block_kv=kc.flash_block_kv)


def _decode_kernel_ok(hd: int, hd_v: int, kc, device) -> bool:
    """Static preconditions for flash decode (the reference's
    ``_pallas_decode_ok``): opted in and equal k/v head dims. Windows,
    partial occupancy and capacities that do not tile are handled inside
    the wrapper (validity bias + padding). Opted in but refused: see
    ``_refuse_on_card``."""
    if kc is None or not kc.use_decode:
        return False
    _refuse_meta(device)
    if hd != hd_v:
        return _refuse_on_card(device, f"decode kernel takes equal k and v "
                                       f"head dims, not {hd} and {hd_v}")
    return True


def _kernel_decode_attention(q, k_cache, v_cache, *, cache_pos, cur_pos,
                             window, kc):
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.decode_attention(
        q, k_cache, v_cache, cache_pos, cur_pos, window=window,
        block_kv=kc.decode_block_kv, num_splits=kc.decode_num_splits,
        combine=kc.decode_combine)


def _decode_attention(q, k_cache, v_cache, *, cache_pos, cur_pos, window,
                      scale):
    """Single-token attention over a cache. q (B,1,H,hd), cache
    (B,S,KV,hd); cache_pos (B,S) holds each slot's position (-1 = empty)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() * scale
    valid = (cache_pos >= 0) & (cache_pos <= cur_pos[:, None])
    if window is not None:
        valid &= cache_pos > cur_pos[:, None] - window
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# GQA / MQA / MHA attention layer


def gqa_attention(p, x, *, cfg: ArchConfig, pcfg: ParallelConfig, mode: str,
                  cache: Cache, positions, window=None,
                  px: Optional[ShardCtx] = None
                  ) -> Tuple[torch.Tensor, Cache]:
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    q, k, v = tokens_local(px, lambda t, *w: tuple(
        torch.einsum("bsd,dhk->bshk", t, u) for u in w), x, p["wq"],
        p["wk"], p["wv"], n_out=3)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = constrain(q, ("act_batch", "act_seq", "act_heads", None), px)
    k = constrain(k, ("act_batch", "act_seq", "act_kv_heads", None), px)
    kc = pcfg.kernel

    new_cache = cache
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        slot = _cache_slot(positions[:, 0], cache["k"].shape[1], window)
        _insert_slot(cache["k"], k, slot, px)
        _insert_slot(cache["v"], v, slot, px)
        _insert_slot(cache["pos"], positions, slot, px)
        out = _decode_local(px, q, cache, positions[:, 0], window=window,
                            scale=scale, kc=kc)
    else:
        grad = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in (q, k, v))
        # the flash kernel takes a whole causal sequence from position 0:
        # on a sequence split each rank gathers Q whole for it and keeps its
        # rows, as GSPMD does around the reference's Pallas call
        flash = _flash_kernel_ok(S, hd, v.shape[-1], window, kc, x.device,
                                 grad=grad)
        out = _heads_local(px, lambda q_, k_, v_, qp, kp: _prefill_attention(
            q_, k_, v_, q_pos=qp, k_pos=kp, window=window, scale=scale,
            pcfg=pcfg, device=x.device), q, k, v, positions, whole_q=flash)
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill fills a cache")
            kv = ("act_batch", None, "act_kv_heads")
            new_cache = dict(zip(("k", "v", "pos"), block_local(
                px, lambda *t: tuple(_prefill_cache(
                    *t, cache["k"].shape[1], window).values()),
                (k, v, positions), (kv, kv, ("act_batch",)),
                (kv, kv, ("act_batch",)))))
            new_cache = _cache_placed(new_cache, px)
    out = constrain(out, ("act_batch", "act_seq", "act_heads", None), px)
    y = tokens_local(px, _out_proj, out, p["wo"])
    return y, new_cache


def _out_proj(out, wo):
    """The attention output (B,S,H,hd) times wo (H,hd,d)."""
    return torch.einsum("bshk,hkd->bsd", out, wo)


#: a cache leaf's logical axes by name (``model.CACHE_AXES`` for every
#: layer kind): a KV cache, its positions and MLA's latent cache along
#: ``act_cache_seq``
KV_CACHE_AXES = ("act_batch", "act_cache_seq", "act_kv_heads", None)
POS_CACHE_AXES = ("act_batch", "act_cache_seq")
LATENT_CACHE_AXES = ("act_batch", "act_cache_seq", None)
_CACHE_LEAF_AXES = {"k": KV_CACHE_AXES, "v": KV_CACHE_AXES,
                    "pos": POS_CACHE_AXES, "c_kv": LATENT_CACHE_AXES,
                    "k_rope": LATENT_CACHE_AXES}


def _cache_placed(cache: Dict[str, torch.Tensor], px: Optional[ShardCtx]
                  ) -> Dict[str, torch.Tensor]:
    """A prefill's new cache, built whole along its slots on each rank,
    placed by its cache axes, so that it lands where decode reads it
    (``model.place_cache``): under ``act_cache_seq`` each rank keeps its
    block of the slots. Off a mesh, the cache."""
    return {n: constrain(t, _CACHE_LEAF_AXES[n], px)
            for n, t in cache.items()}


def _kv_heads(t, first: int, n: int, G: int):
    """The K or V heads (dim 2) of query heads ``first`` .. ``first + n``
    (query head h reads KV head h // G): a slice where the heads cover whole
    groups or lie in one group (no copy), else one KV head a query head."""
    lo, hi = first // G, (first + n - 1) // G + 1
    if hi - lo == 1 or (first % G == 0 and n % G == 0):
        return t[:, :, lo:hi]
    return t[:, :, (first + torch.arange(n, device=t.device)) // G]


def _heads_local(px: Optional[ShardCtx], core, q, k, v, positions=None, *,
                 whole_q: bool = False):
    """``core(q, k, v, q_pos, k_pos)``, an attention core (positions may
    be None: cross-attention has none). Off a mesh, the call with both
    positions ``positions``. On a mesh each rank runs it on its own batch
    rows, query rows and query heads, Q placed by the ``act_seq`` and
    ``act_heads`` rules as ``gqa_attention``'s constraint places it (GSPMD
    computes there too), with its rows' positions; K and V are placed by
    the ``act_kv_heads`` rule but gathered whole along the sequence (an
    all-gather over the mesh dims that split it), with every key's
    position. Where a rank holds a slice of the query heads and every KV
    head, it takes the KV heads of its query heads. A gradient a rank gives
    K or V is its share of a sum over the mesh dims that split the query
    rows, or its heads where K and V are whole (reduce-scattered back to
    their blocks). ``whole_q``: the rank gathers Q whole along the sequence
    for the core and keeps its own rows of the output (the flash kernel,
    which takes a whole sequence)."""
    if px is None or px.mesh is None:
        return core(q, k, v, positions, positions)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = px.mesh
    _, qp = act_sharding(q.shape, ("act_batch", "act_seq", "act_heads", None),
                         mesh, px.pcfg)
    _, kp = act_sharding(k.shape, ("act_batch", "act_seq", "act_kv_heads",
                                   None), mesh, px.pcfg)
    rows = shard_dims(qp, 1)
    # K and V whole along the sequence; their heads split only where the
    # queries' are
    kp = tuple(p if p.is_shard(0) or (p.is_shard(2) and qp[i].is_shard(2))
               else Replicate() for i, p in enumerate(kp))
    heads = shard_dims(qp, 2)
    share = tuple(Partial() if i in rows or (i in heads and not
                                             p.is_shard(2)) else p
                  for i, p in enumerate(kp))
    k, v = (t.redistribute(mesh, kp).to_local(grad_placements=share)
            for t in (k, v))
    cp = tuple(Replicate() if i in rows else p for i, p in enumerate(qp)) \
        if whole_q else qp
    ql = q.redistribute(mesh, cp).to_local()
    if heads and not shard_dims(kp, 2):
        G = q.shape[2] // k.shape[2]
        first = block_index(mesh, heads) * ql.shape[2]
        k, v = (_kv_heads(t, first, ql.shape[2], G) for t in (k, v))
    q_pos = k_pos = None
    if positions is not None:
        _, pp = act_sharding(positions.shape, ("act_batch", "act_seq"), mesh,
                             px.pcfg)
        whole = tuple(Replicate() if p.is_shard(1) else p for p in pp)
        q_pos = local_block(positions, mesh, whole if whole_q else pp)
        k_pos = local_block(positions, mesh, whole)
    out = DTensor.from_local(core(ql, k, v, q_pos, k_pos), mesh, cp,
                             run_check=False)
    return out if cp == qp else out.redistribute(mesh, qp)


def _prefill_attention(q, k, v, *, q_pos, k_pos, window, scale,
                       pcfg: ParallelConfig, device):
    """The reference's prefill dispatch: the flash kernel where its gate
    opens, else the blockwise attention from ``flash_threshold`` keys,
    else the materialized scores. ``q_pos`` the queries' positions, a
    block of ``k_pos`` on a sequence split (``_heads_local``)."""
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if _flash_kernel_ok(q.shape[1], q.shape[-1], v.shape[-1], window,
                        pcfg.kernel, device, grad=grad):
        return _kernel_flash_attention(q, k, v, pcfg.kernel)
    if k.shape[1] >= pcfg.flash_threshold:
        return _flash_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                window=window, scale=scale, pcfg=pcfg)
    return _direct_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                             window=window, scale=scale)


def _decode_partials(q, k_cache, v_cache, cache_pos, cur_pos, *, window,
                     kc):
    """One token over a block of the cache as unnormalized partials
    (o (B,KV,n,G,hd), m and l (B,KV,n,G), fp32): the split kernel's
    partials mode where ``kc`` opts in (its ``num_splits`` splits), else
    its plain version in one split. A block with no valid slot gives
    m = -inf, l = 0 and o = 0, which the merge weighs 0."""
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    tile = 1 if kc is None else kc.decode_num_splits * kc.decode_block_kv
    bias = kernel_ops.decode_bias(cache_pos, cur_pos, window, tile)
    if kc is None:
        return ref.decode_split(q[:, 0], k_cache, v_cache, bias, 1)
    return kfd.decode_split(q[:, 0], k_cache, v_cache, bias,
                            block_kv=kc.decode_block_kv,
                            num_splits=kc.decode_num_splits)


def _decode_local(px: Optional[ShardCtx], q, cache, cur_pos, *, window,
                  scale, kc):
    """One decode step's attention of q (B,1,H,hd) over a KV cache
    (``k``, ``v``, ``pos``), through the kernel where ``_decode_kernel_ok``
    opens (the reference's ``_pallas_decode_ok``, on a mesh too), else the
    plain path. On a mesh each rank attends with its rows over its block of
    the cache, in plain tensors, its query heads following the cache's KV
    heads. Where the cache's slots are whole (the default rules) the rank
    runs the fused launch as off the mesh. Where ``act_cache_seq`` splits
    them, the rank holds every query head of its KV heads, gives the
    partials of its slots (``_decode_partials``), gathers the partials
    over the mesh dims that split the slots and merges them by the
    log-sum-exp combine (``ref.combine_partials``), so each holds the whole
    output of its heads."""
    kernel = _decode_kernel_ok(q.shape[-1], cache["v"].shape[-1], kc,
                               q.device)
    kc = kc if kernel else None
    if px is None or px.mesh is None:
        return _decode_core(q, cache["k"], cache["v"], cache["pos"], cur_pos,
                            window=window, scale=scale, kc=kc)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ref
    mesh, cp = px.mesh, tuple(cache["k"].placements)
    _, own = act_sharding(q.shape, ("act_batch", None, "act_heads", None),
                          mesh, px.pcfg)
    # q's rows as the cache's, its heads as the cache's KV heads where they
    # are split, whole where the slots are, else by its own rule
    qp = tuple(c if c.is_shard(0) or c.is_shard(2) else
               Shard(2) if not c.is_shard(1) and o.is_shard(2) else
               Replicate() for c, o in zip(cp, own))
    ql = q.redistribute(mesh, qp).to_local()
    kl, vl, pl = (cache[n].to_local() for n in ("k", "v", "pos"))
    cur = local_block(cur_pos, mesh, tuple(c if c.is_shard(0) else
                                           Replicate() for c in cp))
    heads = shard_dims(qp, 2)
    if heads:
        G = q.shape[2] // cache["k"].shape[2]
        first = block_index(mesh, heads) * ql.shape[2]
        kv0 = block_index(mesh, shard_dims(cp, 2)) * kl.shape[2]
        kl, vl = (_kv_heads(t, first - kv0 * G, ql.shape[2], G)
                  for t in (kl, vl))
    seq = shard_dims(cp, 1)
    if not seq:
        out = _decode_core(ql, kl, vl, pl, cur, window=window, scale=scale,
                           kc=kc)
    else:
        parts = _decode_partials(ql, kl, vl, pl, cur, window=window, kc=kc)
        o, m, l = (gather_blocks(t, mesh, seq, 2) for t in parts)
        B, _, Hl, hd = ql.shape
        out = ref.combine_partials(o, m, l).reshape(B, 1, Hl, hd).to(
            ql.dtype)
    return DTensor.from_local(out, mesh, qp, run_check=False)


def _decode_core(q, k_cache, v_cache, cache_pos, cur_pos, *, window, scale,
                 kc):
    """Decode attention over a whole cache: the kernel's fused launch where
    ``kc`` is given (its gate opened), else the plain path."""
    if kc is not None:
        return _kernel_decode_attention(q, k_cache, v_cache,
                                        cache_pos=cache_pos, cur_pos=cur_pos,
                                        window=window, kc=kc)
    return _decode_attention(q, k_cache, v_cache, cache_pos=cache_pos,
                             cur_pos=cur_pos, window=window, scale=scale)


def _cross_core(q, k, v):
    """Attention of q (B,Sq,H,hd) over k, v (B,Sc,KV,hd), GQA by head
    grouping: no mask, no position."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() / math.sqrt(hd)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", prob.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def cross_attention(p, x, cond_kv, *, cfg: ArchConfig,
                    px: Optional[ShardCtx] = None) -> torch.Tensor:
    """Attention over precomputed (k, v) of the conditioning embeddings:
    no mask, no position. On a mesh the core runs on each rank's rows and
    heads (``_heads_local``); the reference places no constraint here, so
    GSPMD computes the plain core on each shard too."""
    q = tokens_local(px, lambda t, w: torch.einsum("bsd,dhk->bshk", t, w),
                     x, p["wq"])
    k, v = cond_kv
    out = _heads_local(px, lambda q_, k_, v_, *_: _cross_core(q_, k_, v_),
                       q, k, v)
    return tokens_local(px, _out_proj, out, p["wo"])


def cond_kv(p, cond, *, cfg: ArchConfig):
    k = torch.einsum("bsd,dhk->bshk", cond, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", cond, p["wv"])
    return k, v


def _cache_slot(pos, capacity, window):
    """Rolling slot for windowed caches; direct slot otherwise."""
    return torch.remainder(pos, capacity) if window is not None else pos


def _insert_slot(buf, val, slot, px: Optional[ShardCtx] = None):
    """Write val (B,1,...) at per-batch slot (B,) along axis 1, in place.
    On a mesh ``buf`` is a DTensor (``model.place_cache``) and each rank
    writes its own block of it: ``val`` placed as ``buf`` is (whole along
    its one slot), ``slot`` cut to the rank's rows (DTensor refuses an
    index write in place). Where ``act_cache_seq`` splits the slots, the
    rank whose block holds a row's slot writes it and the others write
    that slot's old value back (no branch on values: a captured graph
    replays it)."""
    if px is None or px.mesh is None:
        buf[torch.arange(buf.shape[0], device=buf.device), slot] = val[:, 0]
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh, pl = px.mesh, tuple(buf.placements)
    whole = tuple(Replicate() if q.is_shard(1) else q for q in pl)
    val = (val.redistribute(mesh, whole).to_local()
           if isinstance(val, DTensor) else local_block(val, mesh, whole))
    rows = tuple(q if q.is_shard(0) else Replicate() for q in pl)
    slot = local_block(slot, mesh, rows)
    local = buf.to_local()
    seq = shard_dims(pl, 1)
    if not seq:
        _insert_slot(local, val, slot)
        return
    n = local.shape[1]
    at = slot - block_index(mesh, seq) * n
    hit = (at >= 0) & (at < n)
    at = torch.clamp(at, 0, n - 1)
    b = torch.arange(local.shape[0], device=local.device)
    old = local[b, at]
    hit = hit.reshape(hit.shape + (1,) * (old.ndim - 1))
    local[b, at] = torch.where(hit, val[:, 0], old)


def _prefill_cache(k, v, positions, cap, window):
    """Prefill K/V as a fresh cache of capacity ``cap`` (the last ``cap``
    tokens if the prompt is longer; empty slots hold position -1)."""
    B, S = positions.shape
    if S >= cap:
        kk, vv, pp = k[:, S - cap:], v[:, S - cap:], positions[:, S - cap:]
        if window is not None:
            # decode inserts at slot = pos % cap; slot s must hold the entry
            # whose position is s (mod cap): source j = (s - p0) mod cap
            idx = (torch.arange(cap, device=pp.device)[None, :]
                   - pp[:, 0:1]) % cap
            kk = torch.take_along_dim(kk, idx[..., None, None], dim=1)
            vv = torch.take_along_dim(vv, idx[..., None, None], dim=1)
            pp = torch.take_along_dim(pp, idx, dim=1)
        return {"k": kk.contiguous(), "v": vv.contiguous(),
                "pos": pp.contiguous()}
    pad = cap - S
    kk = F.pad(k, (0, 0, 0, 0, 0, pad))
    vv = F.pad(v, (0, 0, 0, 0, 0, pad))
    pp = F.pad(positions, (0, pad), value=-1)
    return {"k": kk, "v": vv, "pos": pp}


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based dispatch with static shapes)


def moe_capacity(T: int, cfg: ArchConfig, pcfg: ParallelConfig) -> int:
    """Slots per expert for T tokens in one dispatch group:
    min(max(ceil(T k / E x capacity_factor), k), T), the factor from
    ``pcfg`` where it is set, else the config's."""
    mo = cfg.moe
    cf = pcfg.capacity_factor or mo.capacity_factor
    return min(int(max(math.ceil(T * mo.top_k / mo.num_experts * cf),
                       mo.top_k)), T)


def moe_route(p, xg: torch.Tensor, *, cfg: ArchConfig, C: int):
    """The router and the dispatch plan of T tokens xg (..., T, d), each
    leading index a dispatch group of its own, as the reference computes
    them: fp32 scores (..., T, E) (softmax, or sigmoid with
    ``router_bias`` added for the choice only), the top_k experts of each
    token (..., T, K) by a stable descending sort, so that ties go to the
    lower expert index as ``lax.top_k`` breaks them, the gate weights
    renormalized over the chosen k, and each (token, k) copy's slot in its
    expert from a cumsum of one-hot rows over the group's copies in
    token-major order: slot C (the drop slot) where the expert is full.
    Returns (top_idx, weights, slot (..., T*K), keep (..., T*K), scores,
    one-hot (..., E, T*K) bool)."""
    mo = cfg.moe
    E, K = mo.num_experts, mo.top_k
    logits = xg.float() @ p["router"].float()                  # (..., T, E)
    if mo.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"].float()
    else:
        scores = torch.softmax(logits, dim=-1)
        sel = scores
    top_idx = torch.sort(sel, dim=-1, descending=True,
                         stable=True).indices[..., :K]          # (..., T, K)
    gate = torch.gather(scores, -1, top_idx)
    weights = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    # one-hot rows expert-major, (..., E, T*K), so that the cumsum runs
    # along the contiguous dim (a scan down the copies' dim of a (T*K, E)
    # table takes most of a prefill on the card)
    flat_e = top_idx.flatten(-2)
    oh = torch.arange(E, device=xg.device)[:, None] == flat_e[..., None, :]
    pos = torch.gather(torch.cumsum(oh, dim=-1, dtype=torch.int32), -2,
                       flat_e[..., None, :])[..., 0, :].long() - 1
    keep = pos < C
    slot = torch.where(keep, pos, torch.full_like(pos, C))
    return top_idx, weights, slot, keep, scores, oh


def moe_groups(T: int, px: Optional[ShardCtx]) -> int:
    """Dispatch groups of T tokens: the reference's data x pod groups on a
    mesh (each rank routes its own), 1 off a mesh or where T is not a
    whole number of them."""
    sizes = px.axis_sizes if px is not None else {}
    G = max(sizes.get("data", 1) * sizes.get("pod", 1), 1)
    return G if T % G == 0 else 1


def _dispatch(p, xg: torch.Tensor, *, cfg: ArchConfig, C: int):
    """Route each group of xg (G, Tg, d) (:func:`moe_route`) and gather its
    tokens into the experts' buffers (G, E, C, d): one scatter of token ids
    into a (G, E, C + 1) table and one gather of the activations. A
    dropped copy's id goes to column C, which is sliced away before the
    gather, so which duplicate lands there (the scatter's order is not
    fixed on the card) never reaches the output; the sentinel id Tg reads
    a row of zeros for an unfilled slot. Also returns each group's
    load-balance term, sum over experts of f_e x p_e (Switch): (G,)."""
    G, Tg, d = xg.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    top_idx, weights, slot, keep, scores, oh = moe_route(p, xg, cfg=cfg, C=C)
    g = torch.arange(G, device=xg.device)[:, None]
    idx_buf = torch.full((G, E, C + 1), Tg, dtype=torch.long,
                         device=xg.device)
    idx_buf[g, top_idx.flatten(-2), slot] = torch.arange(
        Tg, device=xg.device).repeat_interleave(K)
    x_pad = torch.cat([xg, xg.new_zeros((G, 1, d))], dim=1)
    buf = x_pad[g, idx_buf[:, :, :C].reshape(G, E * C)].reshape(G, E, C, d)
    balance = torch.sum(oh.float().mean(dim=-1) * scores.mean(dim=-2), dim=-1)
    return buf, top_idx, weights, slot, keep, balance


def _combine(out_buf: torch.Tensor, top_idx, slot, keep, weights, K: int):
    """Each copy's row of the experts' outputs (G, E, C, d), padded with a
    drop slot C of zeros, weighted by its gate, summed over the k copies
    of each token: (G, Tg, d)."""
    G, Tg = top_idx.shape[:2]
    out_buf = F.pad(out_buf, (0, 0, 0, 1))                      # drop slot -> 0
    g = torch.arange(G, device=out_buf.device)[:, None]
    pos_k, keep_k = slot.reshape(G, Tg, K), keep.reshape(G, Tg, K)
    y = torch.zeros((G, Tg, out_buf.shape[-1]), dtype=out_buf.dtype,
                    device=out_buf.device)
    for j in range(K):
        gathered = out_buf[g, top_idx[:, :, j], pos_k[:, :, j]]  # (G, Tg, d)
        w = (weights[:, :, j] * keep_k[:, :, j]).to(out_buf.dtype)
        y = y + gathered * w[..., None]
    return y


def _experts(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's einsum ``gecd,edf->gecf``: for each expert e, the
    rows of every group (G, E, C, d) times w[e] (E, d, f), as one batched
    product over E with the groups' rows stacked (E, G x C, d), E the
    outer dim (the one placed over ``model``)."""
    G, E, C, _ = a.shape
    rows = a.transpose(0, 1).reshape(E, G * C, a.shape[-1])
    return torch.bmm(rows, w).reshape(E, G, C, -1).transpose(0, 1)


def _experts_local(px: Optional[ShardCtx], fn, w, buf: torch.Tensor):
    """``fn(w, buf)``, the experts' products of their buffers (G, E, C, d).
    Off a mesh, the call. On a mesh each rank runs it on the block of
    groups and experts it holds, in plain tensors: each weight placed with
    its experts' dim as ``buf``'s E dim and gathered whole elsewhere (the
    FSDP gather), ``buf`` as constrained; the output placed as ``buf``. A
    weight's gradient from a rank's groups is its share of the sum over the
    mesh dims that split the groups. The reference's constraint on the
    hidden activation resolves to ``buf``'s placement (``mlp``'s model axis
    is the experts'), which the block keeps."""
    if px is None or px.mesh is None:
        return fn(w, buf)
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from repro_torch.models.params import map_tree
    mesh, bp = px.mesh, tuple(buf.placements)
    wp = tuple(Shard(0) if pl == Shard(1) else Replicate() for pl in bp)
    share = tuple(Partial() if pl == Shard(0) else q
                  for pl, q in zip(bp, wp))
    local = map_tree(lambda t: t.redistribute(mesh, wp).to_local(
        grad_placements=share), w)
    out = fn(local, buf.to_local())
    return DTensor.from_local(out, mesh, bp, run_check=False)


def moe_block(p, x: torch.Tensor, *, cfg: ArchConfig, pcfg: ParallelConfig,
              px: Optional[ShardCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,d), aux loss (fp32 scalar)), the reference's
    ``moe_block``: the T = B x S tokens in G dispatch groups
    (:func:`moe_groups`), each routing its Tg = T / G tokens into C slots
    of each expert (:func:`moe_capacity` of Tg), so that the groups, and
    not the whole batch, decide which copies drop.

    :func:`_dispatch` routes and gathers each group's tokens, on a mesh on
    the ranks that hold the group (``sharding.block_local``); the experts are
    batched products over (G, E, C, d) with E placed over ``model`` (the
    reference's expert parallelism); :func:`_combine` gathers each copy's
    row back, weighted by its gate. Every shape is static and nothing is
    read back to the host, so a decode step that holds this block is
    captured as a CUDA graph."""
    mo = cfg.moe
    B, S, d = x.shape
    E, K = mo.num_experts, mo.top_k
    T = B * S
    G = moe_groups(T, px)
    C = moe_capacity(T // G, cfg, pcfg)
    # on a mesh the residual stream arrives as a sum pending over model (the
    # attention's output product) and its gradient placed as the next
    # layer leaves it: both are placed by batch about the group reshapes,
    # the sequence whole (DTensor gets a reshape's local shapes wrong for
    # other placements; the groups' constraint gathers it whole anyway)
    x = constrain(x, ("act_batch", None, "act_embed"), px)
    xr = x.reshape(G, T // G, d)
    xg = constrain(xr, ("act_group", None, "act_embed"), px)
    route = {k: p[k] for k in ("router", "router_bias") if k in p}
    groups = ("act_group",)
    buf, top_idx, weights, slot, keep, balance = block_local(
        px, lambda rp, xl: _dispatch(rp, xl, cfg=cfg, C=C), (route, xg),
        (None, groups), (groups,) * 6)
    buf = constrain(buf, ("act_group", "act_experts", None, None), px)

    def experts(w, b):
        h = _act(cfg.mlp_act)(_experts(b, w["wg"])) * _experts(b, w["wu"])
        return _experts(h, w["wd"])
    out_buf = _experts_local(px, experts, {k: p[k] for k in ("wg", "wu",
                                                              "wd")}, buf)
    a2a = pcfg.moe_combine == "a2a"
    # "a2a": the reference's axis swap of E for d over model (an all-to-all
    # in GSPMD); the combine then reads every expert of its groups
    out_buf = constrain(out_buf, ("act_group", None, None, "act_mlp") if a2a
                        else ("act_group", "act_experts", None, None), px)
    (y,) = block_local(px, lambda *t: (_combine(*t, K),),
                       (out_buf, top_idx, slot, keep, weights), (groups,) * 5,
                       (groups,))
    if a2a:
        y = constrain(y, ("act_group", None, "act_mlp"), px)

    if mo.num_shared_experts > 0:
        y = y + mlp(p["shared"], xg, cfg, px)

    # load-balance aux (Switch-style): E * mean over groups of
    # sum_e f_e * p_e
    aux = torch.mean(balance) * E * mo.router_aux_weight
    if px is not None and px.mesh is not None:
        # back to the groups' placement by batch before the reshape back:
        # where the groups outnumber what splits the batch (B 32 on the
        # multi mesh's pod x data 64: a group is half a sequence), torch
        # 2.11's DTensor gives the reshape a wrong local shape
        y = y.redistribute(px.mesh, xr.placements)
    y = constrain(y.reshape(B, S, d), ("act_batch", "act_seq", "act_embed"), px)
    return y, aux


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)


def mla_attention(p, x, *, cfg: ArchConfig, pcfg: ParallelConfig, mode: str,
                  cache: Cache, positions, px: Optional[ShardCtx] = None
                  ) -> Tuple[torch.Tensor, Cache]:
    """Prefill expands k_nope and v per head from the latent ``c_kv`` and
    runs the reference's prefill dispatch (q/k head dim dn + dr against v's
    dv: never the flash kernel); decode is the absorbed-weight form, scores
    and context in the compressed space over the ``c_kv``/``k_rope`` latent
    cache. On a mesh ``q_nope`` takes the reference's constraint and the
    prefill core runs on each rank's rows and heads (``block_local``), the
    one ``k_rope`` head whole on each."""
    m = cfg.mla
    S = x.shape[1]
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(dn + dr)

    q_a, kv_a, k_rope = tokens_local(
        px, lambda t, *w: tuple(t @ u for u in w), x, p["wq_a"], p["wkv_a"],
        p["wk_rope"], n_out=3)                 # k_rope (B,S,dr): every head's
    q_lat = rms_norm(q_a, p["q_a_norm"]["scale"], cfg.norm_eps)
    q = tokens_local(px, lambda t, w: torch.einsum("bsl,lhk->bshk", t, w),
                     q_lat, p["wq_b"])                       # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    c_kv = rms_norm(kv_a, p["kv_a_norm"]["scale"], cfg.norm_eps)

    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    q_nope = constrain(q_nope, ("act_batch", "act_seq", "act_heads", None), px)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        slot = positions[:, 0]
        _insert_slot(cache["c_kv"], c_kv, slot, px)
        _insert_slot(cache["k_rope"], k_rope, slot, px)
        _insert_slot(cache["pos"], positions, slot, px)

        def scores(q_nope, q_rope, ckv, krope, pos, cur, wk_nope):
            q_c = torch.einsum("bshn,lhn->bshl", q_nope, wk_nope)
            s = (torch.einsum("bshl,btl->bhst", q_c, ckv)
                 + torch.einsum("bshr,btr->bhst", q_rope, krope)).float()
            s = s * scale
            valid = (pos >= 0) & (pos <= cur[:, :1])             # (B, cap)
            return s.masked_fill(~valid[:, None, None, :], -math.inf)

        def absorbed(q_nope, q_rope, ckv, krope, pos, cur, wk_nope, wv):
            s = scores(q_nope, q_rope, ckv, krope, pos, cur, wk_nope)
            prob = torch.softmax(s, dim=-1)
            ctx_c = torch.einsum("bhst,btl->bshl", prob.to(ckv.dtype), ckv)
            return (torch.einsum("bshl,lhv->bshv", ctx_c, wv),)  # (B,1,H,dv)

        rows = ("act_batch",)
        seq = () if px is None or px.mesh is None else shard_dims(
            cache["c_kv"].placements, 1)
        if not seq:
            # on a mesh each rank attends with its rows and heads over its
            # rows of the latent cache, written in place above
            heads = ("act_batch", None, "act_heads")
            (out,) = block_local(
                px, absorbed, (q_nope, q_rope, cache["c_kv"],
                               cache["k_rope"], cache["pos"], positions,
                               p["wk_nope"], p["wv"]),
                (heads, heads, rows, rows, rows, rows, (None, "act_heads"),
                 (None, "act_heads")), (heads,))
            return tokens_local(px, _out_proj, out, p["wo"]), cache

        def merged(ckv, krope, pos, q_nope, q_rope, cur, wk_nope, wv):
            # the partials of the rank's slots, every head: unnormalized
            # context in the latent space (B,1,1,H,r) and (m, l) (B,1,1,H)
            s = scores(q_nope, q_rope, ckv, krope, pos, cur, wk_nope)
            m = s.amax(dim=-1)                                 # (B,H,1)
            p_ = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[
                ..., None])                                    # exp(-inf) = 0
            o = torch.einsum("bhst,btl->bshl", p_.to(ckv.dtype).float(),
                             ckv.float())
            parts = (o[:, None], m.transpose(1, 2)[:, None],
                     p_.sum(dim=-1).transpose(1, 2)[:, None])
            o, m, l = (gather_blocks(t, px.mesh, seq, 2) for t in parts)
            ctx_c = ref.combine_partials(o, m, l).to(ckv.dtype)  # (B,1,H,r)
            return (torch.einsum("bshl,lhv->bshv", ctx_c, wv),)

        # act_cache_seq splits the latent cache: the cache's names first,
        # so that its slots keep the mesh dims place_cache gave them, and
        # each rank holds every head
        from repro_torch.kernels import ref
        seq_rows = LATENT_CACHE_AXES[:2]
        heads = ("act_batch", None, "act_heads")
        (out,) = block_local(
            px, merged, (cache["c_kv"], cache["k_rope"], cache["pos"],
                         q_nope, q_rope, positions, p["wk_nope"], p["wv"]),
            (seq_rows, seq_rows, seq_rows, heads, heads, rows,
             (None, "act_heads"), (None, "act_heads")), (heads,))
        return tokens_local(px, _out_proj, out, p["wo"]), cache

    k_nope, v = tokens_local(px, lambda t, wk, wv: (
        torch.einsum("bsl,lhn->bshn", t, wk),
        torch.einsum("bsl,lhv->bshv", t, wv)), c_kv, p["wk_nope"], p["wv"],
        n_out=2)

    def core(qn, qr, kn, kr, vv, pos):
        k_rope_h = kr[:, :, None, :].expand(*kn.shape[:3], dr)
        return (_prefill_attention(
            torch.cat([qn, qr], dim=-1), torch.cat([kn, k_rope_h], dim=-1),
            vv, q_pos=pos, k_pos=pos, window=None, scale=scale, pcfg=pcfg,
            device=x.device),)

    heads = ("act_batch", None, "act_heads")
    (out,) = block_local(px, core, (q_nope, q_rope, k_nope, k_rope, v,
                                    positions),
                         (heads, heads, heads, ("act_batch",), heads,
                          ("act_batch",)), (heads,))
    y = tokens_local(px, _out_proj, out, p["wo"])
    new_cache = cache
    if mode == "prefill":
        if cache is None:
            raise ValueError("prefill fills a cache")
        pad = cache["c_kv"].shape[1] - S
        rows = ("act_batch",)
        new_cache = dict(zip(("c_kv", "k_rope", "pos"), block_local(
            px, lambda c, r, q: (F.pad(c, (0, 0, 0, pad)),
                                 F.pad(r, (0, 0, 0, pad)),
                                 F.pad(q, (0, pad), value=-1)),
            (c_kv, k_rope, positions), (rows,) * 3, (rows,) * 3)))
        new_cache = _cache_placed(new_cache, px)
    return y, new_cache


# ---------------------------------------------------------------------------
# recurrent state


def _new_state(cache: Cache, mode: str, **new) -> Cache:
    """A recurrent block's state after a call, in the cache's dtypes: in
    decode copied into the cache's own buffers (which a captured graph
    replays into), else a new dict; None without a cache."""
    if cache is None:
        return None
    if mode == "decode":
        for name, t in new.items():
            cache[name].copy_(t)
        return cache
    return {name: t.to(cache[name].dtype) for name, t in new.items()}


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)


def _block_diag(x, w, b):
    """x (...,L) with w (nb, bs, bs): block-diagonal linear."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    y = torch.einsum("...nb,nbc->...nc", xs, w)
    return y.reshape(x.shape) + b


def _causal_conv(x, w, b, state):
    """Depthwise causal conv, width cw. x (B,S,L), state (B,cw-1,L) or
    None. Returns (y, the last cw-1 inputs: the next call's state)."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, j:j + S] * w[j] for j in range(cw)) + b
    return y, xp[:, xp.shape[1] - (cw - 1):]


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_(t-1) + b_t along dim 1: (A, B) with
    h_t = A_t h_(-1) + B_t. The reference's ``lax.associative_scan`` of the
    combine ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 + b2), as a log-depth
    doubling scan (about 12 passes at S 3,072). The closed form
    exp(cumsum(log a)) is not used: its exp(-cumsum) overflows."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


#: a causal conv's parameters by their block axes: a rank's slice of the
#: channels (``act_mlp``)
_CONV_AXES = {"conv_w": (None, "act_mlp"), "conv_b": ("act_mlp",)}
#: the RG-LRU's per-channel parameters by their block axes: the conv's,
#: and the gates' diagonal blocks, which line up with the rank's channels
#: where the blocks divide over the same mesh axes (else the channels are
#: whole on every rank)
_RGLRU_AXES = {**_CONV_AXES,
               "gate_r_w": ("act_mlp",), "gate_r_b": ("act_mlp",),
               "gate_i_w": ("act_mlp",), "gate_i_b": ("act_mlp",),
               "a_param": ("act_mlp",)}
#: (rows, whole sequence, channels): a recurrence runs over the whole
#: sequence on each rank
_CHANNELS = ("act_batch", None, "act_mlp")


def _rglru_scan(p, xx, conv_state, h0, *, c_exponent: float, decode: bool):
    """The RG-LRU from the recurrence's input xx (B,S,L): the causal conv,
    the gates and the linear recurrence, elementwise over channels.
    ``h0`` None starts from zeros. Returns (hs (B,S,L) fp32, conv state,
    last h)."""
    xx, new_conv = _causal_conv(xx, p["conv_w"], p["conv_b"], conv_state)
    rg = torch.sigmoid(_block_diag(xx, p["gate_r_w"], p["gate_r_b"]).float())
    ig = torch.sigmoid(_block_diag(xx, p["gate_i_w"], p["gate_i_b"]).float())
    log_a = -c_exponent * F.softplus(p["a_param"]) * rg       # (B,S,L) fp32
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    gated = mult * ig * xx.float()
    if h0 is None:
        h0 = torch.zeros((xx.shape[0], xx.shape[-1]), device=xx.device)
    if decode:
        new_h = a[:, 0] * h0 + gated[:, 0]
        return new_h[:, None, :], new_conv, new_h
    A, Bc = _linear_scan(a, gated)
    hs = A * h0[:, None, :] + Bc
    return hs, new_conv, hs[:, -1]


def rglru_block(p, x, *, cfg: ArchConfig, pcfg: ParallelConfig, mode: str,
                cache: Cache, px: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """The RG-LRU block. On a mesh ``xx`` takes the reference's
    constraint and the recurrence runs on each rank's rows and channels
    (``block_local``), exact with no communication, from and into its
    block of the cache's state where there is one."""
    gate_y, xx = tokens_local(px, lambda t, wy, wx: (
        _act("geglu")(t @ wy), t @ wx), x, p["wy"], p["wx"], n_out=2)
    xx = constrain(xx, ("act_batch", "act_seq", "act_mlp"), px)
    kw = dict(c_exponent=cfg.rglru.c_exponent, decode=mode == "decode")
    if cache is None:
        (hs,) = block_local(
            px, lambda q, t: _rglru_scan(q, t, None, None, **kw)[:1],
            ({k: p[k] for k in _RGLRU_AXES}, xx), (_RGLRU_AXES, _CHANNELS),
            (_CHANNELS,))
        state = {}
    else:
        hs, conv, h = block_local(
            px, lambda q, t, c, h0: _rglru_scan(q, t, c, h0.float(), **kw),
            ({k: p[k] for k in _RGLRU_AXES}, xx, cache["conv"], cache["h"]),
            (_RGLRU_AXES, _CHANNELS, _CHANNELS, _CHANNELS[::2]),
            (_CHANNELS, _CHANNELS, _CHANNELS[::2]))
        state = dict(conv=conv, h=h)
    y = tokens_local(px, lambda t, w: t @ w, gate_y * hs.to(x.dtype),
                     p["wo"])
    return y, _new_state(cache, mode, **state)


# ---------------------------------------------------------------------------
# xLSTM blocks


def _mm32(eq: str, a, b):
    """A product with fp32 results from (possibly bf16) operands: the
    reference's ``preferred_element_type=float32``."""
    return torch.einsum(eq, a.float(), b.float())


def _mlstm_chunkwise(q, k, v, ig, fg, c0, n0, m0, chunk: int,
                     bf16_streams: bool = False):
    """Chunkwise-parallel stabilized mLSTM, the reference's exact
    reformulation of the per-step recurrence: the matrix state is updated
    once a chunk and the work inside a chunk is (C x C)(C x d) products.
    The reference's ``lax.scan`` over chunks is a Python loop.

    q,k (B,S,nh,dqk) [q pre-scaled], v (B,S,nh,dv), ig/fg (B,S,nh) raw
    gates; state c0 (B,nh,dqk,dv), n0 (B,nh,dqk), m0 (B,nh). With
    ``bf16_streams`` q/k/v and the (C, *) intermediates are bf16 (gates,
    normalizers and the carried state stay fp32)."""
    B, S, nh, dqk = q.shape
    dv = v.shape[-1]
    C = chunk
    nc = S // C
    sdt = torch.bfloat16 if bf16_streams else torch.float32

    def resh(a, d):
        return a.reshape(B, nc, C, nh, d).permute(1, 0, 3, 2, 4)

    qs, ks, vs = resh(q.to(sdt), dqk), resh(k.to(sdt), dqk), resh(v.to(sdt),
                                                                   dv)
    gi = ig.reshape(B, nc, C, nh).permute(1, 0, 3, 2)            # (nc,B,nh,C)
    logf = F.logsigmoid(fg).reshape(B, nc, C, nh).permute(1, 0, 3, 2)
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=q.device))
    c, n, m = c0, n0, m0
    hs = []
    for i in range(nc):
        q_c, k_c, v_c, ig_c, lf_c = qs[i], ks[i], vs[i], gi[i], logf[i]
        b = torch.cumsum(lf_c, dim=-1)           # inclusive log-decay
        btot = b[..., -1]
        w = ig_c - b                             # log source weight
        m_c = w.amax(dim=-1)
        e_src = torch.exp(w - m_c[..., None])
        decay = torch.exp(b)

        # inside the chunk: W[j,s] = decay_j e_src_s, causal
        Wm = (decay[..., :, None] * e_src[..., None, :] * causal).to(sdt)
        s_qk = _mm32("bhjd,bhsd->bhjs", q_c, k_c)
        wqk = (s_qk * Wm.float()).to(sdt)
        num_i = _mm32("bhjs,bhsv->bhjv", wqk, v_c)
        n_i = _mm32("bhjs,bhsd->bhjd", Wm, k_c)
        q32 = q_c.float()
        den_i = torch.einsum("bhjd,bhjd->bhj", q32, n_i)

        # the state before the chunk, combined position by position
        mu = torch.maximum(m[..., None] + b, m_c[..., None])
        sc_prev = torch.exp(m[..., None] + b - mu)
        sc_intra = torch.exp(m_c[..., None] - mu)
        num_p = torch.einsum("bhjd,bhdv->bhjv", q32, c)
        den_p = torch.einsum("bhjd,bhd->bhj", q32, n)
        num = sc_prev[..., None] * num_p + sc_intra[..., None] * num_i
        den = sc_prev * den_p + sc_intra * den_i
        hs.append(num / torch.maximum(den.abs(), torch.exp(-mu))[..., None])

        # the state after the chunk
        M = torch.maximum(m, m_c)
        e2 = torch.exp(w - M[..., None])
        kw_ = e2[..., None].to(sdt) * k_c
        c = (torch.exp(m - M)[..., None, None] * c
             + _mm32("bhsd,bhsv->bhdv", kw_, v_c))
        n = torch.exp(m - M)[..., None] * n + kw_.sum(dim=-2).float()
        m = btot + M
    h = torch.stack(hs, dim=0).permute(1, 0, 3, 2, 4).reshape(B, S, nh, dv)
    return h, (c, n, m)


def _mlstm_steps(q, k, v, ig, fg, c, n, m):
    """The per-step stabilized mLSTM recurrence (the reference's
    ``lax.scan``), one token at a time. Returns (h (B,S,nh,dv), state)."""
    hs = []
    S = q.shape[1]
    for t in range(_scan_len(q, S, "mlstm")):
        q_t, k_t, v_t = q[:, t].float(), k[:, t].float(), v[:, t].float()
        ig_t = ig[:, t]
        logf = F.logsigmoid(fg[:, t])                             # (B,nh)
        m_new = torch.maximum(logf + m, ig_t)
        i_p = torch.exp(ig_t - m_new)
        f_p = torch.exp(logf + m - m_new)
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        c = f_p[..., None, None] * c + i_p[..., None, None] * kv
        n = f_p[..., None] * n + i_p[..., None] * k_t
        num = torch.einsum("bhk,bhkv->bhv", q_t, c)
        den = torch.einsum("bhk,bhk->bh", q_t, n).abs()
        den = torch.maximum(den, torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return _stack_steps(hs, S), (c, n, m)


def _mlstm_scan(q, k, v, ig, fg, state, chunk: int, bf16_streams: bool):
    """The mLSTM recurrence of q, k (B,S,nh,dqk) [q pre-scaled], v
    (B,S,nh,dv) and the raw gates ig, fg (B,S,nh) from ``state`` (c, n, m)
    or, where it is None, zeros: chunkwise where ``chunk`` divides a longer
    sequence, else the per-step scan. Returns (h (B,S,nh,dv), state)."""
    B, S, nh, dqk = q.shape
    if state is None:
        state = (torch.zeros((B, nh, dqk, v.shape[-1]), device=q.device),
                 torch.zeros((B, nh, dqk), device=q.device),
                 torch.zeros((B, nh), device=q.device))
    if chunk and S % chunk == 0 and S > chunk:
        return _mlstm_chunkwise(q, k, v, ig, fg, *state, chunk,
                                bf16_streams=bf16_streams)
    return _mlstm_steps(q, k, v, ig, fg, *state)


#: a recurrence's (rows, whole sequence, heads) block
_HEADS = ("act_batch", None, "act_heads")
#: heads whole again, for a norm over every head
_HEADS_WHOLE = ("act_batch", "act_seq", None, None)


#: the mLSTM's head projections by their block axes: each rank's heads,
#: from every channel
_MLSTM_HEAD_AXES = {"wq": (None, "act_heads"), "wk": (None, "act_heads"),
                    "wv": (None, "act_heads"),
                    "w_igate": (None, "act_heads"), "b_igate": ("act_heads",),
                    "w_fgate": (None, "act_heads"), "b_fgate": ("act_heads",)}


def mlstm_block(p, x, *, cfg: ArchConfig, pcfg: ParallelConfig, mode: str,
                cache: Cache, px: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """The mLSTM block: chunkwise where ``pcfg.mlstm_chunk`` divides a
    longer sequence outside decode, else the per-step scan. On a mesh
    (train mode) the up-projection and the causal conv run on each rank's
    rows and channels, ``inner_in`` takes the reference's constraint, the
    head projections and the recurrence run on each rank's rows and heads
    from every channel (``block_local``: GSPMD's sums pending over
    ``model`` are each rank's whole contraction here; torch 2.11's DTensor
    cannot add the gates' biases to the pending sums), and the heads are
    whole again for the norm over the inner dim."""
    B, S, d = x.shape
    # the up-projection on each rank's rows and channels (DTensor in torch
    # 2.11 refuses the product's flattening of w_up's (2, inner) dims)
    gate_br, inner_in = block_local(
        px, lambda w, t: torch.einsum("bsd,dti->bsti", t, w).unbind(2),
        (p["w_up"], x), ((None, None, "act_mlp"), ("act_batch",)),
        (_CHANNELS, _CHANNELS))
    inner_in = constrain(inner_in, ("act_batch", "act_seq", "act_mlp"), px)
    conv = {k: p[k] for k in _CONV_AXES}
    if cache is None:
        (conv_out,) = block_local(
            px, lambda q, t: (F.silu(_causal_conv(t, q["conv_w"],
                                                  q["conv_b"], None)[0]),),
            (conv, inner_in), (_CONV_AXES, _CHANNELS), (_CHANNELS,))
    else:
        conv_out, new_conv = block_local(
            px, lambda q, t, c: _causal_conv(t, q["conv_w"], q["conv_b"], c),
            (conv, inner_in, cache["conv"]),
            (_CONV_AXES, _CHANNELS, _CHANNELS), (_CHANNELS, _CHANNELS))
        conv_out = F.silu(conv_out)

    chunk = 0 if mode == "decode" else pcfg.mlstm_chunk

    def heads(w, ci, ii, state):
        q = torch.einsum("bsi,ihk->bshk", ci, w["wq"])
        k = torch.einsum("bsi,ihk->bshk", ci, w["wk"])
        v = torch.einsum("bsi,ihk->bshk", ii, w["wv"])
        q = q / math.sqrt(q.shape[-1])
        c32 = ci.float()
        ig = torch.einsum("bsi,ih->bsh", c32, w["w_igate"]) + w["b_igate"]
        fg = torch.einsum("bsi,ih->bsh", c32, w["w_fgate"]) + w["b_fgate"]
        return _mlstm_scan(q, k, v, ig, fg, state, chunk,
                           pcfg.mlstm_bf16_streams)

    proj = {k: p[k] for k in _MLSTM_HEAD_AXES}
    if cache is None:
        (h,) = block_local(px, lambda w, ci, ii: heads(w, ci, ii, None)[:1],
                           (proj, conv_out, inner_in),
                           (_MLSTM_HEAD_AXES, ("act_batch",), ("act_batch",)),
                           (_HEADS,))
        state = {}
    else:
        cm = ("act_batch", "act_heads")
        h, c, n, m = block_local(
            px, lambda w, ci, ii, *st: (lambda o: (o[0],) + tuple(o[1]))(
                heads(w, ci, ii, tuple(t.float() for t in st))),
            (proj, conv_out, inner_in, cache["c"], cache["n"], cache["m"]),
            (_MLSTM_HEAD_AXES, ("act_batch",), ("act_batch",), cm, cm, cm),
            (_HEADS, cm, cm, cm))
        state = dict(c=c, n=n, m=m, conv=new_conv)
    h = constrain(h, _HEADS_WHOLE, px)
    h = rms_norm(h.reshape(B, S, -1), p["out_norm"]["scale"], cfg.norm_eps)
    # channels whole, and so its gradient: a channel split that the heads
    # do not divide (4 heads over model 8) cannot be viewed back as heads
    h = constrain(h, ("act_batch", "act_seq", None), px)
    h = h * F.silu(gate_br)
    y = tokens_local(px, lambda t, w: torch.einsum("bsi,id->bsd", t, w),
                     h.to(x.dtype), p["w_down"])
    return y, _new_state(cache, mode, **state)


def _slstm_scan(p, xg, state):
    """The sLSTM's per-step scan of xg (B,S,4,nh,dh) fp32 with the
    recurrent product of ``p["r"]`` a head, from ``state`` (c, n, h, m) or,
    where it is None, zeros with the normalizer at 1e-6 (the reference's).
    Returns (hs (B,S,nh,dh), state)."""
    B, S, _, nh, dh = xg.shape
    if state is None:
        z = torch.zeros((B, nh, dh), device=xg.device)
        state = (z, z + 1e-6, z, z)
    c, n, h, m = state
    r = p["r"].float()
    hs = []
    for t in range(_scan_len(xg, S, "slstm")):
        rec = torch.einsum("bhk,ghkl->bghl", h, r)
        pre = xg[:, t] + rec + p["b"]
        i_raw, f_raw, z_raw, o_raw = pre.unbind(dim=1)
        m_new = torch.maximum(f_raw + m, i_raw)
        i_g = torch.exp(i_raw - m_new)
        f_g = torch.exp(f_raw + m - m_new)
        c = f_g * c + i_g * torch.tanh(z_raw)
        n = f_g * n + i_g
        h = torch.sigmoid(o_raw) * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(h)
    return _stack_steps(hs, S), (c, n, h, m)


def slstm_block(p, x, *, cfg: ArchConfig, pcfg: ParallelConfig, mode: str,
                cache: Cache, px: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """The sLSTM block: a per-step scan with a recurrent (hidden-to-hidden)
    product a head. Without a cache the normalizer starts at 1e-6 (the
    reference's), in a cache at 1 (``model.init_cache``). On a mesh
    (train mode) the input projection and the scan run on each rank's rows
    and heads in plain tensors (``block_local``; the reference places no
    constraint here), and the heads are whole again for the norm over
    ``d``."""
    B, S, d = x.shape

    def scan(q, t, state):
        xg = torch.einsum("bsd,dghk->bsghk", t, q["wx"]).float()
        return _slstm_scan(q, xg, state)                # xg (B,S,4,nh,dh)

    rec = {k: p[k] for k in ("wx", "r", "b")}
    if cache is None:
        (hs,) = block_local(
            px, lambda q, t: scan(q, t, None)[:1], (rec, x),
            ({"wx": (None, None, "act_heads"), "r": (None, "act_heads"),
              "b": (None, "act_heads")}, ("act_batch",)), (_HEADS,))
        state = {}
    else:
        cm = ("act_batch", "act_heads")
        hs, c, n, h, m = block_local(
            px, lambda q, t, *st: (lambda o: (o[0],) + tuple(o[1]))(
                scan(q, t, tuple(u.float() for u in st))),
            (rec, x, cache["c"], cache["n"], cache["h"], cache["m"]),
            ({"wx": (None, None, "act_heads"), "r": (None, "act_heads"),
              "b": (None, "act_heads")}, ("act_batch",), cm, cm, cm, cm),
            (_HEADS, cm, cm, cm, cm))
        state = dict(c=c, n=n, h=h, m=m)
    hs = constrain(hs, _HEADS_WHOLE, px)
    y = rms_norm(hs.reshape(B, S, d), p["group_norm"]["scale"], cfg.norm_eps)
    return y.to(x.dtype), _new_state(cache, mode, **state)
