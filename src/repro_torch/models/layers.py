"""Forward functions of the dense and MoE attention decoder layers.

Port of ``repro/models/layers.py``, cut to the GQA/MQA/MHA path and the
mixture of experts: ``rms_norm``, ``mlp``, RoPE, the plain attention cores
``_direct_attention`` and ``_decode_attention``, ``gqa_attention`` with its
kernel dispatch gates, the KV-cache helpers, and ``moe_block``. MLA,
RG-LRU, mLSTM, sLSTM, cross-attention and the ``lax.scan`` blockwise
``_flash_attention`` wait for later slices: a prefill the flash kernel does
not take runs ``_direct_attention`` at any length.

Functions take ``(params, x, *, cfg, pcfg, mode, cache, positions)`` and
return ``(y, new_cache)``; ``pcfg`` is the port's ``ParallelConfig`` (the
reference threads it inside a ``ShardCtx`` with a mesh the port has not).
The cache is updated in place in decode (the reference's ``.at[].set``
returns a copy): one slot per step is written, the rest is not moved.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.arch import ArchConfig
from repro_torch.parallel.sharding import ParallelConfig

Cache = Optional[Dict[str, torch.Tensor]]

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


def mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = _act(cfg.mlp_act)(x @ p["wg"]) * (x @ p["wu"])
    return h @ p["wd"]


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
    """Materialized-scores attention. q (B,Sq,H,hd), k/v (B,Sk,KV,hd); GQA
    by head grouping."""
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
                     device) -> bool:
    """Static preconditions for the flash kernel (the reference's
    ``_pallas_flash_ok``): opted in via KernelConfig, plain causal attention,
    equal q/k/v head dims, and a sequence both blocks tile. Opted in but
    refused: see ``_refuse_on_card``."""
    if kc is None or not kc.use_flash:
        return False
    bq, bkv = kc.flash_block_q, kc.flash_block_kv
    if window is not None:
        return _refuse_on_card(device, f"flash kernel takes no window "
                                       f"({window})")
    if hd != hd_v:
        return _refuse_on_card(device, f"flash kernel takes equal q/k and "
                                       f"v head dims, not {hd} and {hd_v}")
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
                  cache: Cache, positions, window=None
                  ) -> Tuple[torch.Tensor, Cache]:
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kc = pcfg.kernel

    new_cache = cache
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        slot = _cache_slot(positions[:, 0], cache["k"].shape[1], window)
        _insert_slot(cache["k"], k, slot)
        _insert_slot(cache["v"], v, slot)
        _insert_slot(cache["pos"], positions, slot)
        if _decode_kernel_ok(hd, v.shape[-1], kc, x.device):
            out = _kernel_decode_attention(
                q, cache["k"], cache["v"], cache_pos=cache["pos"],
                cur_pos=positions[:, 0], window=window, kc=kc)
        else:
            out = _decode_attention(q, cache["k"], cache["v"],
                                    cache_pos=cache["pos"],
                                    cur_pos=positions[:, 0], window=window,
                                    scale=scale)
    else:
        if _flash_kernel_ok(S, hd, v.shape[-1], window, kc, x.device):
            out = _kernel_flash_attention(q, k, v, kc)
        else:
            out = _direct_attention(q, k, v, q_pos=positions,
                                    k_pos=positions, window=window,
                                    scale=scale)
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill fills a cache")
            new_cache = _prefill_cache(k, v, positions, cache["k"].shape[1],
                                       window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


def _cache_slot(pos, capacity, window):
    """Rolling slot for windowed caches; direct slot otherwise."""
    return torch.remainder(pos, capacity) if window is not None else pos


def _insert_slot(buf, val, slot):
    """Write val (B,1,...) at per-batch slot (B,) along axis 1, in place."""
    buf[torch.arange(buf.shape[0], device=buf.device), slot] = val[:, 0]


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
    """The router and the dispatch plan of T tokens xg (T, d), as the
    reference computes them: fp32 scores (T, E) (softmax, or sigmoid with
    ``router_bias`` added for the choice only), the top_k experts of each
    token (T, K) by a stable descending sort, so that ties go to the lower
    expert index as ``lax.top_k`` breaks them, the gate weights renormalized
    over the chosen k, and each (token, k) copy's slot in its expert from a
    cumsum of one-hot rows over the copies in token-major order: slot C (the
    drop slot) where the expert is full. Returns (top_idx, weights, slot
    (T*K,), keep (T*K,), scores, one-hot (E, T*K) bool)."""
    mo = cfg.moe
    E, K = mo.num_experts, mo.top_k
    logits = xg.float() @ p["router"].float()                  # (T, E)
    if mo.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"].float()[None, :]
    else:
        scores = torch.softmax(logits, dim=-1)
        sel = scores
    top_idx = torch.sort(sel, dim=-1, descending=True,
                         stable=True).indices[:, :K]            # (T, K)
    gate = torch.gather(scores, 1, top_idx)
    weights = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    # one-hot rows expert-major, (E, T*K), so that the cumsum runs along
    # the contiguous dim (a scan down the copies' dim of a (T*K, E) table
    # takes most of a prefill on the card)
    flat_e = top_idx.reshape(-1)
    oh = torch.arange(E, device=xg.device)[:, None] == flat_e[None, :]
    pos = torch.gather(torch.cumsum(oh, dim=1, dtype=torch.int32), 0,
                       flat_e[None, :])[0].long() - 1
    keep = pos < C
    slot = torch.where(keep, pos, torch.full_like(pos, C))
    return top_idx, weights, slot, keep, scores, oh


def moe_block(p, x: torch.Tensor, *, cfg: ArchConfig, pcfg: ParallelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,d), aux loss (fp32 scalar)). The reference's
    ``moe_block`` whole, cut to one dispatch group: one card has no data
    axis, so the reference's G = data x pod groups is 1 and every token of
    the batch competes for the same C slots of each expert
    (:func:`moe_capacity`).

    The router and the plan are :func:`moe_route`. The dispatch is one
    scatter of token ids into an (E, C + 1) table and one gather of the
    activations: a dropped copy's id goes to column C, which is sliced
    away before the gather, so which duplicate lands there (the scatter's
    order is not fixed on the card) never reaches the output; the sentinel
    id T reads a row of zeros for an unfilled slot. The experts are batched
    products over (E, C, d), and the combine gathers each copy's row back
    (the drop slot reads zeros), weighted by its gate. Every shape is
    static and nothing is read back to the host, so a decode step that
    holds this block is captured as a CUDA graph."""
    mo = cfg.moe
    B, S, d = x.shape
    E, K = mo.num_experts, mo.top_k
    T = B * S
    C = moe_capacity(T, cfg, pcfg)
    xg = x.reshape(T, d)
    top_idx, weights, slot, keep, scores, oh = moe_route(p, xg, cfg=cfg, C=C)
    pos_k, keep_k = slot.reshape(T, K), keep.reshape(T, K)

    idx_buf = torch.full((E, C + 1), T, dtype=torch.long, device=x.device)
    idx_buf[top_idx.reshape(-1), slot] = torch.arange(
        T, device=x.device).repeat_interleave(K)
    x_pad = torch.cat([xg, xg.new_zeros((1, d))], dim=0)
    buf = x_pad[idx_buf[:, :C].reshape(E * C)].reshape(E, C, d)

    h = _act(cfg.mlp_act)(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    out_buf = torch.bmm(h, p["wd"])                             # (E, C, d)
    out_buf = F.pad(out_buf, (0, 0, 0, 1))                      # drop slot -> 0

    y = torch.zeros_like(xg)
    for j in range(K):
        gathered = out_buf[top_idx[:, j], pos_k[:, j]]          # (T, d)
        w = (weights[:, j] * keep_k[:, j]).to(x.dtype)
        y = y + gathered * w[:, None]

    if mo.num_shared_experts > 0:
        y = y + mlp(p["shared"], xg, cfg)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    me = oh.float().mean(dim=1)
    ce = scores.mean(dim=0)
    aux = torch.sum(me * ce) * E * mo.router_aux_weight
    return y.reshape(B, S, d), aux
