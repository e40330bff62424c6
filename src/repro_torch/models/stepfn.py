"""Train, prefill and decode step functions.

Port of ``repro/models/stepfn.py``: ``chunked_xent``, ``loss_fn``,
``make_train_step``, ``make_prefill_step`` and ``make_decode_step``, token
and ``embeddings`` frontends both. Eager PyTorch has no ``jit``: a step is
the plain function, and the kernel dispatch is read from ``pcfg.kernel`` at
every call (``models/layers.py``). Prefill and decode run under
``torch.inference_mode``; the train step runs with grad on (a tensor made
in inference mode cannot be saved for backward). The decode step takes its
position as a device tensor, as the reference's jitted step takes a traced
scalar, so a captured CUDA graph of it (``launch/serve.DecodeServer``)
reads the position each replay instead of the one it was captured at.

On a device mesh (``make_train_step(..., px=ShardCtx(mesh, pcfg))``) the
weights, their moments and the batch are DTensors (``TrainLoop(mesh=...)``
places them): the loss takes the reference's constraint on its logits,
each gradient is placed as its weight before the optimizer's update, and
the step runs under DTensor's implicit replication, so that a plain tensor
every rank builds alike (positions, masks) joins the DTensors as a
replicated value. Each batch leaf is placed by its logical axes
(:data:`BATCH_AXES`, the reference's ``input_specs``), a microbatch too;
under ``act_seq`` along its sequence, which the loss and the prefill's
last position gather where they slice it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.arch import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import leaves, map_tree_paths, trainable
from repro_torch.parallel.sharding import (ParallelConfig, ShardCtx,
                                           act_sharding, constrain,
                                           gather_blocks, on_mesh,
                                           shard_dims, tokens_local)

Tree = Dict[str, Any]

#: the logical activation axes of each batch leaf, as the reference's
#: ``launch/specs.batch_specs`` places them on a mesh
BATCH_AXES = {"tokens": ("act_batch", "act_seq"),
              "labels": ("act_batch", "act_seq"),
              "frame_embeddings": ("act_batch", "act_seq", "act_embed"),
              "cond": ("act_batch", None, "act_embed")}


def place_batch(batch: Tree, px: Optional[ShardCtx]) -> Tree:
    """Each leaf of a batch that every rank holds whole as a DTensor
    placed by :data:`BATCH_AXES`, each rank keeping its own block (no rank
    sends any); off a mesh, the batch."""
    if px is None or px.mesh is None:
        return batch
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v, *act_sharding(
        v.shape, BATCH_AXES[k], px.mesh, px.pcfg), src_data_rank=None)
        for k, v in batch.items()}


def _inputs(cfg: ArchConfig, batch: Tree):
    """(tokens, frame embeddings) of a batch: the ``embeddings`` frontend
    reads ``frame_embeddings`` (B,S,d), the others ``tokens`` (B,S)."""
    if cfg.frontend == "embeddings":
        return None, batch["frame_embeddings"]
    return batch["tokens"], None


# ---------------------------------------------------------------------------
# loss


def _chunk_loss(xc: torch.Tensor, head_w: torch.Tensor, lc: torch.Tensor,
                px: Optional[ShardCtx] = None):
    """(summed token loss, valid tokens) of one chunk, fp32: the logits are
    the head product with an fp32 result, as the reference's
    ``preferred_element_type=float32`` gives it (a bf16 model's logits are
    not rounded to bf16 before the loss), then log-sum-exp less the label's
    logit, labels -1 masked. The product takes fp32 operands: a bf16 value
    is exact in fp32, and ``torch.mm(..., out_dtype=torch.float32)``, the
    bf16-operand form, has no backward (its autograd formula is missing)
    and no CPU kernel. On a bf16 model this casts the head to fp32 once a
    chunk. On a mesh the logits take the reference's constraint (vocab
    over ``model``) and, where any mesh dim splits them, the label's logit
    is the sum over the vocabulary of the logits masked to the label's
    column, exact (one term is not zero): DTensor's gather along a sharded
    dim fails. Logits replicated on every rank (a mesh of one rank) take
    the gather, as off a mesh."""
    logits = tokens_local(px, lambda t, w: t.float() @ w.float(), xc,
                          head_w)
    logits = constrain(logits, ("act_batch", "act_seq", "act_vocab"), px)
    logz = torch.logsumexp(logits, dim=-1)
    label = torch.clamp(lc, min=0).long()[..., None]
    if px is None or px.mesh is None or not any(
            pl.is_shard() for pl in logits.placements):
        ll = torch.gather(logits, -1, label)[..., 0]
    else:
        vocab = torch.arange(logits.shape[-1], device=lc.device)
        ll = torch.where(vocab == label, logits, 0.0).sum(-1)
    mask = (lc >= 0).float()
    return torch.sum((logz - ll) * mask), torch.sum(mask)


def chunked_xent(x: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                 pcfg: ParallelConfig, px: Optional[ShardCtx] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy with the (B,S,V) logits never fully materialized.

    With ``pcfg.logits_chunk`` dividing a longer sequence, the sequence
    goes in chunks (the reference's ``lax.scan``), each under
    ``torch.utils.checkpoint``: a chunk's (B, chunk, V) logits live only
    inside its step, in the backward pass too. Returns (sum_loss, n_valid).
    labels == -1 are masked."""
    B, S, d = x.shape
    chunk = pcfg.logits_chunk
    if chunk and S > chunk and S % chunk == 0:
        # a chunk is a slice along the sequence, which DTensor is not
        # trusted to cut where ``act_seq`` splits it: whole first
        x = constrain(x, ("act_batch", None, "act_embed"), px)
        labels = constrain(labels, ("act_batch", None), px)
        tot = torch.zeros((), device=x.device)
        cnt = torch.zeros((), device=x.device)
        for i in range(0, S, chunk):
            s, c = checkpoint(_chunk_loss, x[:, i:i + chunk], head_w,
                              labels[:, i:i + chunk], px, use_reentrant=False)
            tot, cnt = tot + s, cnt + c
        return tot, cnt
    return _chunk_loss(x, head_w, labels, px)


def loss_fn(params: Tree, batch: Tree, *, cfg: ArchConfig,
            pcfg: ParallelConfig, px: Optional[ShardCtx] = None
            ) -> Tuple[torch.Tensor, Tree]:
    """(loss, {"xent", "aux", "n_tokens"}): the mean token cross-entropy
    plus the MoE aux loss. Token models predict each next token (the last
    position's label is -1, masked); the ``embeddings`` frontend reads
    ``frame_embeddings``, ``labels`` and, for cross-attention, ``cond``."""
    tokens, embeds = _inputs(cfg, batch)
    if tokens is None:
        labels = batch["labels"]
    else:
        # the next tokens, shifted along a sequence gathered whole where
        # ``act_seq`` splits it (DTensor is not trusted to slice it)
        whole = constrain(tokens, ("act_batch", None), px)
        labels = torch.cat([whole[:, 1:],
                            torch.full_like(whole[:, :1], -1)], dim=1)
    B, S = labels.shape
    positions = torch.arange(S, dtype=torch.long,
                             device=labels.device)[None, :].expand(B, S)
    x, _, aux = M.forward(params, cfg=cfg, pcfg=pcfg, mode="train",
                          tokens=tokens, embeds=embeds, cond=batch.get("cond"),
                          positions=positions, return_aux=True, px=px)
    params = M.head_params(params, cfg, px)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    head = (params["lm_head"]["w"] if "lm_head" in params
            else params["embed"]["table"].T)
    tot, cnt = chunked_xent(x, head, labels, pcfg, px)
    xent = tot / torch.clamp(cnt, min=1.0)
    return xent + aux, {"xent": xent, "aux": aux, "n_tokens": cnt}


# ---------------------------------------------------------------------------
# steps


def make_train_step(cfg: ArchConfig, pcfg: ParallelConfig, optimizer,
                    px: Optional[ShardCtx] = None):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics): the loss and its gradients, then the optimizer's
    update, which writes the new weights and state into ``params`` and
    ``opt_state`` (the reference donates them to its jitted step). With
    ``pcfg.microbatches`` mb > 1 the batch is split along its rows and the
    gradients are accumulated in fp32, each divided by mb (metrics then
    hold only the loss and the optimizer's, as the reference's do). Metrics
    are device tensors; ``step`` is passed through.

    ``px`` with a mesh: the step of DTensor weights and batch (the module
    docstring), ``pcfg`` being ``px.pcfg``.

    On a mesh microbatch i is the global rows [i B/mb, (i+1) B/mb), as the
    reference's reshape makes them: each batch leaf is gathered whole (a
    DTensor slice along a sharded dim is not trusted), cut, and placed
    anew by its logical axes (:func:`place_batch`; rows that do not divide
    over ``data`` are replicated, as ``resolve_spec`` drops the axis). The
    fp32 accumulators are placed as their weights, and the MoE's dispatch
    groups are reckoned from each microbatch's tokens.

    Raises for a ``pcfg.kernel`` that opts into the flash kernel: it has no
    backward (the reference's Pallas kernel has none either)."""
    kc = pcfg.kernel
    if kc is not None and kc.use_flash:
        raise ValueError("make_train_step: the flash kernel has no backward "
                         "(nor has the reference's Pallas kernel); train "
                         "with KernelConfig(use_flash=False)")
    mb = pcfg.microbatches

    def grads_of(params, batch):
        views = trainable(params)
        loss, met = loss_fn(views, batch, cfg=cfg, pcfg=pcfg, px=px)
        flat = [t for _, t in leaves(views)]
        # a leaf the loss does not reach (the sigmoid router's bias, which
        # only picks experts) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        if px is not None and px.mesh is not None:
            grads = [g.redistribute(w.device_mesh, w.placements)
                     for g, w in zip(grads, flat)]
        return loss.detach(), {k: v.detach() for k, v in met.items()}, grads

    @on_mesh(px)
    def train_step(params, opt_state, batch, step):
        if mb > 1:
            rows = next(iter(batch.values())).shape[0] // mb
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for _, p in leaves(params)]
            loss = torch.zeros((), device=grads[0].device)
            whole = {k: v.full_tensor() if isinstance(v, DTensor) else v
                     for k, v in batch.items()}
            for i in range(mb):
                part = place_batch({k: v[i * rows:(i + 1) * rows]
                                    for k, v in whole.items()}, px)
                l, _, g = grads_of(params, part)
                for a, b in zip(grads, g):      # in place: one accumulator
                    a.add_(b.float() / mb)
                loss = loss + l / mb
            met = {}
        else:
            loss, met, grads = grads_of(params, batch)
        grads = map_tree_paths(params, {path: g for (path, _), g in
                                        zip(leaves(params), grads)})
        params, opt_state, opt_met = optimizer.update(grads, opt_state, params)
        met = {"loss": loss, **met, **opt_met}
        if px is not None and px.mesh is not None:     # whole, on every rank
            met = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in met.items()}
        return params, opt_state, {**met, "step": step}

    return train_step


def make_prefill_step(cfg: ArchConfig, pcfg: ParallelConfig, cache_cap: int,
                      px: Optional[ShardCtx] = None):
    """prefill_step(params, batch) -> (last-token logits (B,V) fp32, cache).
    ``batch`` holds ``tokens``, or ``frame_embeddings`` and (for
    cross-attention) ``cond``. ``px`` with a mesh: DTensor weights and
    batch, the reference's constraints placed, the cache built on the
    mesh (``model.place_cache``)."""

    @torch.inference_mode()
    @on_mesh(px)
    def prefill_step(params: Tree, batch: Tree):
        tokens, embeds = _inputs(cfg, batch)
        lead = embeds if tokens is None else tokens
        B, S = lead.shape[:2]
        positions = torch.arange(S, dtype=torch.long,
                                 device=lead.device)[None, :].expand(B, S)
        cache = M.place_cache(M.init_cache(cfg, B, cache_cap,
                                           device=lead.device), cfg, px)
        x, new_cache = M.forward(params, cfg=cfg, pcfg=pcfg, mode="prefill",
                                 tokens=tokens, embeds=embeds,
                                 cond=batch.get("cond"), positions=positions,
                                 cache=cache, px=px)
        logits = M.output_head(params, cfg, _last_position(x, px), px)[:, 0]
        return logits, new_cache

    return prefill_step


def _last_position(x, px: Optional[ShardCtx] = None):
    """x[:, -1:] of hidden states (B,S,d). Where ``act_seq`` splits the
    sequence, each rank's last row is gathered over the mesh dims that
    split it and the last block's kept (one row a rank moves, not the
    sequence), placed whole along the sequence."""
    seq = () if px is None or px.mesh is None else shard_dims(
        x.placements, 1)
    if not seq:
        return x[:, -1:, :]
    from torch.distributed.tensor import Replicate
    pl = tuple(x.placements)
    last = gather_blocks(x.to_local()[:, -1:], px.mesh, seq, 1)[:, -1:]
    return DTensor.from_local(last, px.mesh, tuple(
        Replicate() if q.is_shard(1) else q for q in pl), run_check=False)


def make_decode_step(cfg: ArchConfig, pcfg: ParallelConfig,
                     px: Optional[ShardCtx] = None):
    """decode_step(params, cache, batch, pos) -> (logits (B,V), cache).

    ``batch`` holds ``tokens`` (B,1) or ``frame_embeddings`` (B,1,d);
    cross-attention reads its K/V from the cache. ``pos`` is the position
    of the incoming token, an int64 tensor of one element on the inputs'
    device (a Python int is copied there); the cache holds the positions
    before it and is updated in place. ``px`` with a mesh: DTensor
    weights, cache and batch, the reference's constraints placed."""

    @torch.inference_mode()
    @on_mesh(px)
    def decode_step(params: Tree, cache: List[Tree], batch: Tree, pos):
        tokens, embeds = _inputs(cfg, batch)
        lead = embeds if tokens is None else tokens
        B = lead.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.long, device=lead.device)
        positions = pos.reshape(1, 1).expand(B, 1)
        x, new_cache = M.forward(params, cfg=cfg, pcfg=pcfg, mode="decode",
                                 tokens=tokens, embeds=embeds,
                                 positions=positions, cache=cache, px=px)
        logits = M.output_head(params, cfg, x, px)[:, 0]
        return logits, new_cache

    return decode_step
