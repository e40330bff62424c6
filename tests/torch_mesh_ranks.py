"""What the ranks of the mesh tests run: each function here is one rank's
body in a CPU process group over gloo (``spawn``), imports torch and the
port only (no JAX, so that the spawned processes start fast), and leaves
its results in ``out`` (rank 0, ``torch.save``). Not a test module; the
tests are ``test_torch_mesh*.py`` and ``test_torch_compression.py``.
"""
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a spawned group may take before the test kills it
TIMEOUT = 300


def _main(rank, world, rdzv, job, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            world_size=world, rank=rank)
    try:
        job(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(job, world: int, tmp_path, *args) -> None:
    """Run ``job(rank, *args)`` in ``world`` spawned processes joined in one
    gloo group (rendezvous through a file under ``tmp_path``); raise if a
    rank fails or the group outlives ``TIMEOUT``."""
    ctx = mp.start_processes(_main, args=(world, str(tmp_path / "rdzv"), job,
                                          args),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job.__name__} on {world} ranks took "
                                   f"more than {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def tokens(vocab: int, rows: int, seq: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq)).astype(np.int32)


def batch_np(cfg, rows: int, seq: int, seed: int = 0) -> dict:
    """A seeded batch for ``cfg``'s frontend: token ids, or frame
    embeddings, labels (the last three of row 0 masked with -1) and the
    cross-attention condition."""
    if cfg.frontend != "embeddings":
        return {"tokens": tokens(cfg.vocab_size, rows, seq, seed)}
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    labels[0, -3:] = -1
    return {"frame_embeddings": rng.normal(
                size=(rows, seq, cfg.d_model)).astype(np.float32),
            "labels": labels,
            "cond": rng.normal(
                size=(rows, cfg.cross_seq, cfg.d_model)).astype(np.float32)}


def batch_torch(batch: dict) -> dict:
    """A numpy batch as the port's entry points take it (ids as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t if t.is_floating_point() else t.long()
    return out


def tag(name: str, pkw: dict) -> str:
    """A run's key: the config's name and its ParallelConfig overrides."""
    return " ".join([name] + [f"{k}={v}" for k, v in sorted(pkw.items())])


def _whole(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.models import params as P
    return {p: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
            .clone() for p, t in P.leaves(tree)}


# -- one train step, sharded and not ------------------------------------------


def sharded_vs_unsharded(rank, runs, data, model, out, adafactor=True):
    """For each run ``(name, pkw)``, the smoke config in fp32 (seed 0) with
    ``ParallelConfig`` overrides ``pkw``, on a (data, model) mesh: the loss
    and gradients of one batch (B 4 x S 32), and the weights after one
    AdamW step, sharded and unsharded, on the same weights and batch; with
    ``adafactor``, for the first run also the weights and state after one
    step of Adafactor with the reference's layer stacks. Keyed by
    :func:`tag`."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import loss_fn, make_train_step, place_batch
    from repro_torch.optim.optimizers import AdamW, constant_lr, make_optimizer
    from repro_torch.parallel.sharding import (ParallelConfig, ShardCtx,
                                               on_mesh)
    mesh = make_host_mesh(data=data, model=model, device="cpu")
    res = {}
    for i, (name, pkw) in enumerate(runs):
        pcfg = ParallelConfig(flash_threshold=1 << 30, logits_chunk=0,
                              **pcfg_kw(pkw))
        px = ShardCtx(mesh, pcfg)
        cfg = smoke_config(name).replace(dtype="float32")
        whole = batch_torch(batch_np(cfg, 4, 32))
        got = {}
        for side in ("unsharded", "sharded"):
            params = P.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            batch, ctx = whole, None
            if side == "sharded":
                params = P.shard_params(params, P.model_specs(cfg), mesh,
                                        pcfg)
                batch, ctx = place_batch(whole, px), px
            with on_mesh(ctx):
                views = P.trainable(params)
                loss, _ = loss_fn(views, batch, cfg=cfg, pcfg=pcfg, px=ctx)
                flat = list(P.leaves(views))
                grads = torch.autograd.grad(loss, [t for _, t in flat],
                                            materialize_grads=True)
            opt = AdamW(schedule=constant_lr(1e-3))
            state = opt.init(params)
            step = make_train_step(cfg, pcfg, opt, px=ctx)
            params, state, m = step(params, state, batch, 0)
            got[side] = {
                "loss": float(m["loss"]),
                "grads": _whole(P.map_tree_paths(
                    params, {p: g for (p, _), g in zip(flat, grads)})),
                "params": _whole(params), "moments": _whole(state["mu"])}
            if adafactor and i == 0:
                opt = make_optimizer("adafactor", constant_lr(1e-2), arch=cfg)
                state = opt.init(params)
                step = make_train_step(cfg, pcfg, opt, px=ctx)
                params, state, _ = step(params, state, batch, 1)
                got[side]["adafactor"] = {"params": _whole(params),
                                          "state": _whole(state["v"])}
        res[tag(name, pkw)] = got
    if rank == 0:
        torch.save(res, out)


# -- elastic restore -----------------------------------------------------------


def dense_job(rank, names, ckpt_dir, out):
    """:func:`sharded_vs_unsharded` of ``names`` on (data 2, model 2), then
    :func:`elastic_restore` of the first, in one group (DTensor plans each
    op's placements once a process: the two share the plans)."""
    sharded_vs_unsharded(rank, [(n, {}) for n in names], 2, 2,
                         out + ".steps")
    elastic_restore(rank, names[0], ckpt_dir, out + ".restore")


def elastic_restore(rank, name, ckpt_dir, out):
    """TrainLoop (the fp32 smoke config, B 4 x S 32) on (data 2, model 2)
    for two steps, saved; then restored onto (data 4, model 1) and, on
    rank 0, onto no mesh: whether every leaf of each restored state equals
    the saved one bit for bit, and the leaves' placements on each mesh."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.train import LoopConfig, TrainLoop
    from torch.distributed.tensor import DTensor
    from repro_torch.models import params as P
    cfg = smoke_config(name).replace(dtype="float32")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)

    def loop(mesh):
        lc = LoopConfig(steps=2, ckpt_every=2, ckpt_dir=ckpt_dir, log_every=0)
        return TrainLoop(cfg, dc, lc, device="cpu", mesh=mesh)

    first = loop(make_host_mesh(data=2, model=2, device="cpu"))
    losses = first.run().losses
    saved = _whole(first._state_tree())
    res = {"losses": losses, "placements": {}, "equal": {}}

    def held(tag, lp):
        state = lp._state_tree()
        res["placements"][tag] = sorted({
            str(tuple(t.placements)) for _, t in P.leaves(state)
            if isinstance(t, DTensor)})
        got = _whole(state)
        res["equal"][tag] = (lp.step, lp.metrics.restored_from is not None,
                             sorted(got) == sorted(saved) and all(
                                 got[p].dtype == saved[p].dtype
                                 and torch.equal(got[p], saved[p])
                                 for p in saved))

    held("data=4,model=1", loop(make_host_mesh(data=4, model=1,
                                               device="cpu")))
    if rank == 0:
        held("no mesh", loop(None))
        torch.save(res, out)
    dist.barrier()


# -- steps against the reference's sharded steps -------------------------------


def mesh_steps(rank, data, model, runs, out):
    """For each run ``(name, pkw, params_path, batch_path, steps)``:
    ``steps`` AdamW steps (constant LR 1e-3) of the fp32 smoke config with
    ``ParallelConfig`` overrides ``pkw`` on a (data, model) mesh, from the
    weights in ``params_path`` (the port's layout) on the numpy batch in
    ``batch_path`` (``.npz``): the losses and the weights after them,
    whole, keyed by :func:`tag`."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import make_train_step, place_batch
    from repro_torch.optim.optimizers import AdamW, constant_lr
    from repro_torch.parallel.sharding import ParallelConfig, ShardCtx
    mesh = make_host_mesh(data=data, model=model, device="cpu")
    res = {}
    for name, pkw, params_path, batch_path, steps in runs:
        cfg = smoke_config(name).replace(dtype="float32")
        px = ShardCtx(mesh, ParallelConfig(flash_threshold=1 << 30,
                                           logits_chunk=0, **pcfg_kw(pkw)))
        params = P.shard_params(torch.load(params_path), P.model_specs(cfg),
                                mesh, px.pcfg)
        batch = place_batch(batch_torch(dict(np.load(batch_path))), px)
        opt = AdamW(schedule=constant_lr(1e-3))
        state = opt.init(params)
        step = make_train_step(cfg, px.pcfg, opt, px=px)
        losses = []
        for i in range(steps):
            params, state, m = step(params, state, batch, i)
            losses.append(float(m["loss"]))
        res[tag(name, pkw)] = {"losses": losses, "params": _whole(params)}
    if rank == 0:
        torch.save(res, out)


# -- prefill and decode on a mesh -------------------------------------------------


def pcfg_kw(pkw: dict) -> dict:
    """A run's ``ParallelConfig`` overrides, its ``act_*`` keys folded
    into ``act_rules`` over the defaults (the reference's table takes
    them as the dry-run's ``--rules`` does)."""
    from repro_torch.parallel.sharding import DEFAULT_ACT_RULES
    act = {k: v for k, v in pkw.items() if k.startswith("act_")}
    kw = {k: v for k, v in pkw.items() if not k.startswith("act_")}
    return {**kw, "act_rules": {**DEFAULT_ACT_RULES, **act}} if act else kw


#: the decode kernel's calls in this process (:func:`serve_steps`)
_CALLS = {"fused": 0, "partials": 0, "flash": 0}


def serve_steps(rank, data, model, runs, out):
    """For each run ``(name, pkw, params_path, batch_path, prompt, cap)``:
    the fp32 smoke config's prefill of the first ``prompt`` tokens of the
    batch in ``batch_path`` into a cache of ``cap`` positions, then a
    decode step of each token after them, on a (data, model) mesh, or off
    any mesh where ``data`` is 0, with ``ParallelConfig`` overrides
    ``pkw`` (:func:`pcfg_kw`; a ``kernel`` entry a dict of
    ``KernelConfig`` fields): the logits of each step, whole, and the
    kernels' calls (``kernels.ops.decode_attention``, the fused decode
    call, ``kernels.flash_decode.decode_split``, the partials, and
    ``kernels.ops.flash_attention``), keyed by :func:`tag`."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import (make_decode_step,
                                           make_prefill_step, place_batch)
    from repro_torch.parallel.sharding import (KernelConfig, ParallelConfig,
                                               ShardCtx)
    from torch.distributed.tensor import DTensor
    calls = _CALLS

    def counted(fn, key):
        def call(*a, **kw):
            # the fused call's own split pass (on the CPU) is not counted
            calls[key] += sys._getframe(1).f_code.co_name != "flash_decode"
            return fn(*a, **kw)
        call.counted = True
        return call
    if not hasattr(kfd.decode_split, "counted"):
        kernel_ops.decode_attention = counted(kernel_ops.decode_attention,
                                              "fused")
        kfd.decode_split = counted(kfd.decode_split, "partials")
        kernel_ops.flash_attention = counted(kernel_ops.flash_attention,
                                             "flash")
    mesh = make_host_mesh(data=data, model=model, device="cpu") if data \
        else None
    res = {}
    for name, pkw, params_path, batch_path, prompt, cap in runs:
        kw = pcfg_kw(pkw)
        if "kernel" in kw:
            kw["kernel"] = KernelConfig(**kw["kernel"])
        pcfg = ParallelConfig(flash_threshold=1 << 30, **kw)
        px = ShardCtx(mesh, pcfg) if mesh is not None else None
        cfg = smoke_config(name).replace(dtype="float32")
        params = torch.load(params_path)
        if mesh is not None:
            params = P.shard_params(params, P.model_specs(cfg), mesh, pcfg)
        toks = batch_torch(dict(np.load(batch_path)))["tokens"]
        calls.update(fused=0, partials=0, flash=0)
        prefill = make_prefill_step(cfg, pcfg, cap, px=px)
        decode = make_decode_step(cfg, pcfg, px=px)
        logits, cache = prefill(params, place_batch(
            {"tokens": toks[:, :prompt]}, px))
        steps = [logits]
        for pos in range(prompt, toks.shape[1]):
            logits, cache = decode(params, cache, place_batch(
                {"tokens": toks[:, pos:pos + 1]}, px), pos)
            steps.append(logits)
        res[tag(name, pkw)] = {
            "logits": [(t.full_tensor() if isinstance(t, DTensor) else t)
                       .clone() for t in steps],
            "calls": dict(calls)}
    if rank == 0:
        torch.save(res, out)


def kernel_gate_job(rank, runs, out):
    """:func:`serve_steps` of ``runs`` on a one-rank mesh, into ``out +
    ".mesh"``, then off any mesh, into ``out + ".off"``."""
    serve_steps(rank, 1, 1, runs, out + ".mesh")
    serve_steps(rank, 0, 0, runs, out + ".off")


# -- sharding.block_local ------------------------------------------------------


def _blocks(px):
    """Two blocks through ``block_local`` and their inputs: a (rows,
    channels) block (a per-channel causal scan with a channel weight and a
    weight whole on every rank) and a (rows, heads) block (a per-head
    product with a weight by heads, one input shared by every head)."""
    from repro_torch.parallel.sharding import block_local
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 6, 8, generator=g)        # (rows, seq, channels)
    w = {"c": torch.randn(8, generator=g), "s": torch.randn(3, generator=g)}
    q = torch.randn(4, 5, 2, 3, generator=g)     # (rows, seq, heads, dim)
    r = torch.randn(2, 3, 3, generator=g)        # (heads, dim, dim)
    u = torch.randn(4, 5, 3, generator=g)        # (rows, seq, dim)

    def channels(p, t):
        y = torch.cumsum(t * p["c"], dim=1) * p["s"].sum()
        return (y, y.pow(2).sum(dim=1))

    def heads(p, t, shared):
        return (torch.einsum("bshk,hkl->bshl", t, p["r"]) + shared[:, :, None],)

    def run(put):
        ins = {"x": put(x, ("act_batch", None, "act_mlp")),
               "w": {"c": put(w["c"], (None,)), "s": put(w["s"], (None,))},
               "q": put(q, ("act_batch", None, "act_heads")),
               "r": put(r, (None,)), "u": put(u, ("act_batch",))}
        ch = block_local(px, channels, (ins["w"], ins["x"]),
                         ({"c": ("act_mlp",), "s": None},
                          ("act_batch", None, "act_mlp")),
                         (("act_batch", None, "act_mlp"),
                          ("act_batch", "act_mlp")))
        hd = block_local(px, heads, ({"r": ins["r"]}, ins["q"], ins["u"]),
                         ({"r": ("act_heads",)}, ("act_batch", None,
                                                  "act_heads"),
                          ("act_batch",)), (("act_batch", None, "act_heads"),))
        return ins, ch, hd
    return run


def block_checks(rank, data, model, out):
    """Both blocks of :func:`_blocks` on a (data, model) mesh, against the
    unsharded call, the activations arriving split by rows over ``data``
    and the weights replicated: each output whole and its placements, and
    each input's gradient whole and its placements, of a loss that weighs
    each output element differently."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.parallel.sharding import ParallelConfig, ShardCtx
    mesh = make_host_mesh(data=data, model=model, device="cpu")
    px = ShardCtx(mesh, ParallelConfig())

    def plain(t, _):
        return t.clone().requires_grad_(True)

    def placed(t, names):
        pl = [Replicate()] * mesh.ndim
        if names[0] == "act_batch":
            pl[mesh.mesh_dim_names.index("data")] = Shard(0)
        return distribute_tensor(t, mesh, pl,
                                 src_data_rank=None).requires_grad_(True)

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    res = {}
    for side, put, ctx in (("unsharded", plain, None),
                           ("sharded", placed, px)):
        ins, ch, hd = _blocks(ctx)(put)
        loss = 0
        for o in ch + hd:
            wt = torch.linspace(0.5, 1.5, o.numel()).reshape(o.shape)
            if isinstance(o, DTensor):
                wt = distribute_tensor(wt, mesh, o.placements,
                                       src_data_rank=None)
            loss = loss + (o * wt).sum()
        flat = list(P.leaves(ins))
        grads = torch.autograd.grad(loss, [t for _, t in flat])
        res[side] = {
            "outs": [whole(o) for o in ch + hd],
            "out_placements": [str(tuple(getattr(o, "placements", ())))
                               for o in ch + hd],
            "grads": {p: whole(g) for (p, _), g in zip(flat, grads)},
            "grad_placements": {p: str(tuple(getattr(g, "placements", ())))
                                for (p, _), g in zip(flat, grads)}}
    if rank == 0:
        torch.save(res, out)


def family_job(rank, data, model, runs, out, blocks_out=None, serve=(),
               serve_out=None):
    """:func:`mesh_steps`, then (with ``blocks_out``) :func:`block_checks`
    and (with ``serve``) :func:`serve_steps` on the same mesh, in one
    group."""
    mesh_steps(rank, data, model, runs, out)
    if blocks_out is not None:
        block_checks(rank, data, model, blocks_out)
    if serve:
        serve_steps(rank, data, model, serve, serve_out)


# -- compression over a mesh dim -------------------------------------------------


def compression_over_pod(rank, world, k_frac, out):
    """``compress_tree_psum`` over ``Reduction.group`` of the ``pod`` dim of
    a (pod,) mesh, each rank's gradient its row of one seeded (world, 64,
    32) array: rank 0's max |reduced - true mean| for each method."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.compression import (Reduction,
                                                  compress_tree_psum)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    red = Reduction.group(mesh.get_group("pod"))
    g = np.random.default_rng(0).normal(size=(world, 64, 32)).astype(
        np.float32)
    mean = torch.from_numpy(g.mean(axis=0))
    errs = {}
    for method in ("none", "int8", "topk"):
        mine = torch.from_numpy(g[rank])
        got, _ = compress_tree_psum({"w": mine}, {"w": torch.zeros_like(mine)},
                                    red, method, seed=0, k_frac=k_frac)
        errs[method] = float((got["w"] - mean).abs().max())
    if rank == 0:
        torch.save({"errs": errs, "world": red.world}, out)
