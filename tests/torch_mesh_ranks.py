"""What the ranks of the mesh tests run: each function here is one rank's
body in a CPU process group over gloo (``spawn``), imports torch and the
port only (no JAX, so that the spawned processes start fast), and leaves
its results in ``out`` (rank 0, ``torch.save``). Not a test module; the
tests are ``test_torch_mesh.py`` and ``test_torch_compression.py``.
"""
import os
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


def _whole(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.models import params as P
    return {p: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
            .clone() for p, t in P.leaves(tree)}


# -- one train step, sharded and not ------------------------------------------


def sharded_vs_unsharded(rank, names, data, model, out):
    """For each smoke config (fp32, seed 0) on a (data, model) mesh: the
    loss and gradients of one batch, and the weights after one AdamW step,
    sharded and unsharded, on the same weights and tokens; for the first,
    also the weights and state after one step of Adafactor with the
    reference's layer stacks."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import loss_fn, make_train_step
    from repro_torch.optim.optimizers import AdamW, constant_lr, make_optimizer
    from repro_torch.parallel.sharding import (ParallelConfig, ShardCtx,
                                               act_sharding, on_mesh)
    from torch.distributed.tensor import distribute_tensor
    mesh = make_host_mesh(data=data, model=model, device="cpu")
    pcfg = ParallelConfig(flash_threshold=1 << 30, logits_chunk=0)
    px = ShardCtx(mesh, pcfg)
    res = {}
    for name in names:
        cfg = smoke_config(name).replace(dtype="float32")
        tk = torch.from_numpy(tokens(cfg.vocab_size, 4, 32)).long()
        got = {}
        for side in ("unsharded", "sharded"):
            params = P.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
            batch, ctx = {"tokens": tk}, None
            if side == "sharded":
                params = P.shard_params(params, P.model_specs(cfg), mesh,
                                        pcfg)
                batch = {"tokens": distribute_tensor(
                    tk, *act_sharding(tk.shape, ("act_batch", "act_seq"),
                                      mesh, pcfg), src_data_rank=None)}
                ctx = px
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
            if name == names[0]:
                opt = make_optimizer("adafactor", constant_lr(1e-2), arch=cfg)
                state = opt.init(params)
                step = make_train_step(cfg, pcfg, opt, px=ctx)
                params, state, _ = step(params, state, batch, 1)
                got[side]["adafactor"] = {"params": _whole(params),
                                          "state": _whole(state["v"])}
        res[name] = got
    if rank == 0:
        torch.save(res, out)


# -- elastic restore -----------------------------------------------------------


def dense_job(rank, names, ckpt_dir, out):
    """:func:`sharded_vs_unsharded` of ``names`` on (data 2, model 2), then
    :func:`elastic_restore` of the first, in one group (DTensor plans each
    op's placements once a process: the two share the plans)."""
    sharded_vs_unsharded(rank, names, 2, 2, out + ".steps")
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


# -- qwen3-moe against the reference's sharded steps ---------------------------


def moe_steps(rank, name, data, model, params_path, tokens_path, steps, out):
    """``steps`` AdamW steps (constant LR 1e-3) of the fp32 smoke config on
    a (data, model) mesh from the weights in ``params_path`` (the port's
    layout) on the tokens in ``tokens_path``: the losses and the weights
    after them, whole."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models.stepfn import make_train_step
    from repro_torch.optim.optimizers import AdamW, constant_lr
    from repro_torch.parallel.sharding import (ParallelConfig, ShardCtx,
                                               act_sharding)
    from torch.distributed.tensor import distribute_tensor
    mesh = make_host_mesh(data=data, model=model, device="cpu")
    cfg = smoke_config(name).replace(dtype="float32")
    pcfg = ParallelConfig(flash_threshold=1 << 30, logits_chunk=0)
    params = P.shard_params(torch.load(params_path), P.model_specs(cfg),
                            mesh, pcfg)
    tk = torch.from_numpy(np.load(tokens_path)).long()
    batch = {"tokens": distribute_tensor(
        tk, *act_sharding(tk.shape, ("act_batch", "act_seq"), mesh, pcfg),
        src_data_rank=None)}
    opt = AdamW(schedule=constant_lr(1e-3))
    state = opt.init(params)
    step = make_train_step(cfg, pcfg, opt, px=ShardCtx(mesh, pcfg))
    losses = []
    for i in range(steps):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    whole = _whole(params)
    if rank == 0:
        torch.save({"losses": losses, "params": whole}, out)


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
