"""The port's training substrate against a live run of the JAX package, on
the CPU: the optimizers and schedules, the train step over three AdamW
steps, the checkpoint format both ways, the data pipeline's tokens, the
restartable loop (the port's counterparts of ``tests/test_substrate.py``'s
loop tests) and the launcher, and the refusals that keep a kernel without
a backward off the training path.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import torch

from repro.ckpt import checkpoint as jax_ckpt
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_source as jax_make_source
from repro.models.stepfn import make_train_step as jax_make_train_step
from repro.optim import optimizers as JO
from repro.parallel.sharding import ParallelConfig as JaxParallelConfig
from repro.parallel.sharding import ShardCtx

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import DataConfig, DataIterator, make_source
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import gemm as kgemm
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.stepfn import (loss_fn, make_prefill_step,
                                       make_train_step)
from repro_torch.optim import optimizers as O
from repro_torch.parallel.sharding import KernelConfig, ParallelConfig
from repro_torch.runtime.train import (LoopConfig, TrainLoop,
                                       run_with_restarts)
from repro_torch.store.resolve import apply_sharding_config

from test_torch_imports import _imported_modules, _port_files
from torch_train_parity import (TRAIN_PCFG, assert_updates_close, configs,
                                ref_tree, to_torch)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke-size models: torch's thread pool costs more than it saves, and
    under parallel test workers it takes the cores from each other, which
    makes the loop's step times swing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- optimizers -------------------------------------------------------------


def test_three_adamw_train_steps_match_the_reference():
    """The loop's optimizer (AdamW, warmup-cosine, decay 0.01) over three
    make_train_step steps on the same synthetic batches, from the
    reference's weights: each step's loss within 1e-5 relative, every
    metric of the reference, each leaf's weight update and both moments
    within 1e-3 of their norm (``assert_updates_close``), the count 3."""
    ref_cfg, cfg = configs("internlm2-1.8b")
    tree = ref_tree(ref_cfg)
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                                 global_batch=2, seed=3))
    jopt = JO.AdamW(schedule=JO.warmup_cosine(3e-3, 1, 3), weight_decay=0.01)
    jstep = jax.jit(jax_make_train_step(
        ref_cfg, ShardCtx(None, JaxParallelConfig(**TRAIN_PCFG)), jopt))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    opt = O.AdamW(schedule=O.warmup_cosine(3e-3, 1, 3), weight_decay=0.01)
    params = P.params_from_jax(tree, cfg)
    before = {p: t.numpy().copy() for p, t in P.leaves(params)}
    state = opt.init(params)
    step = make_train_step(cfg, ParallelConfig(**TRAIN_PCFG), opt)
    for i in range(3):
        batch = src.batch(i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, batch), i)
        params, state, m = step(params, state, to_torch(batch), i)
        assert set(m) == set(jm)
        for k in ("loss", "xent", "aux", "n_tokens", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                abs=1e-12), (i, k)
    assert_updates_close(before, dict(P.leaves(params)), dict(P.leaves(
        P.params_from_jax(jax.tree.map(np.asarray, jparams), cfg))))
    want = P.opt_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    assert want["count"].dtype == state["count"].dtype == torch.int32
    assert int(state["count"]) == int(want["count"]) == 3
    zeros = {p: np.zeros(t.shape) for p, t in P.leaves(params)}
    for part in ("mu", "nu"):
        assert_updates_close(zeros, dict(P.leaves(state[part])),
                             {p: t.numpy() for p, t in
                              P.leaves(want[part])})


def _random_tree(rng):
    """fp32 and bf16 leaves in dicts and a list, as numpy fp32 values."""
    return {"a": rng.normal(size=(8, 6)), "b": {"c": rng.normal(size=(5,)),
                                                "d": rng.normal(size=(3, 4, 6))},
            "l": [rng.normal(size=(7, 2)), rng.normal(size=(9,))]}


def _jax_tree(vals):
    out = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), vals)
    out["b"]["d"] = out["b"]["d"].astype(jnp.bfloat16)
    out["l"][1] = out["l"][1].astype(jnp.bfloat16)
    return out


def _torch_tree(vals):
    flat = {p: torch.tensor(v, dtype=torch.float32)
            for p, v in P.leaves(vals)}
    for p in (("b", "d"), ("l", 1)):
        flat[p] = flat[p].to(torch.bfloat16)
    return P.map_tree_paths(vals, flat)


def _assert_tree_close(got, want):
    """The same dtypes; fp32 leaves within 1e-6 of their largest entry; a
    bf16 leaf within one bf16 ulp of each entry (an fp32 result a rounding
    apart can round to the neighbouring bf16 value); integers equal."""
    want_flat = dict(P.leaves(jax.tree.map(np.asarray, want)))
    for path, g in P.leaves(got):
        w = np.asarray(want_flat[path])
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
        g32, w32 = g.float().numpy(), w.astype(np.float32)
        if w.dtype.name == "bfloat16":
            tol = 2.0 ** -7 * np.abs(w32)
        elif w.dtype.name == "float32":
            tol = 1e-6 * np.abs(w32).max()
        else:
            tol = 0.0
        assert np.all(np.abs(g32 - w32) <= tol), path


@pytest.mark.parametrize("name", ["adamw", "adamw-bf16-moments", "adafactor",
                                  "adamw-no-clip"])
def test_optimizers_match_the_reference_on_random_trees(name):
    """Four updates of a tree of fp32 and bf16 leaves (a dict, a nested
    dict and a list) with the same gradients in both packages: weights and
    every state leaf, dtypes included."""
    rng = np.random.default_rng(0)
    vals = _random_tree(rng)
    grads = [jax.tree.map(lambda v: 3 * v, _random_tree(rng))
             for _ in range(4)]
    sched = dict(peak_lr=1e-2, warmup=2, total=10)
    if name == "adafactor":
        jopt = JO.Adafactor(schedule=JO.warmup_cosine(**sched),
                            weight_decay=0.01)
        opt = O.Adafactor(schedule=O.warmup_cosine(**sched),
                          weight_decay=0.01)
    else:
        kw = dict(moment_dtype="bfloat16" if "bf16" in name else "float32",
                  clip_norm=None if "no-clip" in name else 1.0)
        jopt = JO.AdamW(schedule=JO.warmup_cosine(**sched), **kw)
        opt = O.AdamW(schedule=O.warmup_cosine(**sched), **kw)
    jp = _jax_tree(vals)
    js = jopt.init(jp)
    tp = _torch_tree(vals)
    ts = opt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(_jax_tree(g), js, jp)
        tp, ts, tm = opt.update(_torch_tree(g), ts, tp)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        if "grad_norm" in jm:
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-6)
    _assert_tree_close(tp, jp)
    _assert_tree_close(ts, js)
    assert int(ts["count"]) == 4 and ts["count"].dtype == torch.int32


@pytest.mark.parametrize("name", ["gemma-2b", "qwen3-moe-30b-a3b"])
def test_adafactor_on_the_reference_stacked_tree(name):
    """Three make_train_step steps with Adafactor on the smoke model, the
    reference's on its stacked tree (a segment's layers on one leading
    axis) and the port's with the reference's stacks
    (``params.layer_stacks``): each step's loss within 1e-5, each leaf's
    weight update within 1e-3 of its norm, and every state leaf, the
    reference's tree path for path (a stacked norm's scale factored into
    a row and a column state, the clip over the whole stack)."""
    ref_cfg, cfg = configs(name)
    tree = ref_tree(ref_cfg)
    src = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                                 global_batch=2, seed=3))
    jopt = JO.Adafactor(schedule=JO.warmup_cosine(3e-2, 1, 3),
                        weight_decay=0.01)
    jstep = jax.jit(jax_make_train_step(
        ref_cfg, ShardCtx(None, JaxParallelConfig(**TRAIN_PCFG)), jopt))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    opt = O.make_optimizer("adafactor", O.warmup_cosine(3e-2, 1, 3),
                           arch=cfg)
    opt = dataclasses.replace(opt, weight_decay=0.01)
    params = P.params_from_jax(tree, cfg)
    before = {p: t.numpy().copy() for p, t in P.leaves(params)}
    state = opt.init(params)
    step = make_train_step(cfg, ParallelConfig(**TRAIN_PCFG), opt)
    for i in range(3):
        batch = src.batch(i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, batch), i)
        params, state, m = step(params, state, to_torch(batch), i)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5), i
    assert_updates_close(before, dict(P.leaves(params)), dict(P.leaves(
        P.params_from_jax(jax.tree.map(np.asarray, jparams), cfg))))
    want = dict(P.leaves(jax.tree.map(np.asarray, jstate["v"])))
    got = dict(P.leaves(state["v"]))
    assert sorted(got) == sorted(want)
    assert {p: tuple(t.shape) for p, t in got.items()} == \
        {p: w.shape for p, w in want.items()}
    assert_updates_close({p: np.zeros(w.shape) for p, w in want.items()},
                         got, want)
    assert int(state["count"]) == 3


def test_schedules_and_clip_match_the_reference():
    ws, js = O.warmup_cosine(1e-3, 10, 100), JO.warmup_cosine(1e-3, 10, 100)
    got = np.array([float(ws(torch.tensor(i, dtype=torch.int32)))
                    for i in range(120)], np.float32)
    want = np.array([float(js(jnp.asarray(i, jnp.int32)))
                     for i in range(120)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] < got[9] and got[99] < got[50]
    assert float(O.constant_lr(0.5)(torch.tensor(3))) == 0.5
    rng = np.random.default_rng(2)
    vals = jax.tree.map(lambda v: 7 * v, _random_tree(rng))
    (tc, tn), (jc, jn) = (O.clip_by_global_norm(_torch_tree(vals), 1.0),
                          JO.clip_by_global_norm(_jax_tree(vals), 1.0))
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    _assert_tree_close(tc, jc)
    assert float(O.global_norm(tc)) == pytest.approx(1.0, rel=1e-2)


# -- checkpoints -------------------------------------------------------------


def _ckpt_tree():
    return {"a": torch.tensor([1, 2, 3], dtype=torch.int32),
            "b": {"w": torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16)},
            "c": torch.tensor(0.5),
            "l": [torch.arange(4.0).reshape(2, 2)]}


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = _ckpt_tree()
    path = ckpt.save(str(tmp_path), 12, tree, extras={"step": 12})
    got, extras = ckpt.restore(path, tree)
    assert extras["step"] == 12
    for (p, g), (_, w) in zip(P.leaves(got), P.leaves(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w), p
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(path, {"a": tree["a"]})


def test_checkpoint_latest_and_atomic(tmp_path):
    t = {"x": torch.zeros(3)}
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 5, t)
    os.makedirs(tmp_path / "step_00000009.tmp")   # simulated crash mid-write
    assert ckpt.latest(str(tmp_path)).endswith("step_00000005")
    assert ckpt.latest(str(tmp_path / "none")) is None


def test_async_checkpointer_keeps_three(tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    x = torch.zeros(2)
    for s in (1, 2, 3, 4, 5):
        x.fill_(s)                 # in place, as a train step updates
        ac.save(s, {"x": x})
    x.fill_(-1)                    # after the last snapshot
    ac.wait()
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004", "step_00000005"]
    got, _ = ckpt.restore(ac.last_path, {"x": x})
    assert got["x"].tolist() == [5.0, 5.0]


def _numpy_tree(tree):
    """A port tree as the reference writes it: numpy leaves, bf16 as
    ml_dtypes' bfloat16 (the same bits)."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return P.map_tree(one, tree)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A directory the port writes is found by the reference's ``latest``
    and read by its ``load_manifest`` and ``restore``; a directory the
    reference writes loads with the port's reader, leaves and dtype tags."""
    tree = _ckpt_tree()
    mine = str(tmp_path / "port")
    ckpt.save(mine, 3, tree, extras={"step": 3, "data": {"step": 3}})
    ckpt.save(mine, 7, tree, extras={"step": 7, "data": {"step": 7}})
    path = jax_ckpt.latest(mine)
    assert path == ckpt.latest(mine) and path.endswith("step_00000007")
    meta = jax_ckpt.load_manifest(path)
    assert meta == ckpt.load_manifest(path)
    assert meta["dtypes"] == ["int32", "bfloat16", "float32", "float32"]
    assert meta["n_leaves"] == 4 and meta["extras"]["data"] == {"step": 7}
    like = _numpy_tree(tree)
    got, extras = jax_ckpt.restore(path, like)
    for (_, g), (_, w) in zip(P.leaves(got), P.leaves(like)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))
    theirs = str(tmp_path / "reference")
    jax_ckpt.save(theirs, 4, like, extras={"step": 4})
    back, extras = ckpt.restore(ckpt.latest(theirs), tree)
    assert extras == {"step": 4}
    for (p, g), (_, w) in zip(P.leaves(back), P.leaves(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w), p


# -- data --------------------------------------------------------------------


def _dc(cls, **kw):
    return cls(**{**dict(vocab_size=97, seq_len=32, global_batch=8, seed=5),
                  **kw})


@pytest.mark.parametrize("host_slice", [(0, 1), (1, 2)])
def test_synthetic_tokens_equal_the_reference(host_slice):
    mine = make_source(_dc(DataConfig))
    theirs = jax_make_source(_dc(JaxDataConfig))
    for step in (0, 1, 7):
        np.testing.assert_array_equal(mine.batch(step, host_slice)["tokens"],
                                      theirs.batch(step,
                                                   host_slice)["tokens"])


def test_memmap_tokens_equal_the_reference(tmp_path):
    path = str(tmp_path / "corpus.bin")
    np.random.default_rng(4).integers(0, 97, 5000).astype(
        np.uint16).tofile(path)
    mine = make_source(_dc(DataConfig, kind="memmap", path=path))
    theirs = jax_make_source(_dc(JaxDataConfig, kind="memmap", path=path))
    assert mine.n_tokens == 5000
    for step in (0, 3):
        for hs in ((0, 1), (1, 4)):
            np.testing.assert_array_equal(mine.batch(step, hs)["tokens"],
                                          theirs.batch(step, hs)["tokens"])


def test_data_iterator_restore():
    it = DataIterator(make_source(_dc(DataConfig)))
    next(it)
    next(it)
    st = it.state()
    a = next(it)["tokens"]
    it2 = DataIterator(make_source(_dc(DataConfig)))
    it2.restore(st)
    np.testing.assert_array_equal(next(it2)["tokens"], a)


# -- the loop -----------------------------------------------------------------


def _loop(tmp_path, attempt, fail_at=None, steps=14, **pkw):
    cfg = smoke_config("internlm2-1.8b")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    lc = LoopConfig(steps=steps, ckpt_every=5, ckpt_dir=str(tmp_path),
                    log_every=0, fail_at_step=fail_at if attempt == 0 else None)
    pcfg = ParallelConfig(**{**TRAIN_PCFG, **pkw}) if pkw else None
    return TrainLoop(cfg, dc, lc, pcfg=pcfg, device="cpu")


def test_train_restart_resumes_from_checkpoint(tmp_path):
    metrics = run_with_restarts(
        lambda attempt: _loop(tmp_path, attempt, fail_at=8), max_restarts=2)
    # second attempt restored from step 5 and ran 14-5=9 steps
    assert metrics.restored_from is not None
    assert metrics.start_step == 5
    assert metrics.start_step + len(metrics.losses) == 14
    meta = ckpt.load_manifest(ckpt.latest(str(tmp_path)))
    assert meta["step"] == 14 and meta["extras"]["data"] == {"step": 14}


def test_a_restored_loop_continues_as_an_unbroken_one(tmp_path):
    """Restart is exact: after a failure at step 7 the loop resumes from
    step 5 and gives the losses of a run that never stopped (the same
    weights, moments, count and data cursor)."""
    whole = _loop(tmp_path / "whole", 0, steps=9).run()
    tail = run_with_restarts(lambda a: _loop(tmp_path / "cut", a, fail_at=7,
                                             steps=9), max_restarts=1)
    assert tail.start_step == 5 and tail.losses == whole.losses[5:]


def test_train_loss_decreases(tmp_path):
    loop = _loop(tmp_path / "fresh", 0, steps=30)
    metrics = loop.run()
    assert np.mean(metrics.losses[-5:]) < np.mean(metrics.losses[:5])


def test_straggler_detection(tmp_path):
    """Step 8 is made a straggler: it sleeps 0.75 s, or four times the
    slowest step so far where the machine is slower than that (the EWMA
    never exceeds the slowest step, so the step is past 3x EWMA)."""
    loop = _loop(tmp_path / "s", 0, steps=12)
    orig = loop._step_fn
    calls = {"n": 0}

    def slow_step(*a, **k):
        calls["n"] += 1
        if calls["n"] == 9:
            import time
            time.sleep(max(0.75, 4 * max(loop.metrics.step_times)))
        return orig(*a, **k)

    loop._step_fn = slow_step
    metrics = loop.run()
    assert 8 in metrics.straggler_events


def test_the_loop_honours_the_moment_dtype(tmp_path):
    """As the reference's loop: AdamW's moments are fp32 whatever
    ``opt_moment_dtype`` says (``make_optimizer`` takes the field)."""
    loop = _loop(tmp_path / "m", 0, steps=2, opt_moment_dtype="bfloat16")
    for part in ("mu", "nu"):
        assert all(t.dtype == torch.float32
                   for _, t in P.leaves(loop.opt_state[part]))
    assert len(loop.run().losses) == 2
    opt = O.make_optimizer("adamw", O.constant_lr(1e-3), "bfloat16")
    assert opt.moment_dtype == "bfloat16"


def test_the_loop_runs_on_the_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("internlm2-1.8b")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop(cfg, dc, LoopConfig(steps=1))


def test_launcher_trains_restarts_and_refuses_embeddings(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` with a
    checkpoint directory and an injected failure: it restarts from step 5
    and ends at --steps; a config with frame embeddings is refused."""
    d = str(tmp_path / "ck")
    metrics = train_cli.main(["--arch", "gemma-2b", "--smoke", "--device",
                              "cpu", "--steps", "12", "--ckpt-dir", d,
                              "--ckpt-every", "5", "--fail-at-step", "8",
                              "--seq-len", "32", "--global-batch", "2"])
    assert metrics.start_step == 5 and len(metrics.losses) == 7
    out = capsys.readouterr().out
    assert "injected failure at step 8" in out and "restored_from=" in out
    assert ckpt.load_manifest(ckpt.latest(d))["step"] == 12
    with pytest.raises(SystemExit, match="embeddings"):
        train_cli.main(["--arch", "musicgen-large", "--smoke", "--device",
                        "cpu"])


# -- what keeps a kernel without a backward off the training path ------------


def test_train_step_refuses_the_flash_kernel():
    cfg = smoke_config("gemma-2b")
    pcfg = ParallelConfig(kernel=KernelConfig(use_flash=True))
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, pcfg, O.AdamW(schedule=O.constant_lr(1e-3)))
    # the decode kernel is not on the training path: allowed
    make_train_step(cfg, ParallelConfig(kernel=KernelConfig(use_decode=True)),
                    O.AdamW(schedule=O.constant_lr(1e-3)))


def test_the_flash_gate_refuses_a_gradient_on_both_devices():
    """With the kernel opted in and blocks that tile the sequence, a loss
    that needs gradients raises on the CPU too (the reference's Pallas
    kernel has no backward, so its train step fails); without gradients
    the same call runs; a closed gate (a window) never raises."""
    cfg = smoke_config("gemma-2b").replace(dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pcfg = ParallelConfig(**TRAIN_PCFG, kernel=KernelConfig(
        use_flash=True, flash_block_q=8, flash_block_kv=8))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}
    with pytest.raises(ValueError, match="no backward"):
        loss_fn(P.trainable(params), batch, cfg=cfg, pcfg=pcfg)
    with torch.no_grad():
        loss_fn(P.trainable(params), batch, cfg=cfg, pcfg=pcfg)
    loss_fn(params, batch, cfg=cfg, pcfg=pcfg)    # nothing requires grad
    kc = pcfg.kernel
    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="no backward"):
            L._flash_kernel_ok(16, 16, 16, None, kc, dev, grad=True)
        assert not L._flash_kernel_ok(16, 16, 16, 8, kc, dev, grad=True)


def test_kernel_plain_versions_stay_differentiable_on_the_cpu():
    """A CPU tensor takes the plain version, which autograd sees through
    (the card's launches refuse a gradient: tests/test_torch_cuda.py)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 16, generator=g, requires_grad=True)
               for _ in range(3))
    kfa.launches = kgemm.launches = 0
    kfa.flash_attention(q, k, v, block_q=64, block_kv=64).sum().backward()
    a = torch.randn(64, 64, generator=g, requires_grad=True)
    kgemm.gemm(a, a.detach(), block_m=64, block_n=64,
               block_k=64).sum().backward()
    assert all(t.grad is not None for t in (q, k, v, a))
    assert kfa.launches == kgemm.launches == 0


# -- serving carries the training fields and reads none ----------------------


def test_serving_ignores_the_training_fields():
    cfg = smoke_config("gemma-2b").replace(dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}
    train = dict(remat="full", microbatches=2, logits_chunk=8,
                 opt_moment_dtype="bfloat16")
    base, _ = make_prefill_step(cfg, ParallelConfig(), 20)(params, batch)
    got, _ = make_prefill_step(cfg, ParallelConfig(**train), 20)(params,
                                                                 batch)
    assert torch.equal(got, base)
    srv = serve.DecodeServer(cfg, ParallelConfig(), batch=2, prompt_len=16,
                             decode_steps=4, device="cpu", params=params)
    key = srv._stepfn_key()
    logged = []
    srv.pcfg = apply_sharding_config(srv.pcfg, train, log=logged.append)
    assert srv.pcfg.remat == "full" and srv.pcfg.microbatches == 2
    assert srv._stepfn_key() == key and logged == []


# -- imports ------------------------------------------------------------------


def test_the_port_imports_no_ml_dtypes():
    """The card's host has no ml_dtypes: the checkpoint format carries bf16
    as its bits without it."""
    files = _port_files()
    assert any(p.endswith(os.path.join("ckpt", "checkpoint.py"))
               for p in files)
    bad = {os.path.relpath(p): m for p in files
           for m in _imported_modules(p) if m.split(".")[0] == "ml_dtypes"}
    assert not bad
