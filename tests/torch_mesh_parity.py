"""The port's sharded train steps against the reference's own sharded steps
on the CPU: the reference runs in one subprocess on forced host devices
(``make_host_mesh(data, model)``), the port on as many gloo ranks
(``torch_mesh_ranks.spawn``), both started together, from the reference's
weights (``params_from_jax``) on the same seeded numpy batch, the smoke
configs in fp32, ``ParallelConfig(flash_threshold=1 << 30,
logits_chunk=0)`` with each run's overrides, AdamW at a constant 1e-3.
Shared by ``test_torch_mesh*.py``; not a test module.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np

import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import params as jax_params

from repro_torch.configs.registry import smoke_config
from repro_torch.models import params as P

import torch_mesh_ranks as R
from torch_train_parity import LOSS_RTOL

#: ``torch_train_parity.assert_updates_close``'s rule: a leaf's update
#: within this fraction of the norm of the reference's
UPDATE_RTOL = 1e-3

ROOT = os.path.join(os.path.dirname(__file__), "..")

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    spec = json.load(open(sys.argv[1]))
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                               f"{spec['data'] * spec['model']}")
    sys.path.insert(0, "src")
    import jax, numpy as np
    from repro.configs.registry import smoke_config
    from repro.launch.mesh import make_host_mesh
    from repro.models.params import init_params, model_specs
    from repro.models.stepfn import make_train_step
    from repro.optim.optimizers import AdamW, constant_lr
    from repro.parallel.sharding import (ParallelConfig, ShardCtx,
                                         act_sharding, param_shardings)
    mesh = make_host_mesh(data=spec["data"], model=spec["model"])


    def train(run):
        pcfg = ParallelConfig(flash_threshold=1 << 30, logits_chunk=0,
                              **run["pkw"])
        cfg = smoke_config(run["name"]).replace(dtype="float32")
        params = init_params(cfg, jax.random.PRNGKey(0))
        params = jax.tree.map(jax.device_put, params,
                              param_shardings(model_specs(cfg), mesh, pcfg))
        opt = AdamW(schedule=constant_lr(1e-3))
        state = opt.init(params)
        inputs = np.load(run["batch"])
        batch = {k: jax.device_put(inputs[k], act_sharding(
            inputs[k].shape, spec["axes"][k], mesh, pcfg))
            for k in inputs.files}
        step = jax.jit(make_train_step(cfg, ShardCtx(mesh, pcfg), opt))
        losses = []
        for i in range(run["steps"]):
            params, state, m = step(params, state, batch, i)
            losses.append(float(m["loss"]))
        leaves = {f"p{i}": np.asarray(x)
                  for i, x in enumerate(jax.tree.leaves(params))}
        if run["spread"]:       # the same steps off the mesh
            params = init_params(cfg, jax.random.PRNGKey(0))
            state = opt.init(params)
            step = jax.jit(make_train_step(cfg, ShardCtx(None, pcfg), opt))
            for i in range(run["steps"]):
                params, state, _ = step(params, state, dict(inputs), i)
            leaves.update({f"u{i}": np.asarray(x) for i, x in
                           enumerate(jax.tree.leaves(params))})
        np.savez(run["out"], losses=np.asarray(losses),
                 n_dev=jax.device_count(), **leaves)
    from repro.launch.specs import abstract_cache_sharded
    from repro.models.stepfn import make_decode_step, make_prefill_step


    def serve(run):
        pcfg = ParallelConfig(flash_threshold=1 << 30, **run["pkw"])
        px = ShardCtx(mesh, pcfg)
        cfg = smoke_config(run["name"]).replace(dtype="float32")
        params = init_params(cfg, jax.random.PRNGKey(0))
        params = jax.tree.map(jax.device_put, params,
                              param_shardings(model_specs(cfg), mesh, pcfg))
        toks = np.load(run["batch"])["tokens"]
        prompt, cap = run["prompt"], run["cap"]

        def put(t):
            return jax.device_put(t, act_sharding(
                t.shape, spec["axes"]["tokens"], mesh, pcfg))
        prefill = jax.jit(make_prefill_step(cfg, px, cap))
        decode = jax.jit(make_decode_step(cfg, px))
        logits, cache = prefill(params, {"tokens": put(toks[:, :prompt])})
        # the cache placed by its axes under act_rules, as decode reads it
        cache = jax.tree.map(lambda c, a: jax.device_put(c, a.sharding),
                             cache, abstract_cache_sharded(
                                 cfg, toks.shape[0], cap, mesh, pcfg))
        steps = [np.asarray(logits)]
        for pos in range(prompt, toks.shape[1]):
            logits, cache = decode(params, cache,
                                   {"tokens": put(toks[:, pos:pos + 1])},
                                   pos)
            steps.append(np.asarray(logits))
        np.savez(run["out"], *steps)


    # the runs compile side by side (XLA's compiles release the
    # interpreter)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(train, run) for run in spec["runs"]] + [
                pool.submit(serve, run) for run in spec["serve"]]:
            f.result()
""")


def run_both(tmp, data: int, model: int, runs, steps: int = 2,
             blocks: bool = False, spread=(), serve=()) -> dict:
    """Each run ``(name, pkw)`` on a (data, model) mesh, ``steps`` AdamW
    steps of B 8 x S 32 on both sides (``pkw``: ``ParallelConfig``
    overrides, ``act_*`` keys overriding ``act_rules``). Returns {tag:
    {"ref_losses", "n_dev", "before", "ref_params", "port"}} (weights as
    {path: array} in the port's layout), for the tags in ``spread`` also
    "ref_unsharded", the reference's weights after the same steps off the
    mesh, and, with ``blocks``, "blocks": the port's
    ``torch_mesh_ranks.block_checks`` on the same mesh. Each ``serve`` run
    ``(name, pkw, prompt, cap, tokens)``, on the same mesh: a prefill of
    ``prompt`` of B 4 x ``tokens`` seeded token ids into a cache of
    ``cap`` positions, then a decode step of each later token
    (``torch_mesh_ranks.serve_steps``; a ``kernel`` entry of ``pkw`` is the
    port's alone: the reference serves the plain path it dispatches to);
    ``out["serve"][tag]`` holds "ref" and "port", the logits of each step,
    and the port's "calls" of the attention kernels."""
    from repro_torch.models.stepfn import BATCH_AXES
    spec = {"data": data, "model": model, "axes": BATCH_AXES, "runs": [],
            "serve": []}
    port_runs, trees, weights_at = [], {}, {}
    for name, pkw in runs:
        tag = R.tag(name, pkw)
        key = tag.replace(" ", "_").replace("=", "-")
        cfg = smoke_config(name).replace(dtype="float32")
        np.savez(tmp / f"{key}.npz", **R.batch_np(cfg, 8, 32))
        trees[tag] = (name, cfg, str(tmp / f"{key}.ref.npz"))
        weights_at[name] = str(tmp / f"{name}.pt")
        spec["runs"].append({"name": name, "pkw": R.pcfg_kw(pkw),
                             "steps": steps,
                             "batch": str(tmp / f"{key}.npz"),
                             "out": trees[tag][2], "spread": tag in spread})
        port_runs.append((name, pkw, weights_at[name],
                          str(tmp / f"{key}.npz"), steps))
    serve_runs, serve_out = [], {}
    for i, (name, pkw, prompt, cap, n) in enumerate(serve):
        tag, key = R.tag(name, pkw), f"serve{i}"
        cfg = smoke_config(name).replace(dtype="float32")
        np.savez(tmp / f"{key}.npz", tokens=R.tokens(cfg.vocab_size, 4, n))
        serve_out[tag] = str(tmp / f"{key}.ref.npz")
        weights_at[name] = str(tmp / f"{name}.pt")
        spec["serve"].append({
            "name": name, "pkw": R.pcfg_kw({k: v for k, v in pkw.items()
                                            if k != "kernel"}),
            "batch": str(tmp / f"{key}.npz"), "prompt": prompt, "cap": cap,
            "out": serve_out[tag]})
        serve_runs.append((name, pkw, weights_at[name],
                           str(tmp / f"{key}.npz"), prompt, cap))
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # the reference starts first: it makes its own weights, the same ones
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(tmp / "spec.json")], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        ref_trees = {}
        for name, path in weights_at.items():
            ref_trees[name] = jax.tree.map(np.asarray, jax_params.init_params(
                jax_smoke_config(name).replace(dtype="float32"),
                jax.random.PRNGKey(0)))
            torch.save(P.params_from_jax(ref_trees[name], smoke_config(
                name).replace(dtype="float32")), path)
        R.spawn(R.family_job, data * model, tmp, data, model, port_runs,
                str(tmp / "port.pt"),
                str(tmp / "blocks.pt") if blocks else None, serve_runs,
                str(tmp / "serve.pt"))
        _, err = ref.communicate(timeout=R.TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    port = torch.load(tmp / "port.pt")
    out = {}
    for tag, (name, cfg, path) in trees.items():
        tree = ref_trees[name]
        want = np.load(path)
        flat, treedef = jax.tree.flatten(tree)

        def weights(prefix):
            return {p: t.numpy() for p, t in P.leaves(P.params_from_jax(
                jax.tree.unflatten(treedef, [want[f"{prefix}{i}"] for i in
                                             range(len(flat))]), cfg))}
        out[tag] = {
            "ref_losses": want["losses"].tolist(), "n_dev": int(want["n_dev"]),
            "before": {p: t.numpy() for p, t in
                       P.leaves(P.params_from_jax(tree, cfg))},
            "ref_params": weights("p"), "port": port[tag]}
        if tag in spread:
            out[tag]["ref_unsharded"] = weights("u")
    if blocks:
        out["blocks"] = torch.load(tmp / "blocks.pt")
    if serve:
        port = torch.load(tmp / "serve.pt")
        out["serve"] = {tag: {"ref": list(np.load(path).values()),
                              **port[tag]}
                        for tag, path in serve_out.items()}
    return out


def assert_logits_match(got: dict, rtol: float = 1e-5) -> None:
    """Each step's logits (the prefill's, then each decode step's) within
    ``rtol`` of the reference's largest |logit|."""
    assert len(got["logits"]) == len(got["ref"])
    for i, (a, b) in enumerate(zip(got["logits"], got["ref"])):
        b = np.asarray(b, np.float64)
        err = float(np.abs(a.double().numpy() - b).max())
        assert err <= rtol * float(np.abs(b).max()), (i, err)


def assert_losses_match(got: dict, n_dev: int) -> None:
    """Every step's loss within LOSS_RTOL of the reference's, on its
    ``n_dev`` devices."""
    assert got["n_dev"] == n_dev
    assert len(got["port"]["losses"]) == len(got["ref_losses"])
    for a, b in zip(got["port"]["losses"], got["ref_losses"]):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (a, b)


def assert_updates_match(got: dict) -> None:
    """The weights after the steps, each leaf's update within the train
    tests' rule (``assert_updates_close``) of the reference's. Where the
    run measured the reference's own spread ("ref_unsharded") and the
    reference's sharded and unsharded updates of a leaf are further apart
    than that rule, the leaf's update is not set by the reference (its
    gradient entries sit at the rounding level, and AdamW's
    g / (|g| + eps) moves the weight by what rounding gives): there the
    port's is held within twice the reference's spread, as far from the
    reference's as two runs each that far from the exact update can be."""
    spread = got.get("ref_unsharded", {})
    for path, b in got["before"].items():
        b = np.asarray(b, np.float64)
        want = np.asarray(got["ref_params"][path], np.float64)
        d_want = want - b
        d_got = got["port"]["params"][path].detach().double().numpy() - b
        err = float(np.linalg.norm(d_got - d_want))
        tol = UPDATE_RTOL * float(np.linalg.norm(d_want)) + 1e-12
        if path in spread:
            tol = max(tol, 2 * float(np.linalg.norm(
                np.asarray(spread[path], np.float64) - want)))
        assert err <= tol, (path, err, tol)
