"""The port's side of the mesh dry-run tests, one job a process.

Each job opens the fake worlds it needs (``launch/mesh.fake_mesh``): a
process holds one default group, and a test worker must not, so
``tests/test_torch_dryrun_mesh.py`` runs this file in a subprocess:

    python tests/torch_dryrun_mesh_jobs.py '{"job": "args", ...}'

and reads the JSON object it prints last. No JAX: the reference's side
runs in its own subprocess on forced host devices.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs.arch import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    DEFAULT_ACT_RULES, DEFAULT_PARAM_RULES, ParallelConfig)

CARD = "NVIDIA H100 80GB HBM3"
COUNTS = ("flops", "bytes", "args", "temp", "coll", "dcn", "coll_by_kind")


def _cfg(spec):
    cfg = smoke_config(spec["arch"])
    if "layers" in spec:
        cfg = cfg.replace(num_layers=spec["layers"])
    return cfg


def _pcfg(spec):
    kw = dict(logits_chunk=0)
    if spec.get("embed_rule") == "none":
        kw["param_rules"] = {**DEFAULT_PARAM_RULES, "embed": None}
    if spec.get("rules"):
        kw["act_rules"] = {**DEFAULT_ACT_RULES, **spec["rules"]}
    if "remat" in spec:
        kw["remat"] = spec["remat"]
    return ParallelConfig(**kw)


def _shape(spec):
    return ShapeConfig("s", spec.get("seq", 16), spec.get("batch", 8),
                       spec.get("kind", "train"))


def _axes(dims):
    return ("pod", "data", "model")[3 - len(dims):]


def _counts(r):
    return {k: r[k] for k in COUNTS}


def trace(spec):
    """Counts of one trace on the mesh ``dims`` (none: one card)."""
    cfg, pcfg, shape = _cfg(spec), _pcfg(spec), _shape(spec)
    if not spec.get("dims"):
        return _counts(D.trace_step(cfg, shape, pcfg))
    with fake_mesh(tuple(spec["dims"]), _axes(spec["dims"])) as mesh:
        return _counts(D.trace_step(cfg, shape, pcfg, mesh=mesh))


def cut(spec):
    """The depth cut (``measure``) beside a whole trace, on the mesh."""
    cfg, pcfg, shape = _cfg(spec), _pcfg(spec), _shape(spec)
    with fake_mesh(tuple(spec["dims"]), _axes(spec["dims"])) as mesh:
        m = D.measure(cfg, shape, pcfg, mesh)
        w = D.trace_step(cfg, shape, pcfg, mesh=mesh)
    return {"cut": {k: m[k] for k in COUNTS}, "whole": _counts(w),
            "scaled": m["scaled"]}


def record(spec):
    """``run_cell`` of a smoke config at a reference cell, on the mesh
    ``mesh`` (a name or {axis: size}) and on one card."""
    pcfg = _pcfg(spec)
    mesh = spec["mesh"]
    if isinstance(mesh, list):
        mesh = dict(zip(_axes(mesh), mesh))
    return {"mesh": D.run_cell(spec["arch"], spec["shape"], CARD, pcfg,
                               cfg=_cfg(spec), mesh=mesh),
            "card": D.run_cell(spec["arch"], spec["shape"], CARD, pcfg,
                               cfg=_cfg(spec))}


def rules(spec):
    """``run_cell`` of a cell at full width on a production mesh under
    each ``act_rules`` override of ``spec["rules"]`` ({}: the defaults):
    each record's status, error, memory and collectives by kind."""
    out = []
    for r in spec["rules"]:
        pcfg = ParallelConfig(act_rules={**DEFAULT_ACT_RULES, **r})
        rec = D.run_cell(spec["arch"], spec["shape"], CARD, pcfg,
                         mesh=spec["mesh"])
        out.append({k: rec.get(k) for k in ("status", "error", "memory",
                                             "coll_by_kind")})
    return out


def meshes(spec):
    """Each production mesh's shape and names, and rank 0's group along
    each dim; then that a fake world refuses to open beside a process
    group (a one-rank gloo group here)."""
    import torch.distributed as dist
    from torch.distributed import get_process_group_ranks
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for name, multi in (("single", False), ("multi", True)):
        with make_production_mesh(multi_pod=multi) as mesh:
            out[name] = {"shape": list(mesh.shape),
                         "axes": list(mesh.mesh_dim_names),
                         "device": mesh.device_type,
                         "groups": {a: get_process_group_ranks(
                             mesh.get_group(a))
                             for a in mesh.mesh_dim_names}}
        out[name]["closed"] = not dist.is_initialized()
    dist.init_process_group("gloo", init_method="tcp://localhost:"
                            f"{spec['port']}", rank=0, world_size=1)
    try:
        with make_production_mesh():
            out["refused"] = None
    except RuntimeError as e:
        out["refused"] = str(e)
    finally:
        dist.destroy_process_group()
    return out


def main(argv):
    specs = json.loads(argv[1])
    out = [globals()[s["job"]](s) for s in specs]
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv)
