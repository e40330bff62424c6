"""Device meshes over the ranks of a ``torch.distributed`` process group.

Port of ``repro/launch/mesh.py``. ``make_host_mesh`` is the reference's
small mesh, ``(pod, data, model)`` with the ``pod`` dim only when it is
larger than 1, as a ``DeviceMesh`` over the process group's ranks: one
rank a card (device type ``"cuda"``), or one rank a CPU process with
``device="cpu"`` (the tests' gloo groups). The caller starts the process
group (``torch.distributed.init_process_group`` with its address, world
size and rank: nothing on the card's host tells a program of a cluster).

``make_production_mesh`` is the reference's production mesh with its
chip counts and axis names, laid out for H100s: ``single`` is one DGX
H100 SuperPOD scalable unit, 32 nodes of 8 cards, as (data 32, model 8),
and ``multi`` two units, (pod 2, data 32, model 8). ``model`` is the
innermost dim, so its groups are the 8 cards of one node, joined by
NVLink; ``data`` and ``pod`` groups span nodes, over InfiniBand. No such
machine is at hand: the mesh is built over a fake world of that many
ranks (the ``fake`` process-group backend, which moves no data), which
the context manager opens and closes, for the dry-run to trace a
sharded step on meta tensors as rank 0 of it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

from repro_torch.kernels.tuning import resolve_device

#: the reference's production meshes by name: (shape, axis names)
PRODUCTION_MESHES: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "single": ((32, 8), ("data", "model")),
    "multi": ((2, 32, 8), ("pod", "data", "model")),
}


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1, *,
                   device=None):
    """A ``DeviceMesh`` of shape (pod, data, model) (``pod`` dropped when
    1) with those dim names, over the default process group, whose world
    size must be the mesh's product. ``device``: the card unless it says
    ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    axes, shape = [], []
    if pod > 1:
        axes.append("pod")
        shape.append(pod)
    axes += ["data", "model"]
    shape += [data, model]
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs a process group: "
                           "call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"need {n} ranks, have {world}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake world of
    its product of ranks, this process rank 0; the world is closed on
    exit. Collectives on it move nothing: it is for tracing on meta
    tensors. The mesh's device type is the card's (``cuda``: DTensor
    plans an all-to-all as such there, and as gathers on a CPU mesh);
    building it touches no card. Raises in a process that already holds a
    process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a fake world cannot open beside a process "
                           "group: run the mesh dry-run in its own process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cuda", tuple(shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (``single``, or ``multi`` with ``multi_pod``)
    over a fake world, as a context manager: ``with
    make_production_mesh() as mesh: ...``."""
    return fake_mesh(*PRODUCTION_MESHES["multi" if multi_pod else "single"])
