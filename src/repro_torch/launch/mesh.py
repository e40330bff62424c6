"""Device meshes over the ranks of a ``torch.distributed`` process group.

Port of ``repro/launch/mesh.py``. ``make_host_mesh`` is the reference's
small mesh, ``(pod, data, model)`` with the ``pod`` dim only when it is
larger than 1, as a ``DeviceMesh`` over the process group's ranks: one
rank a card (device type ``"cuda"``), or one rank a CPU process with
``device="cpu"`` (the tests' gloo groups). The caller starts the process
group (``torch.distributed.init_process_group`` with its address, world
size and rank: nothing on the card's host tells a program of a cluster).

``make_production_mesh`` is cut: its shapes are the TPU pods' (a v5e-256
as data 16 x model 16, two of them joined over the data-centre network),
which no machine of H100s has.
"""
from __future__ import annotations

import math

from repro_torch.kernels.tuning import resolve_device


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
