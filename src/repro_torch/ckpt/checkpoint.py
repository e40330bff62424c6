"""Atomic step checkpoints, in the reference's on-disk format.

Port of ``repro/ckpt/checkpoint.py``. Layout (one directory per step):
    ckpt_dir/step_00000123.tmp/   — written first
        manifest.json             — step, n_leaves, dtypes, extras
        arr_00000.npy ...         — one file per leaf
    ckpt_dir/step_00000123/       — atomic os.replace when complete

Guarantees:
  * atomicity — a crash mid-write never corrupts the latest checkpoint
    (`latest()` only sees fully renamed directories);
  * determinism — leaves are indexed in the port's tree order
    (``models/params.leaves``: dict keys sorted, lists in order, which is
    jax's order for dicts);
  * async — `AsyncCheckpointer` copies every leaf to the host, then writes
    in a thread, overlapping I/O with the next training steps.

numpy has no bfloat16 (the reference takes it from ``ml_dtypes``, which the
port does not use): a bf16 leaf is stored as its ``uint16`` bits, tagged
``"bfloat16"`` in the manifest, and fp8 leaves as ``uint8`` bits likewise,
so a directory either package writes is read by the other's ``latest`` and
``load_manifest``, and its leaves by the other's ``restore``. ``restore``
returns CPU tensors; ``restore_sharded`` is the reference's elastic
restore: each leaf is saved whole (a DTensor gathered by every rank, rank
0 writing), and placed on restore onto its target, a device or a
``(DeviceMesh, placements)`` pair, which may be another mesh than the
one it was saved from, or none.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import leaves, map_tree, map_tree_paths

# dtype tag -> (torch dtype, the numpy type stored (its bits), the numpy
# type torch reads those bits through)
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, np.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8)}
_TAG = {v[0]: k for k, v in _EXOTIC.items()}


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype in _TAG:
        name = _TAG[t.dtype]
        bits = torch.int16 if t.element_size() == 2 else torch.uint8
        return t.view(bits).numpy().view(_EXOTIC[name][1]), name
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _EXOTIC:
        dtype, _, via = _EXOTIC[name]
        return torch.from_numpy(arr.view(via)).view(dtype)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree, extras: Optional[Dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    dtypes = []
    flat = [t for _, t in leaves(tree)]
    for i, leaf in enumerate(flat):
        sav, tag = _to_savable(leaf)
        dtypes.append(tag)
        np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), sav)
    meta = {"step": step, "n_leaves": len(flat), "dtypes": dtypes,
            "extras": extras or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if re.fullmatch(r"step_\d+", d)
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps))


def load_manifest(path: str) -> Dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def restore(path: str, like_tree) -> Tuple[Any, Dict]:
    """Restore into the structure of `like_tree` (CPU tensors, the dtypes
    the manifest tags)."""
    meta = load_manifest(path)
    paths = [p for p, _ in leaves(like_tree)]
    if meta["n_leaves"] != len(paths):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, "
                         f"target {len(paths)}")
    out = {p: _from_savable(np.load(os.path.join(path, f"arr_{i:05d}.npy")),
                            name)
           for i, (p, name) in enumerate(zip(paths, meta["dtypes"]))}
    return map_tree_paths(like_tree, out), meta["extras"]


def _place(t: torch.Tensor, target) -> torch.Tensor:
    """``t`` (whole, on the host) on a device, or as a DTensor on a
    ``(mesh, placements)`` target: each rank keeps its own slice."""
    if isinstance(target, tuple):
        from torch.distributed.tensor import distribute_tensor
        mesh, placements = target
        return distribute_tensor(t.to(mesh.device_type), mesh, placements,
                                 src_data_rank=None)
    return t.to(target)


def restore_sharded(path: str, like_tree, shardings) -> Tuple[Any, Dict]:
    """Restore, then place each leaf on its target: ``shardings`` is one
    target for every leaf, or a tree like ``like_tree`` of them; a target
    is a device or a ``(DeviceMesh, placements)`` pair (the reference's
    target shardings, which may differ from the placement at save time)."""
    host, extras = restore(path, like_tree)
    if isinstance(shardings, (dict, list)):
        where = dict(leaves(shardings))
        placed = {p: _place(t, where[p]) for p, t in leaves(host)}
    else:
        placed = {p: _place(t, shardings) for p, t in leaves(host)}
    return map_tree_paths(like_tree, placed), extras


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of the whole tensor: a DTensor is gathered first (every
    rank of its mesh takes part)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    # a copy even of a CPU leaf: the train step updates its weights in
    # place while the thread writes
    return t.detach().to("cpu", copy=True)


def _writes() -> bool:
    """Rank 0 of a process group, or a process without one, writes."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


class AsyncCheckpointer:
    """Copy to the host synchronously, write in a background thread. With
    DTensor leaves every rank gathers them and rank 0 writes; ``wait``
    then holds every rank until the write is done, so that none reads a
    directory rank 0 is still writing."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._sharded = False
        self.last_path: Optional[str] = None

    def save(self, step: int, tree, extras: Optional[Dict] = None):
        from torch.distributed.tensor import DTensor
        self.wait()
        self._sharded = any(isinstance(t, DTensor) for _, t in leaves(tree))
        host = map_tree(_whole, tree)
        if not _writes():
            return

        def work():
            self.last_path = save(self.ckpt_dir, step, host, extras)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            import torch.distributed as dist
            dist.barrier()

    def _gc(self):
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(d for d in os.listdir(self.ckpt_dir)
                       if re.fullmatch(r"step_\d+", d))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)
