"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library with a
plain C interface, loaded with ``ctypes``. No PyTorch headers are included,
so a build takes seconds. The library lands in ``build/repro_torch/`` at
the checkout's root, named by a hash of the sources and flags: a changed
source rebuilds, an unchanged one loads what is there.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()`` right after the launch; :func:`check` turns a nonzero
code into an exception. A launch the card refuses for its configuration
(too many threads, registers or shared memory) raises
:class:`LaunchRefused` — the paper's runtime-invalid configuration — and
every other error raises :class:`CudaError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

#: cudaError_t codes of a launch refused for its configuration
#: (driver_types.h of CUDA 12).
REFUSED = {701: "cudaErrorLaunchOutOfResources",
           9: "cudaErrorInvalidConfiguration"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: Seconds the last build took (0.0 when the library was loaded as built).
build_seconds = 0.0


class CudaError(RuntimeError):
    """A CUDA runtime error returned by a kernel's C entry point."""

    def __init__(self, code: int, what: str):
        self.code = code
        super().__init__(f"{what}: CUDA error {code} ({error_string(code)})")


class LaunchRefused(CudaError):
    """The card refused the launch for its configuration; the kernel never
    ran and the CUDA context is intact."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH):"
                           " the CUDA kernels are built on the card's host")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _ in procs), "-o",
             str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, target)       # atomic: readers never see half
    build_seconds = time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("gemm_f32", "gemm_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    lib.gemm_attrs.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.gemm_attrs.restype = i
    lib.gp_posterior_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, f, i, i, p]
    lib.gp_posterior_f32.restype = i
    lib.gp_attrs.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.gp_attrs.restype = i
    for name in ("flash_attention_f32", "flash_attention_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    lib.flash_attention_attrs.argtypes = [i, i, i, i, ctypes.POINTER(i),
                                          ctypes.POINTER(i)]
    lib.flash_attention_attrs.restype = i
    for name in ("decode_split_f32", "decode_split_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 12 + [i] * 10 + [p]
        fn.restype = i
    lib.decode_attrs.argtypes = [i, i, i, ctypes.POINTER(i),
                                 ctypes.POINTER(i)]
    lib.decode_attrs.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


def lib() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
            if not target.exists():
                _compile(target)
            handle = ctypes.CDLL(str(target))
            _declare(handle)
            _lib = handle
        return _lib


def error_string(code: int) -> str:
    """cudaGetErrorString of ``code``, without building the library."""
    if _lib is None:
        return REFUSED.get(code, "unknown error")
    return _lib.repro_cuda_error_string(code).decode()


def check(code: int, what: str) -> None:
    """Raise for a nonzero ``cudaError_t`` returned by an entry point."""
    if code == 0:
        return
    if code in REFUSED:
        raise LaunchRefused(code, what)
    raise CudaError(code, what)


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch stream on ``t``'s device, as a raw handle."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
