#!/usr/bin/env python3
"""The fused decode kernel's 8-row instance against its 16-row one, at G <= 8.

    python3 scripts/decode_rows_instance.py [--pairs 5] [--launches 50]

``csrc/flash_decode.cu`` is built in two instances, chosen by G (query
heads per KV head): 8 rows a block for G <= 8, 16 rows for 8 < G <= 16.
This script builds the source as it stands and a copy in which every G
takes the 16-row instance, then, on one NVIDIA card, launches both through
``kernels/flash_decode.flash_decode`` (bf16, fused) at the decode shapes of
the served models whose G is at most 8, with a cache of capacity 1,088
holding 1,055 valid slots (``chip_smoke.py``'s fill), at two block
configs. Each instance's time is one CUDA graph of ``--launches`` launches
replayed between two CUDA events, divided by the launches, in turns (the
source's instance, the copy's, the copy's, the source's; ``--pairs``
times); it prints the medians, their ratio, the two outputs' largest
difference and each instance's registers a thread.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# model: (B, capacity, H, KV, hd), each with G = H / KV <= 8
SHAPES = (("gemma-2b", (4, 1088, 8, 1, 256)),
          ("qwen3-moe-30b-a3b", (4, 1088, 32, 4, 128)),
          ("internlm2-1.8b", (4, 1088, 16, 8, 128)),
          ("stablelm-3b", (4, 1088, 32, 32, 80)))
BLOCKS = ((256, 1), (1024, 2))      # (block_kv, num_splits)
VALID = 1055                        # round(0.97 x 1,088)
SELECT = re.compile(r"G <= 8(\s*)\?")   # the instance choice, three places


def build_sixteen(out_dir: str):
    """The kernel source with every G on the 16-row instance, built alone
    into a shared library; its handle with the entry points declared."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_decode.cu").read_text()
    sixteen, n = SELECT.subn(r"false\1?", src)
    if n != 3:
        raise SystemExit("expected the instance choice 'G <= 8 ?' three "
                         f"times in flash_decode.cu, found {n}")
    cu = os.path.join(out_dir, "flash_decode_rows16.cu")
    so = os.path.join(out_dir, "libdecode_rows16.so")
    with open(cu, "w") as f:
        f.write(sixteen)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-shared", cu, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("decode_split_f32", "decode_split_bf16"):
        getattr(lib, name).argtypes = [p] * 12 + [i] * 10 + [p]
        getattr(lib, name).restype = i
    lib.decode_attrs.argtypes = [i, i, i, i, ctypes.POINTER(i),
                                 ctypes.POINTER(i)]
    lib.decode_attrs.restype = i
    return lib


class OnLibrary:
    """``kernels._build`` with ``lib()`` answering ``handle``: the decode
    wrapper launches from that library while this stands in."""

    def __init__(self, build, handle):
        self._b, self._h = build, handle

    def lib(self):
        return self._h

    def __getattr__(self, name):
        return getattr(self._b, name)


def regs(lib, hd: int, G: int) -> int:
    r, loc = ctypes.c_int(), ctypes.c_int()
    if lib.decode_attrs(1, 1, hd, G, ctypes.byref(r), ctypes.byref(loc)):
        raise SystemExit(f"decode_attrs failed at hd={hd}, G={G}")
    return r.value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--launches", type=int, default=50)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, flash_decode as kfd
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True
                         ).stdout.strip().splitlines()[0])
    source = _build.lib()
    (_build.BUILD_DIR).mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rows16_", dir=_build.BUILD_DIR)
    libs = {"8-row": source, "16-row": build_sixteen(tmp)}
    g = torch.Generator(device=dev).manual_seed(0)
    side = torch.cuda.Stream()      # the capture stream, launched on first
    for model, (B, S, H, KV, hd) in SHAPES:
        G = H // KV
        q = torch.randn(B, H, hd, generator=g, device=dev).bfloat16()
        k = torch.randn(B, S, KV, hd, generator=g, device=dev).bfloat16()
        v = torch.randn(B, S, KV, hd, generator=g, device=dev).bfloat16()
        for bkv, ns in BLOCKS:
            Sp = -(-S // (bkv * ns)) * bkv * ns
            bias = torch.full((B, Sp), float("-inf"), device=dev)
            bias[:, :VALID] = 0.0
            graphs, outs = {}, {}
            for name, lib in libs.items():
                kfd._build = OnLibrary(_build, lib)
                try:
                    def call():
                        return kfd.flash_decode(q, k, v, bias, block_kv=bkv,
                                                num_splits=ns)
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):   # its counters, outside
                        outs[name] = call()         # the capture
                    torch.cuda.synchronize()
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, stream=side):
                        for _ in range(args.launches):
                            call()
                    graphs[name] = graph
                finally:
                    kfd._build = _build
            times = {name: [] for name in libs}
            order = list(libs) + list(libs)[::-1]
            for _ in range(args.pairs):
                for name in order:
                    graphs[name].replay()            # warm
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    graphs[name].replay()
                    b.record()
                    b.synchronize()
                    times[name].append(a.elapsed_time(b) / args.launches)
            med = {name: statistics.median(t) for name, t in times.items()}
            diff = float((outs["8-row"].float()
                          - outs["16-row"].float()).abs().max())
            print(f"{model} (B {B}, capacity {S}, {VALID} valid, H {H}, KV "
                  f"{KV}, G {G}, hd {hd}) block_kv {bkv} x {ns} splits: "
                  f"8-row {med['8-row']:.5f} ms ({regs(source, hd, G)} "
                  f"registers), 16-row {med['16-row']:.5f} ms "
                  f"({regs(libs['16-row'], hd, G)} registers); 16-row / "
                  f"8-row {med['16-row'] / med['8-row']:.3f}; outputs "
                  f"differ by {diff:.3e}")
            del graphs
    return 0


if __name__ == "__main__":
    sys.exit(main())
