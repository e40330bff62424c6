"""The program under test, and the only module here that imports it: the
port's ``DecodeServer`` (``src/repro_torch/launch/serve.py``) built at a
cell's shapes with the port's built-in kernel blocks (no tuning store is
read or written), and what the program records of itself: its spans
(``launch/spans.py``)."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Dict, List, Optional

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# the port's registry, which each family's ``arch_config`` reads from here
from repro_torch.configs.registry import get_arch  # noqa: E402,F401
from repro_torch.launch import serve  # noqa: E402
from repro_torch.parallel.sharding import ParallelConfig  # noqa: E402


def build_server(cell, weights: Dict, *, device, log, trace: bool = False):
    """A ``DecodeServer`` over ``weights`` for the cell's batches: the
    port's model of the cell's configuration (its family's
    ``arch_config``), batches of ``batch`` prompts of ``prompt`` tokens and
    ``output`` tokens each. ``trace``: the server records its spans."""
    cfg = cell.family.arch_config(cell.config)
    b = cell.batch
    kc = serve.serving_kernel_config(cfg, device=device, prompt_len=b.prompt,
                                     cache_cap=b.prompt + b.output,
                                     batch=b.batch, store=None, log=log)
    return serve.DecodeServer(cfg, ParallelConfig().replace(kernel=kc),
                              batch=b.batch, prompt_len=b.prompt,
                              decode_steps=b.output, device=device,
                              params=weights, trace=trace)


def batch_serial(server) -> Optional[int]:
    """The prefill serial that the server's spans of its latest batch carry
    (None where it records no spans)."""
    return None if server.recorder is None else server.recorder.batch


def spans(server) -> List[Dict]:
    """The server's spans as plain records, in the order they opened:
    ``name``, ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``),
    ``parent`` (the index of the span open around it, or None), ``batch``
    (its prefill serial), ``step`` (inside a decode step, its index in the
    batch) and ``device_ms`` (its CUDA-event interval, where it has one).
    None are recorded unless the server was built with ``trace``."""
    if server.recorder is None:
        return []
    return [dataclasses.asdict(s) for s in server.recorder.spans]
