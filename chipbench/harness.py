"""One run of one cell: inputs from the seed, the program built and warmed
up, closed-loop batches over the window, the metrics, and the comparison.

The traffic is closed-loop offline batches: one client submits the next
batch when the last one has ended. A batch is ``batch`` prompts of
``prompt`` tokens drawn from the seed, prefilled together
(``DecodeServer.prefill_batch``, which serves the first token), then
``output - 1`` decode steps (``DecodeServer.decode_step``, a CUDA graph
replay on the card), each serving one more token to every prompt. The
window opens after set-up and closes at the end of the first batch that
ends ``seconds`` or more after it opened, so it holds whole batches only
and every request whose batch started in it finishes in it.

What depends on the model's architecture (its sizes, weights, reference,
work counts and the port's model of it) is its family's
(``families/<family>.py``, the configuration file's ``"family"``), which
:func:`family` imports. A ``--trace 1`` run also keeps what the program
records of itself: its spans, and which of its batches were the window's.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch

from chipbench import correct, work
from chipbench.trace import TraceWindow, Tracer
from chipbench.weights import DTYPES, Prompts

ROOT = Path(__file__).resolve().parent
#: the batch of the window that a traced run profiles (the first whole
#: batch after the window's first)
TRACED_BATCH = 1


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with the files its names lead to and
    its configuration's family module."""

    name: str
    config: Dict
    traffic: Dict
    check: Dict
    family: ModuleType
    chips: int = 1

    @property
    def batch(self) -> work.Batch:
        t = self.traffic
        return work.Batch(t["batch"], t["prompt"], t["output"])

    @property
    def dims(self):
        """The family's sizes of the configuration."""
        return self.family.sizes(self.config)


def _json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def as_run(c: Dict) -> Dict:
    """A configuration file's numbers as the program runs them: the
    source's keys with the file's ``departures`` (where the port's
    equations differ from the published model's) laid over them."""
    return {**c, **c.get("departures", {})}


def family(name: str) -> ModuleType:
    """The family module ``chipbench.families.<name>``, the file
    ``families/<name>.py`` (its interface: ``families/__init__.py``)."""
    return importlib.import_module(f"chipbench.families.{name}")


def load_cell(bench: Dict, name: str) -> Cell:
    """The cell ``name`` of the benchmark file ``bench``, with its
    configuration, traffic and check files and its configuration's
    family."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = as_run(_json(ROOT.parent / conf["file"]))
    return Cell(name=name, config=config,
                traffic=_json(ROOT / "traffic" / f"{w['traffic']}.json"),
                check=_json(ROOT / "cells" / f"{name}.json"),
                family=family(config.get("family", "dense")),
                chips=w["chips"])


@dataclass
class Run:
    """What one run measured; the metric readers (``metrics/*.py``) read
    it."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    batches: int = 0
    tokens: int = 0
    ttft_s: List[float] = field(default_factory=list)
    itl_s: List[float] = field(default_factory=list)
    prefill_s: List[float] = field(default_factory=list)
    batch_s: List[float] = field(default_factory=list)
    capture_s: List[float] = field(default_factory=list)
    peak_bytes: int = 0
    trace: Optional[TraceWindow] = None
    #: ``--trace 1`` runs only: the program's spans as plain records
    #: (``program.spans``), and each window batch's prefill serial (the
    #: ``batch`` its spans carry) with whether it was the profiled one
    spans: List[Dict] = field(default_factory=list)
    window_batches: List[Tuple[int, bool]] = field(default_factory=list)

    @property
    def requests(self) -> int:
        return self.batches * self.cell.batch.batch

    def untraced_batch_s(self) -> List[float]:
        """Wall seconds of each batch that ran without the profiler
        (a profiled batch runs slower: CUPTI times every kernel of a
        graph replay)."""
        return [s for i, s in enumerate(self.batch_s)
                if self.trace is None or i != TRACED_BATCH]


def _sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def serve(cell: Cell, seed: int, seconds: float, *, device, t0: float,
          trace: bool = False, batches: Optional[int] = None,
          log=print) -> Tuple[Run, List[Tuple], Dict]:
    """Set up the program, warm it up and run the window (``batches``
    whole batches instead, where given). Returns the run, each finished
    batch's (prompts, served tokens) and the weights. ``t0`` is the
    process's start on ``time.perf_counter``'s clock."""
    device = torch.device(device)
    b, run = cell.batch, Run(cell)
    dtype = DTYPES[cell.config["torch_dtype"]]
    weights = cell.family.make_weights(cell.dims, dtype, seed, device)
    from chipbench import program
    server = program.build_server(cell, weights, device=device, log=log,
                                  trace=trace)
    # warm-up, on prompts of token 0: a prefill of the cell's shape, the
    # decode graph's capture (the first decode step), then a prefill and a
    # replay again: on the card the first prefill after the capture ran up
    # to 0.6 s longer than the later ones
    zeros = torch.zeros((b.batch, b.prompt), dtype=torch.long,
                        device=device)
    for _ in range(2):
        server.prefill_batch({"tokens": zeros})
        server.decode_step()
    sync = _sync(device)
    sync()
    run.capture_s = list(server.capture_s)
    prompts = Prompts(seed, cell.dims.vocab, b.batch, b.prompt, device)
    tracer = Tracer()
    finished: List[Tuple] = []
    start = time.perf_counter()
    run.setup_s = start - t0
    deadline = start + seconds
    while True:
        traced = trace and run.batches == TRACED_BATCH
        with (tracer.window(sync) if traced
              else contextlib.nullcontext()):
            with tracer.span("chipbench.prompts"):
                toks = prompts.next()
            t = time.perf_counter()
            with tracer.span("chipbench.prefill"):
                server.prefill_batch({"tokens": toks})
            ttft = time.perf_counter() - t
            for _ in range(b.output - 1):
                with tracer.span("chipbench.decode_step"):
                    run.itl_s.append(server.decode_step())
        run.batch_s.append(time.perf_counter() - t)
        run.prefill_s.append(ttft)
        run.ttft_s += [ttft] * b.batch
        run.tokens += b.batch * b.output
        run.batches += 1
        if trace:
            run.window_batches.append((program.batch_serial(server), traced))
        finished.append((toks, torch.stack(server.out, dim=1)))
        if batches is not None:
            if run.batches >= batches:
                break
        elif (time.perf_counter() >= deadline
              and (not trace or tracer.result is not None)):
            break
    run.window_s = time.perf_counter() - start
    run.trace = tracer.result
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    if trace:
        run.spans = program.spans(server)
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run, finished, weights


def reader(metric: str):
    """The ``read(run)`` function of a metric's file,
    ``metrics/<metric>.py``."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "chipbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: end-to-end without the trace,
    per-layer with it, each where its ``workloads`` (if any) name the
    cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(bench: Dict, run: Run, trace: bool) -> Dict[str, Dict]:
    out = {}
    for m in metrics_of(bench, run.cell.name, trace):
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def check(run: Run, finished: List[Tuple], weights: Dict, seed: int
          ) -> Tuple[Dict[str, Dict], int]:
    """Each number compared, with its limit (the widest gap over the
    sample, :mod:`chipbench.correct`), and the served tokens the sample
    holds."""
    got = correct.compare(run.cell, weights, finished,
                          run.cell.check["requests"], seed)
    limits = run.cell.check["limits"]
    return ({name: {"value": got[name], "limit": limit}
             for name, limit in limits.items()}, got["tokens"])
