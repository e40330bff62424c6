"""Objectives: the expensive black-box f(x) (paper §III-A).

Three families:
  * SimulatedObjective — the paper's simulation mode: a recorded/synthetic
    table of per-config runtimes (NaN = runtime-invalid). Deterministic,
    hardware-free benchmarking of search strategies.
  * CallableObjective — wraps a real measurement.
  * KernelObjective (repro_torch.kernels.tuning) — a hand-written CUDA
    kernel timed on the card with CUDA events.

Invalid configurations return NaN; the runner records them but the BO
surrogate never sees them (§III-D2).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.core.searchspace import SearchSpace


class Objective:
    """Protocol: evaluate config index -> runtime (lower better, NaN invalid)."""

    space: SearchSpace
    name: str = "objective"

    def __call__(self, idx: int) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def eval_config(self, cfg: Dict[str, Any]) -> float:
        """Evaluate an arbitrary config dict (constraint-unaware strategies
        may propose configs outside the restricted space -> invalid)."""
        idx = self.space.index_of(cfg)
        if idx is None:
            return math.nan
        return self(idx)

    @property
    def optimum(self) -> Optional[float]:
        return None


class SimulatedObjective(Objective):
    """Paper's simulation mode: precomputed runtimes for the whole space."""

    def __init__(self, space: SearchSpace, times: np.ndarray, name: str = "sim"):
        assert len(times) == space.size
        self.space = space
        self.times = np.asarray(times, np.float64)
        self.name = name
        valid = self.times[np.isfinite(self.times)]
        self._optimum = float(valid.min()) if len(valid) else math.nan

    def __call__(self, idx: int) -> float:
        return float(self.times[idx])

    @property
    def optimum(self) -> float:
        return self._optimum

    @property
    def n_invalid(self) -> int:
        return int(np.sum(~np.isfinite(self.times)))


class CallableObjective(Objective):
    def __init__(self, space: SearchSpace, fn: Callable[[Dict[str, Any]], float],
                 name: str = "callable"):
        self.space = space
        self.fn = fn
        self.name = name

    def __call__(self, idx: int) -> float:
        try:
            v = self.fn(self.space.config(idx))
        except Exception:
            return math.nan
        return float(v) if v is not None else math.nan
