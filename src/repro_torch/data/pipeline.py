"""Deterministic, sharded, restartable LM data pipeline.

Port of ``repro/data/pipeline.py``, whole: the reference is numpy only, so
this module is its copy, and a (seed, step, host_slice) gives the same
tokens in both packages. Two sources:
  * SyntheticLM — seeded token stream (a mixture of Zipfian unigrams and
    repeated n-gram motifs so a ~100M model actually has something to learn);
  * MemmapCorpus — flat uint16/uint32 token file, memory-mapped.

Both are (a) deterministic in (seed, step) — a restarted job re-reads the
exact same batch for any step, which makes checkpoint/restart bitwise
reproducible — and (b) host-shardable: each host materializes only its
slice of the global batch (`host_slice`). Batches are numpy arrays on the
host; the train loop (``runtime/train.py``) moves each to its device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"          # synthetic | memmap
    path: Optional[str] = None       # for memmap
    n_motifs: int = 512
    motif_len: int = 16


class SyntheticLM:
    """Zipf unigrams + motif insertions; ~40% of tokens belong to motifs."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        self.motifs = base.integers(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len)).astype(np.int32)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()

    def batch(self, step: int, host_slice: Tuple[int, int] = (0, 1)
              ) -> Dict[str, np.ndarray]:
        """Global-batch rows [lo, hi) for this host, deterministic in step."""
        cfg = self.cfg
        shard, n_shards = host_slice
        rows = range(shard * cfg.global_batch // n_shards,
                     (shard + 1) * cfg.global_batch // n_shards)
        out = np.empty((len(rows), cfg.seq_len), np.int32)
        for i, row in enumerate(rows):
            rng = np.random.default_rng((cfg.seed, step, row))
            seq = rng.choice(cfg.vocab_size, size=cfg.seq_len, p=self.unigram)
            n_ins = cfg.seq_len // (2 * cfg.motif_len)
            for _ in range(n_ins):
                m = rng.integers(cfg.n_motifs)
                pos = rng.integers(0, cfg.seq_len - cfg.motif_len)
                seq[pos:pos + cfg.motif_len] = self.motifs[m]
            out[i] = seq
        return {"tokens": out}


class MemmapCorpus:
    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        assert cfg.path
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_tokens = len(self.data)

    def batch(self, step: int, host_slice: Tuple[int, int] = (0, 1)
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        shard, n_shards = host_slice
        rows = range(shard * cfg.global_batch // n_shards,
                     (shard + 1) * cfg.global_batch // n_shards)
        out = np.empty((len(rows), cfg.seq_len), np.int32)
        span = self.n_tokens - cfg.seq_len - 1
        for i, row in enumerate(rows):
            rng = np.random.default_rng((cfg.seed, step, row))
            start = int(rng.integers(0, span))
            out[i] = self.data[start:start + cfg.seq_len]
        return {"tokens": out}


def make_source(cfg: DataConfig):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg)
    if cfg.kind == "memmap":
        return MemmapCorpus(cfg)
    raise ValueError(cfg.kind)


class DataIterator:
    """Stateful cursor over a source; state = just the step (restartable)."""

    def __init__(self, source, start_step: int = 0,
                 host_slice: Tuple[int, int] = (0, 1)):
        self.source = source
        self.step = start_step
        self.host_slice = host_slice

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.source.batch(self.step, self.host_slice)
        self.step += 1
        return b

    def state(self) -> Dict:
        return {"step": self.step}

    def restore(self, state: Dict):
        self.step = int(state["step"])
