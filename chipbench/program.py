"""The program under test, and the only module here that imports it: the
port's ``DecodeServer`` (``src/repro_torch/launch/serve.py``) built at a
cell's shapes with the port's built-in kernel blocks (no tuning store is
read or written)."""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.parallel.sharding import ParallelConfig  # noqa: E402


def arch_config(c: Dict):
    """The port's ``ArchConfig`` of a configuration file: its registry entry
    at the file's depth, checked field by field against the file, so that
    a change of the port's registry stops the benchmark instead of
    measuring another model."""
    cfg = get_arch(c["registry_name"]).replace(
        num_layers=c["num_hidden_layers"])
    if c.get("smoke"):          # a test's cut of the widths, never a cell's
        cfg = cfg.replace(**c["smoke"])
    want = {"num_layers": c["num_hidden_layers"], "d_model": c["hidden_size"],
            "num_heads": c["num_attention_heads"],
            "num_kv_heads": c["num_key_value_heads"],
            "resolved_head_dim": c["head_dim"],
            "d_ff": c["intermediate_size"], "vocab_size": c["vocab_size"],
            "rope_theta": c["rope_theta"], "norm_eps": c["norm_eps"],
            "tie_embeddings": c["tie_word_embeddings"],
            "dtype": c["torch_dtype"], "family": "dense",
            "attention": "gqa", "mlp_act": "swiglu",
            "block_pattern": ("attn",), "local_window": None, "moe": None,
            "qk_norm": False, "scale_embeddings": False, "frontend": None,
            "cross_attention": False}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise ValueError(f"the port's {c['registry_name']} is not the "
                         f"configuration file's: (port, file) {bad}")
    return cfg


def build_server(c: Dict, weights: Dict, *, batch: int, prompt: int,
                 output: int, device, log):
    """A ``DecodeServer`` over ``weights`` for batches of ``batch`` prompts
    of ``prompt`` tokens and ``output`` tokens each."""
    cfg = arch_config(c)
    kc = serve.serving_kernel_config(cfg, device=device, prompt_len=prompt,
                                     cache_cap=prompt + output, batch=batch,
                                     store=None, log=log)
    return serve.DecodeServer(cfg, ParallelConfig().replace(kernel=kc),
                              batch=batch, prompt_len=prompt,
                              decode_steps=output, device=device,
                              params=weights)
