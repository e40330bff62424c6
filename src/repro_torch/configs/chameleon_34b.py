"""Chameleon-34B [arXiv:2405.09818]. Copy of ``repro/configs/chameleon_34b.py``.

48L d_model=8192, 64 heads / 8 kv heads, SwiGLU d_ff=22016, vocab 65536.
Early fusion: VQ image tokens live inside the 65536-entry vocabulary, so the
backbone is token-in/token-out — no separate patch frontend is needed
(DESIGN.md §4). qk-norm per the paper.
"""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65_536,
    qk_norm=True,
)
