"""Mistral-Large-Instruct-2407 (123B) [hf:mistralai/Mistral-Large-Instruct-2407]. Copy of
``repro/configs/mistral_large_123b.py``.

88L d_model=12288, 96 heads / 8 kv heads (head_dim 128), SwiGLU d_ff=28672,
vocab 32768. The largest dense assigned arch.
"""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
)
