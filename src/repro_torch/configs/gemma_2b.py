"""Gemma-2B [arXiv:2403.08295; hf]. Copy of ``repro/configs/gemma_2b.py``.

18L d_model=2048, 8 heads with head_dim=256, MQA (kv=1), GeGLU d_ff=16384,
vocab 256000, tied + sqrt(d)-scaled embeddings.
"""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    mlp_act="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
)
