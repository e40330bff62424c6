"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427]. Copy of ``repro/configs/recurrentgemma_9b.py``.

38 layers in a (RG-LRU, RG-LRU, local-attn) 2:1 pattern, d_model=4096,
MQA local attention (16 heads, kv=1, head_dim=256) with a 2048 window,
GeGLU d_ff=12288. Runs long_500k: state is O(d) + a bounded window cache.
"""
from repro_torch.configs.arch import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    mlp_act="geglu",
    block_pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, c_exponent=8.0),
    local_window=2048,
    scale_embeddings=True,
    tie_embeddings=True,
)
