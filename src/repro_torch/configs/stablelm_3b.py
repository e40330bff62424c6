"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family]. Copy of
``repro/configs/stablelm_3b.py``.

32L d_model=2560, 32 heads MHA (kv=32, head_dim 80), SwiGLU d_ff=6912,
vocab 50304.
"""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
)
