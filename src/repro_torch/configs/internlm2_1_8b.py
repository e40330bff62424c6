"""InternLM2-1.8B [arXiv:2403.17297; hf]. Copy of ``repro/configs/internlm2_1_8b.py``.

24L d_model=2048, 16 heads / 8 kv heads, SwiGLU d_ff=8192, vocab 92544.
"""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_544,
)
