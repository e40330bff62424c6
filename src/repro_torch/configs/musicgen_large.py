"""MusicGen-Large backbone [arXiv:2306.05284; hf]. Copy of ``repro/configs/musicgen_large.py``.

48L d_model=2048, 32 heads MHA, d_ff=8192, per-codebook vocab 2048.
Decoder-only over EnCodec tokens. The EnCodec frontend is a STUB:
input_specs() provides precomputed frame embeddings (4 codebooks already
summed) per the assignment; cross-attention to stub text-conditioning
embeddings is part of the backbone.
"""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="embeddings",
    cross_attention=True,
    cross_seq=64,
    mlp_act="geglu",
)
