"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]. Copy of ``repro/configs/qwen3_moe_30b_a3b.py``.

48L d_model=2048, 32 q heads / 4 kv heads (head_dim 128), qk-norm,
128 routed experts top-8 with d_expert=768, no shared expert.
"""
from repro_torch.configs.arch import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                   # routed expert dim
    vocab_size=151_936,
    qk_norm=True,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768,
                  num_shared_experts=0, capacity_factor=1.25,
                  router_score="softmax"),
    rope_theta=1_000_000.0,
)
