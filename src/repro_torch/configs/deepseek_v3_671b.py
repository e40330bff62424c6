"""DeepSeek-V3 671B [arXiv:2412.19437; hf]. Copy of ``repro/configs/deepseek_v3_671b.py``.

61L d_model=7168, MLA with 128 heads, MoE: first 3 layers dense (d_ff=18432),
then 1 shared + 256 routed experts (top-8, d_expert=2048). MTP available as a
config flag (off for dry-runs; see DESIGN.md). The assigned table's d_ff=2048
is the routed-expert dim; kv=128 reflects MLA's per-head latent heads.
"""
from repro_torch.configs.arch import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,                  # routed expert dim
    dense_d_ff=18432,           # first-3 dense layers
    vocab_size=129_280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                  num_shared_experts=1, capacity_factor=1.25,
                  router_score="sigmoid"),
    moe_dense_first=3,
    rope_theta=10_000.0,
    mtp=False,
    notes="MLA latent cache (c_kv=512 + k_rope=64) makes decode_32k cache ~18x "
          "smaller than GQA-equivalent; decode uses absorbed-weight MLA.",
)
