"""xLSTM-1.3B [arXiv:2405.04517]. Copy of ``repro/configs/xlstm_1_3b.py``.

48 blocks d_model=2048 in a 7:1 mLSTM:sLSTM pattern, 4 heads, d_ff=0
(feed-forward lives inside the blocks: mLSTM pre-up-projection x2, sLSTM
post-FFN x4/3). Runs long_500k: constant-size matrix-memory state.
"""
from repro_torch.configs.arch import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm=XLSTMConfig(num_heads=4, mlstm_proj_factor=2.0,
                      slstm_proj_factor=4.0 / 3.0, mlstm_chunk=64),
)
