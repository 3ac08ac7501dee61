"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks.

48L d_model=2048 4H (kv=4) d_ff=0 (no separate FFN; blocks carry their own
up/down projections) vocab=50304.  Grouping: 48 = 6 groups x (1 sLSTM + 7
mLSTM), matching the paper's mostly-mLSTM [7:1] configuration.
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=512,
    xlstm_group=8,
    xlstm_slstm_per_group=1,
    source="arXiv:2405.04517; unverified",
)
