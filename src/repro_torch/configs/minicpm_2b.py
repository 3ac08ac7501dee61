"""minicpm-2b [dense] — llama-like arch trained with the WSD schedule.

40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753.
[arXiv:2404.06395; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    rope_theta=10_000.0,
    source="arXiv:2404.06395; hf",
)
