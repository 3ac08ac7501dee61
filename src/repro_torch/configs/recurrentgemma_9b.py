"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 ratio.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.
Pattern: repeating (rglru, rglru, local-attn) superblocks (Griffin),
38 = 12x3 + 2 trailing recurrent layers.
[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    head_dim=256,
    window=2048,  # local attention window -> bounded cache, sub-quadratic
    block_pattern=("rglru", "rglru", "attn"),
    tail_pattern=("rglru", "rglru"),
    rope_theta=10_000.0,
    source="arXiv:2402.19427; unverified",
)
