"""llama4-maverick-400b-a17b [moe] — MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25, expert_d_ff=8192,
                  every=2, shared=True),
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)

# The depth that fits one 80 GB card.  An MoE layer's experts are 3 x 128 x
# 5120 x 8192 bf16 = 32.2 GB, a dense layer ~0.38 GB, the embedding and
# head 2 x 202048 x 5120 bf16 = 4.1 GB: so 4 layers (two groups of a dense
# and an MoE layer) come to ~70 GB, 6 to ~103 GB (over one card), and the
# published 48 to ~800 GB.
ONE_CARD_LAYERS = 4
