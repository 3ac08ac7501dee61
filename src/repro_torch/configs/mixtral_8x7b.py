"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25, expert_d_ff=14336),
    window=4096,  # SWA: bounds the decode KV cache -> sub-quadratic
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
)

# The depth that fits one 80 GB card: a layer is ~2.9 GB of bf16 weights,
# so the published 32 (~93 GB) do not fit, and 16 (~47 GB) leave room for
# the KV pool and a monolithic MoE prefill's transients.
ONE_CARD_LAYERS = 16
