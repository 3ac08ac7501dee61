"""llama-3.2-vision-90b [vlm] — cross-attention image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Backbone only; the vision tower is a STUB (input_specs() supplies
precomputed patch embeddings).  One cross-attention layer per 4
self-attention layers: 100 = 20 x (4 self + 1 cross).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    head_dim=128,
    cross_attn_every=4,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)

# The depth that fits one 80 GB card.  A layer is ~856M parameters
# (attention 151M + MLP 705M), so a group of 4 self-attention layers and
# 1 cross-attention layer is ~8.6 GB of bf16 weights; 5 groups are ~43 GB
# and the embedding and head add ~4.2 GB, ~47 GB in all, while the
# published 100 layers are ~175 GB.  vlm_stack takes whole groups, so the
# cut is a multiple of 5.
ONE_CARD_LAYERS = 25
