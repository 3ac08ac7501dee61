"""whisper-small [audio] — encoder-decoder, conv frontend (stub).

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.  The conv frontend is a
STUB: input_specs() provides precomputed frame embeddings [B, S, d].
Encoder and decoder both use 12 layers (whisper-small).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    head_dim=64,
    encoder_layers=12,
    rope_theta=10_000.0,  # whisper uses learned/sinusoidal pos; we use RoPE-free sinusoid
    source="arXiv:2212.04356; unverified",
)
