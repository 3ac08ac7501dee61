"""Architecture configuration for the port.

A copy of the reference package's ``ArchConfig`` and ``reduced()``: configs
are pure data, and the port keeps its own copy so that it imports nothing
of the JAX package.  Model construction lives in :mod:`repro_torch.models`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (sparse FFN)."""

    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # d_ff of each expert (falls back to ArchConfig.d_ff when 0)
    expert_d_ff: int = 0
    # MoE every Nth layer (llama4 maverick alternates dense/MoE: every=2)
    every: int = 1
    # llama4-style shared expert computed alongside the routed ones
    shared: bool = False


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A single architecture's exact published configuration.

    ``family`` selects the model builder:
      dense   — standard decoder-only transformer (GQA, SwiGLU)
      moe     — decoder-only transformer with sparse-MoE FFN
      hybrid  — RG-LRU recurrent blocks + local attention (RecurrentGemma)
      ssm     — xLSTM (sLSTM + mLSTM blocks)
      vlm     — decoder-only text backbone with interleaved cross-attention
                to (stubbed) image patch embeddings
      audio   — encoder-decoder (Whisper) with stubbed conv frontend
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                      # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    # Sliding/local attention window (0 = full attention).  Mixtral uses a
    # sliding window; RecurrentGemma uses local attention in its hybrid mix.
    window: int = 0
    # hybrid: per-superblock layer pattern, e.g. ("rglru", "rglru", "attn").
    block_pattern: Tuple[str, ...] = ()
    # number of trailing layers appended after the scanned superblocks
    # (for layer counts not divisible by the pattern length)
    tail_pattern: Tuple[str, ...] = ()
    # vlm: one cross-attention layer every `cross_attn_every` self-attn layers
    cross_attn_every: int = 0
    # audio: encoder depth (decoder uses num_layers)
    encoder_layers: int = 0
    # ssm (xLSTM): index pattern of sLSTM blocks within a group of
    # ``xlstm_group`` blocks; remaining blocks are mLSTM.
    xlstm_group: int = 0
    xlstm_slstm_per_group: int = 0

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_position: int = 1 << 20

    # provenance (public-literature source + verification tier)
    source: str = ""

    # --- derived ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.family == "audio"

    @property
    def sub_quadratic(self) -> bool:
        """True when a 500k-token decode is feasible (bounded state)."""
        if self.family in ("hybrid", "ssm"):
            return True
        return self.window > 0  # sliding-window attention bounds the cache

    def padded_heads(self, tp: int) -> int:
        """Q-heads padded up so attention heads shard over ``tp`` devices.

        Padding adds zero-weight heads (documented compute overhead for
        archs whose head count does not divide the TP degree).
        """
        return int(math.ceil(self.num_heads / tp) * tp)

    def padded_kv_heads(self, tp: int) -> int:
        """KV heads shard only when divisible; otherwise replicate (GQA
        replication, the standard choice when tp > n_kv)."""
        if self.num_kv_heads % tp == 0:
            return self.num_kv_heads
        return self.num_kv_heads  # replicated, never padded

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        moe = kw.pop("moe")
        kw.update(
            num_layers=max(4, len(self.block_pattern) + len(self.tail_pattern)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            window=min(self.window, 32) if self.window else 0,
            max_position=4096,
        )
        if self.family == "hybrid":
            kw["num_layers"] = len(self.block_pattern) * 2 + len(self.tail_pattern)
        if self.family == "ssm":
            kw["num_layers"] = self.xlstm_group or 4
            kw["num_heads"] = 2
            kw["num_kv_heads"] = 2
            kw["head_dim"] = 32
        if self.family == "vlm":
            kw["num_layers"] = (self.cross_attn_every + 1) * 2
        if self.family == "audio":
            kw["encoder_layers"] = 2
        if moe is not None:
            kw["moe"] = MoEConfig(num_experts=4, top_k=moe["top_k"], capacity_factor=2.0,
                                  expert_d_ff=kw["d_ff"], every=moe["every"],
                                  shared=moe["shared"])
            kw["num_layers"] = 2 * moe["every"]
        kw["name"] = self.name + "-smoke"
        return ArchConfig(**kw)
