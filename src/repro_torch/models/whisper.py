"""Whisper-style audio encoder-decoder backbone (the ``audio`` family).

Ports ``repro.models.whisper``.  The conv frontend is a stub: the caller
supplies frame embeddings [B, Se, d].  Encoder: non-causal self-attention
blocks without a cache (the non-causal flash kernel).  Decoder: causal
self-attention (its cache is contiguous rows, written in place) +
gated cross-attention to the encoder's output (its K/V cached at
prefill) + a GELU MLP.  Fixed sinusoidal positions on both stacks, no
RoPE.
"""
from __future__ import annotations

from typing import Dict

import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamSpec, rmsnorm
from repro_torch.models.stacked import Ctx, Stack
from repro_torch.models.transformer import (attn_specs, cross_attn_block,
                                            cross_attn_specs,
                                            self_attn_block)


def gelu_mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln": ParamSpec((d,), "ones"),
        "w1": ParamSpec((d, ff)),
        "w2": ParamSpec((ff, d), fan_in=ff),
    }


def gelu_mlp(p, x, cfg: ArchConfig):
    """Residual GELU MLP; ``jax.nn.gelu``'s default is the tanh form."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]


def encoder_stack(cfg: ArchConfig) -> Stack:
    """``cfg.encoder_layers`` groups of {attn, ffn}; run in ``train`` mode
    with no cache."""
    specs = {"attn": attn_specs(cfg), "ffn": gelu_mlp_specs(cfg)}

    def apply(gp, x, ctx: Ctx, cache_g):
        x = self_attn_block(gp["attn"], x, ctx, None, cfg, causal=False,
                            use_rope=False)
        return gelu_mlp(gp["ffn"], x, cfg)

    return Stack(cfg.encoder_layers, specs, apply)


def decoder_stack(cfg: ArchConfig) -> Stack:
    """``cfg.num_layers`` groups of {self, cross, ffn}; each group's cache
    is ``{"self": {k, v}, "cross": {k, v}}``."""
    specs = {"self": attn_specs(cfg), "cross": cross_attn_specs(cfg),
             "ffn": gelu_mlp_specs(cfg)}

    def apply(gp, x, ctx: Ctx, cache_g):
        x = self_attn_block(gp["self"], x, ctx, cache_g["self"], cfg,
                            use_rope=False)
        x = cross_attn_block(gp["cross"], x, ctx, cache_g["cross"], cfg)
        return gelu_mlp(gp["ffn"], x, cfg)

    return Stack(cfg.num_layers, specs, apply)
