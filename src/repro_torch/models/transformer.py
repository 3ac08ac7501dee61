"""The dense decoder block: self-attention over a paged KV cache + SwiGLU.

Ports ``repro.models.transformer`` for ``family == "dense"`` in the
``decode`` and ``chunk`` modes with the paged layout.  Attention runs
through the hand-written paged kernels (``repro_torch.kernels``); the
projections and the MLP are plain matrix products, as the reference
leaves them to XLA.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.span_attention import paged_span_attention
from repro_torch.models.common import ParamSpec, apply_rope, rmsnorm
from repro_torch.models.stacked import Ctx, Stack

_NOT_PORTED = "is not ported yet (ROADMAP.md queue 1)"


def attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    return {
        "ln": ParamSpec((d,), "ones"),
        "wq": ParamSpec((d, h * hd)),
        "wk": ParamSpec((d, kvh * hd)),
        "wv": ParamSpec((d, kvh * hd)),
        "wo": ParamSpec((h * hd, d), fan_in=h * hd),
    }


def mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln": ParamSpec((d,), "ones"),
        "w1": ParamSpec((d, ff)),
        "w3": ParamSpec((d, ff)),
        "w2": ParamSpec((ff, d), fan_in=ff),
    }


def _qkv(p, h: torch.Tensor, cfg: ArchConfig):
    hd = cfg.resolved_head_dim
    lead = h.shape[:-1]
    q = (h @ p["wq"]).reshape(*lead, cfg.num_heads, hd)
    k = (h @ p["wk"]).reshape(*lead, cfg.num_kv_heads, hd)
    v = (h @ p["wv"]).reshape(*lead, cfg.num_kv_heads, hd)
    return q, k, v


def self_attn_block(p, x: torch.Tensor, ctx: Ctx, cache,
                    cfg: ArchConfig) -> torch.Tensor:
    """One attention block over the paged cache ``{"k", "v"}``
    ([n_blocks, bs, Kv, hd] each), written in place.

    decode: x [B, d], positions [B], row b's table is block_tables[b].
    chunk: x [T, d] is the packed span (bucket padding duplicates the last
    valid token: same token, position and row, so its duplicate scatter
    writes identical values), positions/seq_idx [T]."""
    if ctx.mode not in ("decode", "chunk"):
        raise NotImplementedError(
            f"{ctx.mode!r} mode (monolithic prefill) {_NOT_PORTED}")
    if ctx.block_tables is None:
        raise NotImplementedError(f"the contiguous KV layout {_NOT_PORTED}")
    if cfg.window:
        raise NotImplementedError(f"sliding-window attention {_NOT_PORTED}")
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)                        # [N, H, hd]
    cos, sin = ctx.rope_cos[:, None, :], ctx.rope_sin[:, None, :]
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    tables = ctx.block_tables
    rows = (ctx.seq_idx if ctx.mode == "chunk"
            else torch.arange(x.shape[0], device=x.device)).long()
    pos = ctx.positions.long()
    bs = cache["k"].shape[1]
    # dirty-slot write-back: only the new tokens' (block, offset) slots
    blk = torch.clamp(pos // bs, max=tables.shape[1] - 1)
    phys = tables[rows, blk].long()
    off = pos % bs
    cache["k"][phys, off] = k
    cache["v"][phys, off] = v
    if ctx.mode == "decode":
        o = paged_decode_attention(q, cache["k"], cache["v"], tables,
                                   ctx.positions)
    else:
        o = paged_span_attention(q, cache["k"], cache["v"], tables,
                                 ctx.positions, ctx.seq_idx)
    return x + o @ p["wo"]


def mlp_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    a = F.silu(h @ p["w1"]) * (h @ p["w3"])
    return x + a @ p["w2"]


def dense_layer_stack(cfg: ArchConfig, n: int) -> Stack:
    """n groups of one dense layer each (the reference's ``moe_every=0``
    layout, group key ``l0``)."""
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE layers {_NOT_PORTED}")
    specs = {"l0": {"attn": attn_specs(cfg), "ffn": mlp_specs(cfg)}}

    def apply(gp, x, ctx: Ctx, cache_g):
        x = self_attn_block(gp["l0"]["attn"], x, ctx, cache_g["l0"], cfg)
        return mlp_block(gp["l0"]["ffn"], x, cfg)

    return Stack(n, specs, apply)
