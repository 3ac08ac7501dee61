"""The dense decoder block: self-attention over a paged KV cache + SwiGLU.

Ports ``repro.models.transformer`` for ``family == "dense"`` in the
``prefill``, ``decode`` and ``chunk`` modes with the paged layout, over a
bf16 (or, for parity runs, fp32) cache or the int8 cache (``kv_quant``).
Attention runs through the hand-written kernels (``repro_torch.kernels``);
the projections and the MLP are plain matrix products, as the reference
leaves them to XLA.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_quant)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.span_attention import (paged_span_attention,
                                                paged_span_attention_quant)
from repro_torch.models.attention import quantize_kv
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
    """One attention block.  Cache leaves: ``{"k", "v"}`` in the model's
    dtype, or with ``kv_quant`` ``{"k", "v"}`` int8 and their bf16 scales
    ``{"ks", "vs"}`` (one per K/V vector).

    prefill: x [B, S, d], positions [S]; causal attention over the
    prompt's own full-precision K/V (the flash kernel); ``cache`` leaves
    [B, S, Kv, hd] ([B, S, Kv] for scales) receive the prompt's K/V, int8
    with ``kv_quant``.
    decode: x [B, d], positions [B], row b's table is block_tables[b].
    chunk: x [T, d] is the packed span (bucket padding duplicates the last
    valid token: same token, position and row, so its duplicate scatter
    writes identical values), positions/seq_idx [T].
    In decode and chunk modes the paged cache ([n_blocks, bs, Kv, hd]
    leaves) is written in place, then attended through the table."""
    if ctx.mode not in ("prefill", "decode", "chunk"):
        raise ValueError(f"unknown mode {ctx.mode!r}")
    if cfg.window:
        raise NotImplementedError(f"sliding-window attention {_NOT_PORTED}")
    if ctx.mode != "prefill" and ctx.block_tables is None:
        raise NotImplementedError(f"the contiguous KV layout {_NOT_PORTED}")
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)                        # [..., H, hd]
    if ctx.mode == "prefill":
        cos = ctx.rope_cos[None, :, None, :]
        sin = ctx.rope_sin[None, :, None, :]
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        # attend the prompt's full-precision K/V; store the cache's form
        o = flash_attention(q, k, v, ctx.positions, kv_block=ctx.kv_block)
        for kk, val in _cache_entries(k, v, ctx.kv_quant).items():
            cache[kk].copy_(val)
        return x + o @ p["wo"]
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
    quant = "ks" in cache
    for kk, val in _cache_entries(k, v, quant).items():
        cache[kk][phys, off] = val
    if quant:
        args = (q, cache["k"], cache["ks"], cache["v"], cache["vs"], tables,
                ctx.positions)
        o = (paged_decode_attention_quant(*args) if ctx.mode == "decode"
             else paged_span_attention_quant(*args, ctx.seq_idx))
    elif ctx.mode == "decode":
        o = paged_decode_attention(q, cache["k"], cache["v"], tables,
                                   ctx.positions)
    else:
        o = paged_span_attention(q, cache["k"], cache["v"], tables,
                                 ctx.positions, ctx.seq_idx)
    return x + o @ p["wo"]


def _cache_entries(k: torch.Tensor, v: torch.Tensor, quant: bool):
    """What the cache stores for K/V: themselves, or their int8 form with
    one bf16 scale per vector (``{k, v, ks, vs}``)."""
    if not quant:
        return {"k": k, "v": v}
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    return {"k": k8, "v": v8, "ks": ks, "vs": vs}


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
