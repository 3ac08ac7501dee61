"""Decoder blocks: self-attention over a paged or contiguous KV cache +
SwiGLU or a sparse MoE FFN (with llama4's shared expert); gated
cross-attention to an encoder's output or to image patches.

Ports ``repro.models.transformer`` for the ``dense`` and ``moe`` families
in the ``prefill``, ``decode`` and ``chunk`` modes with the paged layout
and with contiguous rows, over a bf16 (or, for parity runs, fp32) cache
or the int8 cache
(``kv_quant``), with full attention or a sliding window over a rolling
cache (slot = position % W); and the blocks the whisper family
(``repro_torch.models.whisper``) adds: non-causal, RoPE-free
self-attention without a cache (the encoder, ``train`` mode) and
``cross_attn_block``; and the vlm family's ``vlm_stack``: groups of
self-attention layers over contiguous rows and one cross-attention layer
to the stubbed vision tower's patches.  Attention runs through the hand-written
kernels (``repro_torch.kernels``); the projections, the MLP and the
experts are plain matrix products, as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import (
    contiguous_decode_attention, contiguous_decode_attention_quant,
    contiguous_decode_attention_quant_rolling,
    contiguous_decode_attention_rolling, paged_decode_attention,
    paged_decode_attention_quant, paged_decode_attention_quant_rolling,
    paged_decode_attention_rolling)
from repro_torch.kernels.flash_attention import flash_attention, \
    flash_attention_noncausal
from repro_torch.kernels.span_attention import (
    paged_span_attention, paged_span_attention_quant,
    paged_span_attention_rolling, paged_span_attention_rolling_quant,
    span_attention, span_attention_quant, span_attention_rolling,
    span_attention_rolling_quant)
from repro_torch.models.attention import (fill_rolling_cache,
                                          fill_rolling_cache_ragged,
                                          quantize_kv)
from repro_torch.models.common import ParamSpec, apply_rope, rmsnorm
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.stacked import CacheSpec, Ctx, Stack


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


def cross_attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    """:func:`attn_specs` plus the fp32 ``gate`` (zeros at init: tanh(0)
    = 0 shuts the block until training opens it) and ``ln_kv``, the
    memory's norm."""
    s = attn_specs(cfg)
    s["gate"] = ParamSpec((1,), "zeros", dtype=torch.float32)
    s["ln_kv"] = ParamSpec((cfg.d_model,), "ones")
    return s


def _qkv(p, h: torch.Tensor, cfg: ArchConfig):
    hd = cfg.resolved_head_dim
    lead = h.shape[:-1]
    q = (h @ p["wq"]).reshape(*lead, cfg.num_heads, hd)
    k = (h @ p["wk"]).reshape(*lead, cfg.num_kv_heads, hd)
    v = (h @ p["wv"]).reshape(*lead, cfg.num_kv_heads, hd)
    return q, k, v


def self_attn_block(p, x: torch.Tensor, ctx: Ctx, cache, cfg: ArchConfig,
                    *, causal: bool = True,
                    use_rope: bool = True) -> torch.Tensor:
    """One attention block.  Cache leaves: ``{"k", "v"}`` in the model's
    dtype, or with ``kv_quant`` ``{"k", "v"}`` int8 and their bf16 scales
    ``{"ks", "vs"}`` (one per K/V vector).  With ``cfg.window`` W the
    cache is rolling: position p lives in logical slot p % W.

    prefill: x [B, S, d], positions [S]; causal (windowed) attention over
    the prompt's own full-precision K/V (the flash kernel); ``cache``
    leaves [B, S or W, Kv, hd] ([B, S or W, Kv] for scales) receive the
    prompt's K/V (a rolling cache by ``ctx.seq_lens``), int8 with
    ``kv_quant``.
    train: prefill's forward pass, which writes no cache (``cache``
    None); the whisper encoder runs it with ``causal=False`` (every key
    of the row, no window) and ``use_rope=False``.
    decode: x [B, d], positions [B], row b's table is block_tables[b].
    chunk: x [T, d] is the packed span (bucket padding duplicates the last
    valid token: same token, position and row; only the valid tokens are
    written), positions/seq_idx [T]; ``ctx.n_valid`` the unpadded count
    (None: no padding), and a windowed model also takes
    ``ctx.span_starts`` [B].
    In decode and chunk modes the cache is written in place, only in the
    slots of the new (valid) tokens, and attended: paged ([n_blocks, bs,
    Kv, hd] leaves) through the table, or contiguous ([R, S or W, Kv, hd]
    leaves, ``ctx.block_tables`` None) in the row ``ctx.rows[b]`` of each
    batch row b (``ctx.rows`` None: row b, the reference's gathered rows).
    Written first, except for a rolling chunk, which attends the old cache
    and its own K/V first (its writes would overwrite window entries its
    earlier tokens still need)."""
    if ctx.mode not in ("train", "prefill", "decode", "chunk"):
        raise ValueError(f"unknown mode {ctx.mode!r}")
    w = cfg.window
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)                        # [..., H, hd]
    if ctx.mode in ("train", "prefill"):
        if use_rope:
            cos = ctx.rope_cos[None, :, None, :]
            sin = ctx.rope_sin[None, :, None, :]
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        # attend the prompt's full-precision K/V; store the cache's form
        if not causal:
            o = flash_attention_noncausal(q, k, v, kv_block=ctx.kv_block)
        else:
            o = flash_attention(q, k, v, ctx.positions, window=w,
                                kv_block=min(ctx.kv_block, w) if w
                                else ctx.kv_block)
        if ctx.mode == "train":
            return x + o @ p["wo"]
        if w:
            # a ragged batch fills each row by its own length, so pad-tail
            # K/V never reaches a rolling slot
            if ctx.seq_lens is not None:
                k = fill_rolling_cache_ragged(k, w, ctx.seq_lens)
                v = fill_rolling_cache_ragged(v, w, ctx.seq_lens)
            else:
                k, v = fill_rolling_cache(k, w), fill_rolling_cache(v, w)
        for kk, val in _cache_entries(k, v, ctx.kv_quant).items():
            cache[kk].copy_(val)
        return x + o @ p["wo"]
    if use_rope:
        cos, sin = ctx.rope_cos[:, None, :], ctx.rope_sin[:, None, :]
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if w and ctx.mode == "chunk" and ctx.span_starts is None:
        raise ValueError("a windowed chunk step needs span_starts")
    if ctx.block_tables is None:
        return x + _row_attention(q, k, v, ctx, cache, w) @ p["wo"]
    tables = ctx.block_tables
    rows = (ctx.seq_idx if ctx.mode == "chunk"
            else torch.arange(x.shape[0], device=x.device)).long()
    slot = ctx.positions.long() % w if w else ctx.positions.long()
    bs = cache["k"].shape[1]
    # dirty-slot write-back: only the new tokens' (block, offset) slots
    blk = torch.clamp(slot // bs, max=tables.shape[1] - 1)
    phys = tables[rows, blk].long()
    off = slot % bs
    quant = "ks" in cache
    entries = _cache_entries(k, v, quant)
    n = x.shape[0]
    if ctx.mode == "chunk" and ctx.n_valid is not None and ctx.n_valid < n:
        # bucket padding repeats the last valid token's slot.  After an
        # MoE layer the repeats can hold other values (capacity drops
        # them first), so only the valid tokens are written: the slot
        # holds the real token's K/V, and no scatter index repeats
        phys, off = phys[:ctx.n_valid], off[:ctx.n_valid]
        entries = {kk: val[:ctx.n_valid] for kk, val in entries.items()}
    if w and ctx.mode == "chunk":
        offs = ctx.span_starts[ctx.seq_idx.long()]
        n_valid = x.shape[0] if ctx.n_valid is None else ctx.n_valid
        span = (k, v, tables, ctx.positions, ctx.seq_idx, offs, n_valid)
        o = (paged_span_attention_rolling_quant(
                q, cache["k"], cache["ks"], cache["v"], cache["vs"], *span,
                window=w) if quant else
             paged_span_attention_rolling(q, cache["k"], cache["v"], *span,
                                          window=w))
        for kk, val in entries.items():
            cache[kk][phys, off] = val
        return x + o @ p["wo"]
    for kk, val in entries.items():
        cache[kk][phys, off] = val
    if quant:
        args = (q, cache["k"], cache["ks"], cache["v"], cache["vs"], tables,
                ctx.positions)
        if ctx.mode == "chunk":
            o = paged_span_attention_quant(*args, ctx.seq_idx)
        elif w:
            o = paged_decode_attention_quant_rolling(*args, window=w)
        else:
            o = paged_decode_attention_quant(*args)
    else:
        args = (q, cache["k"], cache["v"], tables, ctx.positions)
        if ctx.mode == "chunk":
            o = paged_span_attention(*args, ctx.seq_idx)
        elif w:
            o = paged_decode_attention_rolling(*args, window=w)
        else:
            o = paged_decode_attention(*args)
    return x + o @ p["wo"]


def _row_attention(q, k, v, ctx: Ctx, cache, w: int) -> torch.Tensor:
    """Decode and chunk attention over contiguous rows (the reference's
    contiguous branches, repro/models/transformer.py:145-167 decode,
    :222-245 rolling chunks, :276-291 full chunks), in place: the
    reference gathers the batch's rows, runs the branch and scatters them
    back; here the kernels read each token's row (``rows[seq_idx]``, or
    ``rows[b]`` in decode) of the whole [R, S, ...] cache and only the new
    tokens' slots are written (slot = position, or position % W for a
    rolling row).  A chunk writes only its ``n_valid`` tokens.  Returns the
    attention output [N, H*hd]."""
    quant = "ks" in cache
    entries = _cache_entries(k, v, quant)
    slot = ctx.positions.long() % w if w else ctx.positions.long()
    n = q.shape[0]
    if ctx.mode == "decode":
        rows = (ctx.rows if ctx.rows is not None else
                torch.arange(n, dtype=torch.int32, device=q.device))
        for kk, val in entries.items():
            cache[kk][rows.long(), slot] = val
        if quant:
            args = (q, cache["k"], cache["ks"], cache["v"], cache["vs"], rows,
                    ctx.positions)
            return (contiguous_decode_attention_quant_rolling(*args, window=w)
                    if w else contiguous_decode_attention_quant(*args))
        args = (q, cache["k"], cache["v"], rows, ctx.positions)
        return (contiguous_decode_attention_rolling(*args, window=w) if w
                else contiguous_decode_attention(*args))
    tok_rows = (ctx.seq_idx if ctx.rows is None
                else ctx.rows[ctx.seq_idx.long()])
    n_valid = n if ctx.n_valid is None else ctx.n_valid
    # bucket padding repeats the last valid token: only the valid tokens
    # are written (see self_attn_block's paged branch)
    dst = (tok_rows[:n_valid].long(), slot[:n_valid])

    def scatter():
        for kk, val in entries.items():
            cache[kk][dst] = val[:n_valid]

    if w:
        span = (k, v, ctx.positions, tok_rows,
                ctx.span_starts[ctx.seq_idx.long()], n_valid)
        o = (span_attention_rolling_quant(
                q, cache["k"], cache["ks"], cache["v"], cache["vs"], *span,
                window=w) if quant else
             span_attention_rolling(q, cache["k"], cache["v"], *span,
                                    window=w))
        scatter()
        return o
    scatter()
    if quant:
        return span_attention_quant(q, cache["k"], cache["ks"], cache["v"],
                                    cache["vs"], ctx.positions, tok_rows)
    return span_attention(q, cache["k"], cache["v"], ctx.positions, tok_rows)


def _cache_entries(k: torch.Tensor, v: torch.Tensor, quant: bool):
    """What the cache stores for K/V: themselves, or their int8 form with
    one bf16 scale per vector (``{k, v, ks, vs}``)."""
    if not quant:
        return {"k": k, "v": v}
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    return {"k": k8, "v": v8, "ks": ks, "vs": vs}


def cross_attn_block(p, x: torch.Tensor, ctx: Ctx, cache,
                     cfg: ArchConfig) -> torch.Tensor:
    """Gated cross-attention to a memory [B, Se, d]: ``ctx.patches`` (the
    vlm family's image patches) when set, else ``ctx.enc_out`` (whisper's
    encoder output); the gate's arithmetic runs in fp32, as in the
    reference.
    prefill (and train): x [B, S, d]; the memory's K/V (after ``ln_kv``)
    through the non-causal flash kernel; in prefill ``cache`` leaves
    ``{"k", "v"}`` [B, Se, Kv, hd] receive them.
    decode: x [B, d] attends every slot of those cached K/V (the
    reference's unmasked ``decode_attention``, through the contiguous
    decode kernel with each row's position at Se - 1)."""
    hd = cfg.resolved_head_dim
    gate = torch.tanh(p["gate"].float())[0]
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(*h.shape[:-1], cfg.num_heads, hd)
    if ctx.mode == "decode":
        b, se = x.shape[0], cache["k"].shape[1]
        rows = torch.arange(b, dtype=torch.int32, device=x.device)
        last = torch.full((b,), se - 1, dtype=torch.int32, device=x.device)
        o = contiguous_decode_attention(q, cache["k"], cache["v"], rows,
                                        last)
    else:
        mem = ctx.patches if ctx.patches is not None else ctx.enc_out
        m = rmsnorm(mem, p["ln_kv"], cfg.norm_eps)
        k = (m @ p["wk"]).reshape(*mem.shape[:-1], cfg.num_kv_heads, hd)
        v = (m @ p["wv"]).reshape(*mem.shape[:-1], cfg.num_kv_heads, hd)
        o = flash_attention_noncausal(q, k, v, kv_block=ctx.kv_block)
        if ctx.mode == "prefill":
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    return x + (gate * (o @ p["wo"]).float()).to(x.dtype)


def mlp_block(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    a = F.silu(h @ p["w1"]) * (h @ p["w3"])
    return x + a @ p["w2"]


def moe_block(p, x: torch.Tensor, cfg: ArchConfig, *,
              fuse_shared: bool = False) -> torch.Tensor:
    """Residual sparse-MoE FFN.  x [B, S, d] (prefill) or [N, d] (decode
    rows, packed chunk tokens): every row is routed, padding included.  A
    shared expert (``shared_w1/w3/w2``, llama4) runs beside the routed
    ones: as a separate dense branch added to their output (the
    reference's baseline), or, with ``fuse_shared``, inside
    :func:`moe_local`, added to the routed sum before its final cast."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    squeeze = h.dim() == 2
    h3 = h[:, None, :] if squeeze else h
    has_shared = "shared_w1" in p
    if has_shared and fuse_shared:
        shared = {"w1": p["shared_w1"], "w3": p["shared_w3"],
                  "w2": p["shared_w2"]}
        y = moe_ffn(h3, p["moe"], cfg.moe, shared=shared)
    else:
        y = moe_ffn(h3, p["moe"], cfg.moe)
        if has_shared:
            a = F.silu(h3 @ p["shared_w1"]) * (h3 @ p["shared_w3"])
            y = y + a @ p["shared_w2"]
    return x + (y[:, 0, :] if squeeze else y)


def dense_layer_stack(cfg: ArchConfig, n: int, *, moe_every: int = 0) -> Stack:
    """n groups; each group is ``moe_every`` layers whose last one is MoE
    (``moe_every=0``: one layer per group, MoE iff the config has experts),
    keyed ``l0, l1, ...``, as in the reference."""
    per = max(moe_every, 1)
    kinds = tuple("moe" if cfg.moe is not None and i == per - 1 else "mlp"
                  for i in range(per))
    specs = {}
    for i, kind in enumerate(kinds):
        if kind == "moe":
            ffn = {"ln": ParamSpec((cfg.d_model,), "ones"),
                   "moe": moe_specs(cfg.d_model, cfg.moe)}
            if cfg.moe.shared:
                ff = cfg.moe.expert_d_ff or cfg.d_ff
                ffn.update(shared_w1=ParamSpec((cfg.d_model, ff)),
                           shared_w3=ParamSpec((cfg.d_model, ff)),
                           shared_w2=ParamSpec((ff, cfg.d_model), fan_in=ff))
        else:
            ffn = mlp_specs(cfg)
        specs[f"l{i}"] = {"attn": attn_specs(cfg), "ffn": ffn}

    def apply(gp, x, ctx: Ctx, cache_g):
        for i, kind in enumerate(kinds):
            lp = gp[f"l{i}"]
            x = self_attn_block(lp["attn"], x, ctx, cache_g[f"l{i}"], cfg)
            x = (moe_block(lp["ffn"], x, cfg,
                           fuse_shared=ctx.fuse_shared_expert)
                 if kind == "moe" else mlp_block(lp["ffn"], x, cfg))
        return x

    return Stack(n, specs, apply)


def self_cache_spec(cfg: ArchConfig, batch: int, cache_len: int,
                    dtype) -> Dict[str, CacheSpec]:
    """One attention layer's contiguous cache rows ``{"k", "v"}`` [B, S,
    Kv, hd]: S = ``cache_len``, or W for a windowed model (a rolling row
    is exactly W slots, as the decode indexes slots by position % W)."""
    leaf = CacheSpec((batch, cfg.window or cache_len, cfg.num_kv_heads,
                      cfg.resolved_head_dim), dtype)
    return {"k": leaf, "v": leaf}


def vlm_stack(cfg: ArchConfig) -> Stack:
    """Groups of ``cross_attn_every`` self-attention layers (``self<i>``,
    each {attn, ffn}) and one gated cross-attention layer (``cross``) to
    the image patches; each group's cache is ``{"self<i>": {k, v},
    "cross": {k, v}}``, the cross leaves [B, cfg_n_patches, Kv, hd]."""
    per = cfg.cross_attn_every
    n = cfg.num_layers // (per + 1)
    if n * (per + 1) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: a vlm's layer count must be a "
                         f"multiple of cross_attn_every + 1 = {per + 1}")
    specs = {f"self{i}": {"attn": attn_specs(cfg), "ffn": mlp_specs(cfg)}
             for i in range(per)}
    specs["cross"] = {"attn": cross_attn_specs(cfg), "ffn": mlp_specs(cfg)}

    def apply(gp, x, ctx: Ctx, cache_g):
        for i in range(per):
            lp = gp[f"self{i}"]
            x = self_attn_block(lp["attn"], x, ctx, cache_g[f"self{i}"], cfg)
            x = mlp_block(lp["ffn"], x, cfg)
        x = cross_attn_block(gp["cross"]["attn"], x, ctx, cache_g["cross"],
                             cfg)
        return mlp_block(gp["cross"]["ffn"], x, cfg)

    def cache_spec(batch: int, cache_len: int, dtype):
        c = {f"self{i}": self_cache_spec(cfg, batch, cache_len, dtype)
             for i in range(per)}
        leaf = CacheSpec((batch, cfg_n_patches(cfg), cfg.num_kv_heads,
                          cfg.resolved_head_dim), dtype)
        c["cross"] = {"k": leaf, "v": leaf}
        return c

    return Stack(n, specs, apply, cache_spec)


def cfg_n_patches(cfg: ArchConfig) -> int:
    """Stubbed vision frontend: 4 tiles x 40x40 patches = 6400."""
    return 6400
