"""Plain PyTorch attention oracles over KV caches.

Ports of the reference's jnp oracles (``repro.models.attention``), with
the same dtype casts op for op: scores are contracted in the input dtype
and then taken to fp32, the softmax runs in fp32, and the probabilities
are cast back to the input dtype before the value contraction.  The paged
kernels' plain versions (``repro_torch.kernels``) are built from these;
the kernel wrappers there are the dispatchers (plain version for CPU
tensors, CUDA kernel for CUDA tensors).

Layouts: prefill q [B, S, Hq, hd] with k/v [B, S, Kv, hd]; packed q
[T, Hq, hd]; decode q [B, Hq, hd]; caches [B, S, Kv, hd]; paged caches
[n_blocks, bs, Kv, hd] with block tables [B, nb].  Outputs are
[B, S, Hq*hd] / [T, Hq*hd] / [B, Hq*hd].

The int8 KV cache stores each K/V vector as int8 with one bf16 scale
(``quantize_kv``).  Its oracles contract int8 with int8 exactly, as the
reference's s8 x s8 -> s32 dots do; PyTorch has no integer matrix
product on CUDA, so they contract in float64, which is exact for these
sums (each below 2^53).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def kv_tile(kv_block: int, s: int) -> int:
    """The reference's kv tile over s slots: ``kv_block`` clipped to s and
    halved until it divides s."""
    kv_block = min(kv_block, s)
    while s % kv_block:
        kv_block //= 2
    return kv_block


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0, kv_block: int = 512,
                      q_positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Flash-style causal prefill attention (the reference's
    ``chunked_attention`` with ``causal=True``): kv tiles of ``kv_block``
    with a running fp32 softmax.  q [B, Sq, Hq, hd]; k, v [B, Skv, Kv,
    hd]; query row i sits at ``q_positions[i]`` (default ``i``) and sees
    key j iff ``j <= q_positions[i]`` and ``j > q_positions[i] - window``
    (window > 0).  Returns [B, Sq, Hq*hd]."""
    b, sq, hq, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    g = hq // n_kv
    kv_block = kv_tile(kv_block, skv)
    qg = q.reshape(b, sq, n_kv, g, hd)
    scale = hd ** -0.5
    qpos = (q_positions.long() if q_positions is not None
            else torch.arange(sq, device=q.device))
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for start in range(0, skv, kv_block):
        kblk = k[:, start:start + kv_block]
        vblk = v[:, start:start + kv_block]
        kpos = torch.arange(start, start + kv_block, device=q.device)
        sc = torch.einsum("bsgqd,btgd->bgqst", qg, kblk).float() * scale
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        mn = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - mn[..., None])
        corr = torch.exp(m - mn)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgqst,btgd->bgqsd", p.to(q.dtype), vblk).float()
        m = mn
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, sq, hq * hd)


def gather_paged_cache(cache: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """[n_blocks, bs, ...] physical cache + [B, nb] block table ->
    [B, nb * bs, ...] per-sequence contiguous view: logical slot p of row
    i is ``cache[block_tables[i, p // bs], p % bs]``.  Padded table
    entries gather arbitrary blocks, always position-masked downstream."""
    b, nb = block_tables.shape
    g = cache[block_tables.long()]                   # [B, nb, bs, ...]
    return g.reshape(b, nb * cache.shape[1], *cache.shape[2:])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Single-token attention.  q [B, Hq, hd]; caches [B, S, Kv, hd];
    positions [B] = index of the new token (the cache already holds it);
    slots ``s <= positions[b]`` are visible."""
    b, hq, hd = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = hq // n_kv
    qg = q.reshape(b, n_kv, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bgqd,bsgd->bgqs", qg, k_cache).float() * scale
    idx = torch.arange(s, device=q.device)
    valid = idx[None, :] <= positions.long()[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgqs,bsgd->bgqd", p.to(q.dtype), v_cache)
    return out.reshape(b, hq * hd)


def packed_span_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, positions: torch.Tensor,
                          seq_idx: torch.Tensor, *,
                          kv_block: int = 512) -> torch.Tensor:
    """Ragged multi-token attention over a KV cache (packed chunk layout).

    q [T, Hq, hd]; caches [B, S, Kv, hd] (already holding the span's K/V);
    positions/seq_idx [T].  Cache entry s of row ``seq_idx[t]`` is visible
    to token t iff ``s <= positions[t]``.  The loop streams the cache in
    ``kv_block`` tiles with a running fp32 softmax, as the reference's
    scan does."""
    t, hq, hd = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = hq // n_kv
    kv_block = kv_tile(kv_block, s)
    qg = q.reshape(t, n_kv, g, hd)
    scale = hd ** -0.5
    rows = seq_idx.long()
    pos = positions.long()
    m = torch.full((t, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((t, n_kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((t, n_kv, g, hd), dtype=torch.float32, device=q.device)
    for start in range(0, s, kv_block):
        kt = k_cache[rows, start:start + kv_block]   # [T, kb, Kv, hd]
        vt = v_cache[rows, start:start + kv_block]
        kpos = torch.arange(start, start + kv_block, device=q.device)
        sc = torch.einsum("tngd,tknd->tngk", qg, kt).float() * scale
        mask = kpos[None, :] <= pos[:, None]
        sc = torch.where(mask[:, None, None, :], sc,
                         torch.full_like(sc, NEG_INF))
        mn = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - mn[..., None])
        corr = torch.exp(m - mn)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "tngk,tknd->tngd", p.to(q.dtype), vt).float()
        m = mn
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype).reshape(t, hq * hd)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 quantization along ``axis``: returns (int8 values,
    bf16 scale with ``axis`` reduced).  The values are rounded (half to
    even) against the fp32 scale; the scale returned is that scale rounded
    to bf16, and dequantization multiplies by it."""
    xf = x.float()
    amax = xf.abs().amax(axis)
    # a tensor divisor: PyTorch turns division by a Python scalar into a
    # product with its reciprocal, which is not the reference's division
    scale = amax / torch.full_like(amax, 127.0) + 1e-8
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _int_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An int8 x int8 contraction, exact, as fp32 (the reference's s32
    result taken to fp32)."""
    return torch.einsum(eq, a.double(), b.double()).float()


def decode_attention_quant(q: torch.Tensor, k8: torch.Tensor,
                           ks: torch.Tensor, v8: torch.Tensor,
                           vs: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """Single-token attention over an int8 cache.  q [B, Hq, hd]; k8/v8
    [B, S, Kv, hd] int8; ks/vs [B, S, Kv] bf16; slots ``s <=
    positions[b]`` are visible.  q is quantized per head; the softmax is
    normalized over the whole context, then the probabilities times the V
    scales are quantized with one scale per (row, head) before the AV
    dot."""
    b, hq, hd = q.shape
    s, n_kv = k8.shape[1], k8.shape[2]
    g = hq // n_kv
    q8, qs = quantize_kv(q.reshape(b, n_kv, g, hd))   # [B,Kv,G,hd], [B,Kv,G]
    s32 = _int_dot("bgqd,bsgd->bgqs", q8, k8)
    ks_t = ks.permute(0, 2, 1)[:, :, None, :].float()
    scores = s32 * qs[..., None].float() * ks_t * (hd ** -0.5)
    idx = torch.arange(s, device=q.device)
    valid = idx[None, :] <= positions.long()[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)                   # jax.nn.softmax
    pv = p * vs.permute(0, 2, 1)[:, :, None, :].float()
    p8, ps = quantize_kv(pv)
    out = _int_dot("bgqs,bsgd->bgqd", p8, v8) * ps[..., None].float()
    return out.to(q.dtype).reshape(b, hq * hd)


def _quant_tile_step(q8, qs, kt, vt, kst, vst, kpos, positions, scale,
                     m, l, acc):
    """One kv tile of the int8 span attention (the reference's scan body):
    kt/vt [T, kb, Kv, hd] int8; kst/vst [T, Kv, 1, kb] bf16."""
    sc = _int_dot("tngd,tknd->tngk", q8, kt) * qs[..., None].float() \
        * kst.float() * scale
    mask = kpos[None, :] <= positions.long()[:, None]
    sc = torch.where(mask[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    mn = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - mn[..., None])
    corr = torch.exp(m - mn)
    l = l * corr + p.sum(-1)
    p8, ps = quantize_kv(p * vst.float())     # fold V scales, then requant
    acc = acc * corr[..., None] + \
        _int_dot("tngk,tknd->tngd", p8, vt) * ps[..., None].float()
    return mn, l, acc


def packed_span_attention_quant(q: torch.Tensor, k8: torch.Tensor,
                                ks: torch.Tensor, v8: torch.Tensor,
                                vs: torch.Tensor, positions: torch.Tensor,
                                seq_idx: torch.Tensor, *,
                                kv_block: int = 512) -> torch.Tensor:
    """Packed ragged span attention over an int8 cache.  q [T, Hq, hd];
    k8/v8 [B, S, Kv, hd] int8; ks/vs [B, S, Kv] bf16; positions/seq_idx
    [T].  Both contractions are exact int8 dots with the scales folded in
    outside them; q is quantized per head, the probability rows per kv
    tile of ``kv_block`` slots (clipped and halved until it divides S), so
    the tile width changes the result."""
    t, hq, hd = q.shape
    s, n_kv = k8.shape[1], k8.shape[2]
    g = hq // n_kv
    kv_block = kv_tile(kv_block, s)
    q8, qs = quantize_kv(q.reshape(t, n_kv, g, hd))
    rows = seq_idx.long()
    m = torch.full((t, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((t, n_kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((t, n_kv, g, hd), dtype=torch.float32, device=q.device)
    for start in range(0, s, kv_block):
        sl = slice(start, start + kv_block)
        kst = ks[rows, sl].permute(0, 2, 1)[:, :, None, :]
        vst = vs[rows, sl].permute(0, 2, 1)[:, :, None, :]
        kpos = torch.arange(start, start + kv_block, device=q.device)
        m, l, acc = _quant_tile_step(q8, qs, k8[rows, sl], v8[rows, sl], kst,
                                     vst, kpos, positions, hd ** -0.5,
                                     m, l, acc)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype).reshape(t, hq * hd)


def paged_span_attention_quant(q, k8, ks, v8, vs, block_tables, positions,
                               seq_idx, *, kv_block: int = 512):
    """:func:`packed_span_attention_quant` over a block-paged int8 cache,
    through the gathered view: k8/v8 [n_blocks, bs, Kv, hd]; ks/vs
    [n_blocks, bs, Kv]; block_tables [B, nb]."""
    return packed_span_attention_quant(
        q, gather_paged_cache(k8, block_tables),
        gather_paged_cache(ks, block_tables),
        gather_paged_cache(v8, block_tables),
        gather_paged_cache(vs, block_tables),
        positions, seq_idx, kv_block=kv_block)


def paged_span_attention_quant_native(q, k8, ks, v8, vs, block_tables,
                                      positions, seq_idx, *,
                                      kv_block: int = 512):
    """:func:`paged_span_attention_quant` tile by tile through the block
    table (no gathered view), as the reference engine runs it off the
    TPU; the same numbers.  The tile is ``kv_block`` clipped and halved
    until it divides the table's ``nb * bs`` slots."""
    t, hq, hd = q.shape
    bs, n_kv = k8.shape[1], k8.shape[2]
    s = block_tables.shape[1] * bs
    g = hq // n_kv
    kv_block = kv_tile(kv_block, s)
    q8, qs = quantize_kv(q.reshape(t, n_kv, g, hd))
    tab = block_tables[seq_idx.long()].long()           # [T, nb]
    m = torch.full((t, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((t, n_kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((t, n_kv, g, hd), dtype=torch.float32, device=q.device)
    for start in range(0, s, kv_block):
        kpos = torch.arange(start, start + kv_block, device=q.device)
        blk, off = tab[:, kpos // bs], (kpos % bs)[None, :]
        kst = ks[blk, off].permute(0, 2, 1)[:, :, None, :]
        vst = vs[blk, off].permute(0, 2, 1)[:, :, None, :]
        m, l, acc = _quant_tile_step(q8, qs, k8[blk, off], v8[blk, off], kst,
                                     vst, kpos, positions, hd ** -0.5,
                                     m, l, acc)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype).reshape(t, hq * hd)
