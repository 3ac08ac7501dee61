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
import torch.nn.functional as F

NEG_INF = -1e30


def kv_tile(kv_block: int, s: int) -> int:
    """The reference's kv tile over s slots: ``kv_block`` clipped to s and
    halved until it divides s."""
    kv_block = min(kv_block, s)
    while s % kv_block:
        kv_block //= 2
    return kv_block


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      kv_block: int = 512,
                      q_positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Flash-style prefill attention (the reference's ``chunked_attention``):
    kv tiles of ``kv_block`` (clipped and halved until it divides Skv)
    with a running fp32 softmax.  q [B, Sq, Hq, hd]; k, v [B, Skv, Kv,
    hd]; query row i sits at ``q_positions[i]`` (default ``i``) and sees
    key j iff ``j <= q_positions[i]`` (``causal``) and ``j >
    q_positions[i] - window`` (window > 0); with neither, every key.
    Returns [B, Sq, Hq*hd]."""
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
        mask = torch.ones((sq, kv_block), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
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


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_block: int = 512) -> torch.Tensor:
    """Non-causal attention to a fixed memory (the encoder's output):
    :func:`chunked_attention` with ``causal=False``."""
    return chunked_attention(q, k, v, causal=False, kv_block=kv_block)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, q_block: int = 512) -> torch.Tensor:
    """Banded causal prefill attention (the reference's windowed prefill,
    ``local_attention``): query block i attends the ``window + q_block``
    keys before its end.  q [B, S, Hq, hd]; k, v [B, S, Kv, hd]; query
    row i sits at position i and sees key j iff ``i - window < j <= i``.
    ``q_block`` is halved until it divides S.  As in the reference, the
    scores and the unnormalised probabilities stay in the input dtype
    (masked with -3e38 in bf16) and only the softmax statistics are fp32.
    Returns [B, S, Hq*hd]."""
    b, sq, hq, hd = q.shape
    n_kv = k.shape[2]
    g = hq // n_kv
    q_block = min(q_block, sq)
    while sq % q_block:
        q_block //= 2
    span = window + q_block
    qg = q.reshape(b, sq // q_block, q_block, n_kv, g, hd)
    pad = (0, 0, 0, 0, window, 0)                    # window keys on the left
    kp, vp = F.pad(k, pad), F.pad(v, pad)
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype)
    fill = -3e38 if q.dtype == torch.bfloat16 else NEG_INF
    outs = []
    for i in range(sq // q_block):
        start = i * q_block          # padded coords: keys [start - window, start + q_block)
        kblk, vblk = kp[:, start:start + span], vp[:, start:start + span]
        qpos = start + torch.arange(q_block, device=q.device)
        kpos = start - window + torch.arange(span, device=q.device)
        s = torch.einsum("bsgqd,btgd->bgqst", qg[:, i], kblk) * scale
        mask = (qpos[:, None] >= kpos[None, :]) \
            & (kpos[None, :] > qpos[:, None] - window) & (kpos[None, :] >= 0)
        s = torch.where(mask, s, torch.full_like(s, fill))
        m = s.amax(-1, keepdim=True).float()
        p = torch.exp(s.float() - m).to(q.dtype)
        l = p.float().sum(-1)
        o = torch.einsum("bgqst,btgd->bgqsd", p, vblk)
        outs.append((o.float() / torch.clamp(l, min=1e-30)[..., None])
                    .to(q.dtype))
    out = torch.stack(outs)                       # [nq, B, Kv, G, qb, hd]
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, hq * hd)


def fill_rolling_cache(k: torch.Tensor, window: int) -> torch.Tensor:
    """Prefill K/V [B, S, Kv, hd] of an unpadded batch -> a rolling cache
    [B, W, Kv, hd] under slot = position % W (zeros past S < W)."""
    s = k.shape[1]
    if s < window:
        return F.pad(k, (0, 0, 0, 0, 0, window - s))
    tail = k[:, s - window:]
    shift = s % window
    return torch.roll(tail, shift, dims=1) if shift else tail


def fill_rolling_cache_ragged(k: torch.Tensor, window: int,
                              lengths: torch.Tensor) -> torch.Tensor:
    """:func:`fill_rolling_cache` of a right-padded batch with real
    lengths [B]: slot s of row i holds the row's last position congruent
    to s mod W, ``L-1 - ((L-1 - s) mod W)``; slots whose position is
    negative are zero, so pad-tail K/V never reaches the cache."""
    b, s = k.shape[0], k.shape[1]
    slots = torch.arange(window, device=k.device)
    last = lengths.long()[:, None] - 1
    stored = last - torch.remainder(last - slots[None, :], window)   # [B, W]
    out = k[torch.arange(b, device=k.device)[:, None],
            torch.clamp(stored, 0, s - 1)]
    return torch.where((stored >= 0)[..., None, None], out,
                       torch.zeros_like(out))


def gather_paged_cache(cache: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """[n_blocks, bs, ...] physical cache + [B, nb] block table ->
    [B, nb * bs, ...] per-sequence contiguous view: logical slot p of row
    i is ``cache[block_tables[i, p // bs], p % bs]``.  Padded table
    entries gather arbitrary blocks, always position-masked downstream."""
    b, nb = block_tables.shape
    g = cache[block_tables.long()]                   # [B, nb, bs, ...]
    return g.reshape(b, nb * cache.shape[1], *cache.shape[2:])


def _decode_valid(s: int, positions: torch.Tensor,
                  rolling_window: int) -> torch.Tensor:
    """[B, S] visible slots of a decode step: ``s <= positions[b]``, or
    for a rolling cache (slot = pos % W) ``s < min(positions[b] + 1, W)``."""
    idx = torch.arange(s, device=positions.device)[None, :]
    pos = positions.long()[:, None]
    if rolling_window:
        return idx < torch.clamp(pos + 1, max=rolling_window)
    return idx <= pos


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor, *,
                     rolling_window: int = 0) -> torch.Tensor:
    """Single-token attention.  q [B, Hq, hd]; caches [B, S, Kv, hd];
    positions [B] = index of the new token (the cache already holds it);
    slots ``s <= positions[b]`` are visible, or with ``rolling_window``
    (a rolling cache) the first ``min(positions[b] + 1, W)`` slots."""
    b, hq, hd = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = hq // n_kv
    qg = q.reshape(b, n_kv, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bgqd,bsgd->bgqs", qg, k_cache).float() * scale
    valid = _decode_valid(s, positions, rolling_window)
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
    m = torch.full((t, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((t, n_kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((t, n_kv, g, hd), dtype=torch.float32, device=q.device)
    for start in range(0, s, kv_block):
        kt = k_cache[rows, start:start + kv_block]   # [T, kb, Kv, hd]
        vt = v_cache[rows, start:start + kv_block]
        kpos = torch.arange(start, start + kv_block, device=q.device)
        sc = torch.einsum("tngd,tknd->tngk", qg, kt).float() * scale
        m, l, acc = _online_step(sc, _causal(kpos, positions), lambda p: (
            torch.einsum("tngk,tknd->tngd", p.to(q.dtype), vt).float()),
            m, l, acc)
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


def decode_quant_pv(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                    vs: torch.Tensor, positions: torch.Tensor, *,
                    rolling_window: int = 0):
    """The probabilities times the V scales of :func:`decode_attention_quant`
    before their quantization, pv [B, Kv, G, S] fp32, and the visible slots
    [B, S].  q is quantized per head; the softmax is normalized over the
    whole context."""
    b, hq, hd = q.shape
    s, n_kv = k8.shape[1], k8.shape[2]
    g = hq // n_kv
    q8, qs = quantize_kv(q.reshape(b, n_kv, g, hd))   # [B,Kv,G,hd], [B,Kv,G]
    s32 = _int_dot("bgqd,bsgd->bgqs", q8, k8)
    ks_t = ks.permute(0, 2, 1)[:, :, None, :].float()
    scores = s32 * qs[..., None].float() * ks_t * (hd ** -0.5)
    valid = _decode_valid(s, positions, rolling_window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)                   # jax.nn.softmax
    return p * vs.permute(0, 2, 1)[:, :, None, :].float(), valid


def decode_attention_quant(q: torch.Tensor, k8: torch.Tensor,
                           ks: torch.Tensor, v8: torch.Tensor,
                           vs: torch.Tensor, positions: torch.Tensor, *,
                           rolling_window: int = 0) -> torch.Tensor:
    """Single-token attention over an int8 cache.  q [B, Hq, hd]; k8/v8
    [B, S, Kv, hd] int8; ks/vs [B, S, Kv] bf16; visible slots as in
    :func:`decode_attention`.  q is quantized per head; the softmax is
    normalized over the whole context, then the probabilities times the V
    scales are quantized with one scale per (row, head) before the AV
    dot."""
    b, hq, hd = q.shape
    pv, _ = decode_quant_pv(q, k8, ks, vs, positions,
                            rolling_window=rolling_window)
    p8, ps = quantize_kv(pv)
    out = _int_dot("bgqs,bsgd->bgqd", p8, v8) * ps[..., None].float()
    return out.to(q.dtype).reshape(b, hq * hd)


def _causal(kpos: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """[T, kb] mask: slot ``kpos[k]`` is visible to token t iff it is at
    or before ``positions[t]``."""
    return kpos[None, :] <= positions.long()[:, None]


def _quant_tile_step(q8, qs, kt, vt, kst, vst, mask, scale, m, l, acc):
    """One kv tile of the int8 span attention (the reference's scan body):
    kt/vt [T, kb, Kv, hd] int8; kst/vst [T, Kv, 1, kb] bf16; mask [T, kb]
    the visible slots."""
    sc = _int_dot("tngd,tknd->tngk", q8, kt) * qs[..., None].float() \
        * kst.float() * scale
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
                                     vst, _causal(kpos, positions),
                                     hd ** -0.5, m, l, acc)
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
                                     vst, _causal(kpos, positions),
                                     hd ** -0.5, m, l, acc)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype).reshape(t, hq * hd)


# ---------------------------------------------------------------------------
# Rolling caches (sliding-window models): slot = position % W
# ---------------------------------------------------------------------------

def _rolling_mask(slot: torch.Tensor, offsets: torch.Tensor,
                  positions: torch.Tensor, w_slots: int,
                  window: int) -> torch.Tensor:
    """[T, kb] visible slots of the old rolling cache.  A row whose cache
    holds positions [0, off) stores ``off-1 - ((off-1 - s) mod w_slots)``
    in slot s; it is visible to token t iff it exists (off >= 1, stored
    >= 0) and lies inside t's window."""
    off = offsets.long()[:, None]
    stored = off - 1 - torch.remainder(off - 1 - slot[None, :], w_slots)
    return (off >= 1) & (stored >= 0) \
        & (stored > positions.long()[:, None] - window)


def _span_mask(positions, seq_idx, n_valid, window) -> torch.Tensor:
    """[T, T] visible fresh span entries: same row, causal, inside the
    window, and not bucket padding (``u < n_valid``; padding duplicates the
    last valid token, which would otherwise count twice)."""
    pos, seq = positions.long(), seq_idx.long()
    t = pos.shape[0]
    return (seq[None, :] == seq[:, None]) & (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - window) \
        & (torch.arange(t, device=pos.device)[None, :] < n_valid)


def _online_step(sc, mask, p_v, m, l, acc):
    """Fold one source's fp32 scores sc [T, Kv, G, k] (mask [T, k]) into
    the running softmax; ``p_v(p)`` contracts the probabilities with the
    source's values."""
    sc = torch.where(mask[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    mn = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - mn[..., None])
    corr = torch.exp(m - mn)
    l = l * corr + p.sum(-1)
    return mn, l, acc * corr[..., None] + p_v(p)


def _rolling(q, fetch, w_slots, k_span, v_span, positions, seq_idx, offsets,
             n_valid, *, window, kv_block, quant):
    """Two-source windowed span attention (the reference's
    ``packed_span_attention_rolling{,_quant}`` scan): the old rolling cache
    in kv tiles of ``kv_block`` slots (clipped and halved until it divides
    ``w_slots``), then the span's own fresh K/V, under one running fp32
    softmax.  ``fetch(slot)`` returns the tile's [T, kb, Kv, hd] K and V
    (and, ``quant``, their [T, kb, Kv] scales) for the slots ``slot``."""
    t, hq, hd = q.shape
    n_kv = k_span.shape[1]
    g = hq // n_kv
    kv_block = kv_tile(kv_block, w_slots)
    qg = q.reshape(t, n_kv, g, hd)
    scale = hd ** -0.5
    if quant:
        q8, qs = quantize_kv(qg)
    m = torch.full((t, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((t, n_kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((t, n_kv, g, hd), dtype=torch.float32, device=q.device)
    for start in range(0, w_slots, kv_block):
        slot = torch.arange(start, start + kv_block, device=q.device)
        mask = _rolling_mask(slot, offsets, positions, w_slots, window)
        if quant:
            kt, vt, kst, vst = fetch(slot)
            m, l, acc = _quant_tile_step(
                q8, qs, kt, vt, kst.permute(0, 2, 1)[:, :, None, :],
                vst.permute(0, 2, 1)[:, :, None, :], mask, scale, m, l, acc)
            continue
        kt, vt = fetch(slot)
        sc = torch.einsum("tngd,tknd->tngk", qg, kt).float() * scale
        m, l, acc = _online_step(sc, mask, lambda p: torch.einsum(
            "tngk,tknd->tngd", p.to(q.dtype), vt).float(), m, l, acc)
    # the span's fresh K/V keeps full-precision dots, int8 cache or not
    sc = torch.einsum("tngd,und->tngu", qg, k_span).float() * scale
    m, l, acc = _online_step(
        sc, _span_mask(positions, seq_idx, n_valid, window),
        lambda p: torch.einsum("tngu,und->tngd", p.to(q.dtype),
                               v_span).float(), m, l, acc)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype).reshape(t, hq * hd)


def packed_span_attention_rolling(q, k_cache, v_cache, k_span, v_span,
                                  positions, seq_idx, offsets, n_valid, *,
                                  window: int, kv_block: int = 512):
    """Packed span attention over rolling caches [B, W, Kv, hd] (old
    contents: row r holds its positions [0, offsets) at slots pos % W)
    plus the span's own fresh K/V [T, Kv, hd].  positions/seq_idx/offsets
    [T] (offsets: each token's row span start); ``n_valid`` the unpadded
    token count.  Attend first: the caller scatters the span afterwards.
    Returns [T, Hq*hd]."""
    rows = seq_idx.long()[:, None]
    return _rolling(
        q, lambda slot: (k_cache[rows, slot], v_cache[rows, slot]),
        k_cache.shape[1], k_span, v_span, positions, seq_idx, offsets,
        n_valid, window=window, kv_block=kv_block, quant=False)


def packed_span_attention_rolling_quant(q, k8, ks, v8, vs, k_span, v_span,
                                        positions, seq_idx, offsets, n_valid,
                                        *, window: int, kv_block: int = 512):
    """:func:`packed_span_attention_rolling` with an int8 old cache (k8/v8
    [B, W, Kv, hd], scales ks/vs [B, W, Kv]): exact int8 dots with q and
    the probabilities quantized per kv tile; the fresh bf16 span keeps
    full-precision dots."""
    rows = seq_idx.long()[:, None]
    return _rolling(
        q, lambda slot: (k8[rows, slot], v8[rows, slot], ks[rows, slot],
                         vs[rows, slot]),
        k8.shape[1], k_span, v_span, positions, seq_idx, offsets, n_valid,
        window=window, kv_block=kv_block, quant=True)


def paged_span_attention_rolling(q, k_cache, v_cache, k_span, v_span,
                                 block_tables, positions, seq_idx, offsets,
                                 n_valid, *, window: int,
                                 kv_block: int = 512):
    """:func:`packed_span_attention_rolling` over a block-paged rolling
    cache [n_blocks, bs, Kv, hd], through the gathered [B, nb * bs] view:
    the stored positions are rebuilt against the table's width nb * bs,
    which is W once a row has wrapped."""
    g = lambda c: gather_paged_cache(c, block_tables)
    return packed_span_attention_rolling(
        q, g(k_cache), g(v_cache), k_span, v_span, positions, seq_idx,
        offsets, n_valid, window=window, kv_block=kv_block)


def paged_span_attention_rolling_quant(q, k8, ks, v8, vs, k_span, v_span,
                                       block_tables, positions, seq_idx,
                                       offsets, n_valid, *, window: int,
                                       kv_block: int = 512):
    """:func:`packed_span_attention_rolling_quant` over a block-paged int8
    rolling cache, through the gathered view."""
    g = lambda c: gather_paged_cache(c, block_tables)
    return packed_span_attention_rolling_quant(
        q, g(k8), g(ks), g(v8), g(vs), k_span, v_span, positions, seq_idx,
        offsets, n_valid, window=window, kv_block=kv_block)


def _table_fetch(block_tables, seq_idx, bs, *caches):
    """A tile fetch straight through the block table (no gathered view):
    logical slot p of token t is ``cache[table[seq_idx[t], p // bs],
    p % bs]``."""
    tab = block_tables[seq_idx.long()].long()            # [T, nb]

    def fetch(slot):
        blk, off = tab[:, slot // bs], (slot % bs)[None, :]
        return tuple(c[blk, off] for c in caches)
    return fetch


def paged_span_attention_rolling_native(q, k_cache, v_cache, k_span, v_span,
                                        block_tables, positions, seq_idx,
                                        offsets, n_valid, *, window: int,
                                        kv_block: int = 512):
    """:func:`paged_span_attention_rolling` tile by tile through the block
    table, as the reference engine runs it off the TPU; the same
    numbers."""
    bs = k_cache.shape[1]
    return _rolling(
        q, _table_fetch(block_tables, seq_idx, bs, k_cache, v_cache),
        block_tables.shape[1] * bs, k_span, v_span, positions, seq_idx,
        offsets, n_valid, window=window, kv_block=kv_block, quant=False)


def paged_span_attention_rolling_quant_native(q, k8, ks, v8, vs, k_span,
                                              v_span, block_tables, positions,
                                              seq_idx, offsets, n_valid, *,
                                              window: int,
                                              kv_block: int = 512):
    """:func:`paged_span_attention_rolling_quant` through the block table;
    the same numbers."""
    bs = k8.shape[1]
    return _rolling(
        q, _table_fetch(block_tables, seq_idx, bs, k8, v8, ks, vs),
        block_tables.shape[1] * bs, k_span, v_span, positions, seq_idx,
        offsets, n_valid, window=window, kv_block=kv_block, quant=True)
