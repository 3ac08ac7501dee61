"""Plain PyTorch attention oracles over KV caches.

Ports of the reference's jnp oracles (``repro.models.attention``), with
the same dtype casts op for op: scores are contracted in the input dtype
and then taken to fp32, the softmax runs in fp32, and the probabilities
are cast back to the input dtype before the value contraction.  The paged
kernels' plain versions (``repro_torch.kernels``) are built from these;
the kernel wrappers there are the dispatchers (plain version for CPU
tensors, CUDA kernel for CUDA tensors).

Layouts: packed q [T, Hq, hd]; decode q [B, Hq, hd]; caches
[B, S, Kv, hd]; paged caches [n_blocks, bs, Kv, hd] with block tables
[B, nb].  Outputs are [T, Hq*hd] / [B, Hq*hd].
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
    kv_block = min(kv_block, s)
    while s % kv_block:
        kv_block //= 2
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
