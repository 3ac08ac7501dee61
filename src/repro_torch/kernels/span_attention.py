"""Paged packed span attention (the chunked-prefill step's attention).

CUDA kernel: ``csrc/paged_span_attention.cu``, which replaces the TPU
kernel ``repro/kernels/span_attention.py:611`` (``paged_span_attention``).
It is memory-bound: the least it must move is each row's K/V prefix once,
plus q and the output.  Its design (one block per token and kv head,
shared-memory tiles, fp32 online softmax) is described in
``csrc/paged_attention.cuh``.

Plain version: :func:`paged_span_attention_plain`, the reference oracle's
gather-then-attend (``repro.models.attention.paged_span_attention``) with
its dtype casts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _paged
from repro_torch.models.attention import (gather_paged_cache,
                                          packed_span_attention)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    return _build.load("paged_span_attention", "paged_span_attention",
                       [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P])


def paged_span_attention_plain(q, k_cache, v_cache, block_tables, positions,
                               seq_idx, *, kv_block: int = 512):
    """q [T, H, hd]; caches [n_blocks, bs, Kv, hd]; block_tables [B, nb];
    positions/seq_idx [T] -> [T, H*hd]."""
    k = gather_paged_cache(k_cache, block_tables)
    v = gather_paged_cache(v_cache, block_tables)
    return packed_span_attention(q, k, v, positions, seq_idx,
                                 kv_block=kv_block)


def paged_span_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, block_tables: torch.Tensor,
                         positions: torch.Tensor, seq_idx: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """Token t attends to slots ``0..positions[t]`` of table row
    ``seq_idx[t]``.  q [T, H, hd]; caches [n_blocks, bs, Kv, hd];
    block_tables [B, nb] int32; positions/seq_idx [T] int32 ->
    [T, H*hd].  CPU tensors take the plain version; CUDA tensors launch
    the kernel (bf16 only)."""
    if window:
        raise NotImplementedError(
            "sliding-window span attention is not ported yet "
            "(ROADMAP.md queue 2: paged_span_attention_rolling)")
    _paged.check(q, k_cache, v_cache, block_tables,
                 {"positions": positions, "seq_idx": seq_idx})
    if q.device.type == "cpu":
        return paged_span_attention_plain(q, k_cache, v_cache, block_tables,
                                          positions, seq_idx)
    t, h, hd = q.shape
    n_blocks, bs, kv = k_cache.shape[:3]
    b, nb = block_tables.shape
    out = torch.empty((t, h * hd), dtype=q.dtype, device=q.device)
    rc = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   block_tables.data_ptr(), positions.data_ptr(),
                   seq_idx.data_ptr(), out.data_ptr(), t, h, kv, hd, bs, b,
                   nb, n_blocks, _paged.TILE, hd ** -0.5,
                   _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"paged_span_attention launch failed: CUDA "
                           f"error {rc}")
    _paged.count_launch(paged_span_attention)
    return out


paged_span_attention.launches = 0
