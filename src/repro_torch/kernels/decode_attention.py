"""Paged single-token (decode) attention.

CUDA kernel: ``csrc/decode_attention.cu``, which replaces the TPU kernel
``repro/kernels/decode_attention.py:72`` (``decode_attention``).  The TPU
kernel read contiguous rows; this one reads K/V through the [B, nb] block
table.  It is memory-bound: the least it must move is each row's K/V
prefix once, plus q and the output.  Its design is described in
``csrc/paged_attention.cuh``.

Plain version: :func:`paged_decode_attention_plain`, the reference's
paged decode (``attention.decode_attention`` over ``gather_paged_cache``,
repro/models/transformer.py:140-143): scores in the input dtype, softmax
in fp32, probabilities cast back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _paged
from repro_torch.models.attention import decode_attention, gather_paged_cache

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    return _build.load("decode_attention", "paged_decode_attention",
                       [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P])


def paged_decode_attention_plain(q, k_cache, v_cache, block_tables,
                                 positions):
    """q [B, H, hd]; caches [n_blocks, bs, Kv, hd]; block_tables [B, nb];
    positions [B] -> [B, H*hd]."""
    return decode_attention(q, gather_paged_cache(k_cache, block_tables),
                            gather_paged_cache(v_cache, block_tables),
                            positions)


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *,
                           rolling_window: int = 0) -> torch.Tensor:
    """Row b's new token attends to slots ``0..positions[b]`` of table
    row b.  q [B, H, hd]; caches [n_blocks, bs, Kv, hd]; block_tables
    [B, nb] int32; positions [B] int32 -> [B, H*hd].  CPU tensors take
    the plain version; CUDA tensors launch the kernel (bf16 only)."""
    if rolling_window:
        raise NotImplementedError(
            "rolling-window decode attention is not ported yet "
            "(ROADMAP.md queue 2)")
    _paged.check(q, k_cache, v_cache, block_tables, {"positions": positions})
    if block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"block_tables has {block_tables.shape[0]} rows "
                         f"for {q.shape[0]} queries")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_cache, v_cache,
                                            block_tables, positions)
    b, h, hd = q.shape
    n_blocks, bs, kv = k_cache.shape[:3]
    nb = block_tables.shape[1]
    out = torch.empty((b, h * hd), dtype=q.dtype, device=q.device)
    rc = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   block_tables.data_ptr(), positions.data_ptr(),
                   out.data_ptr(), b, h, kv, hd, bs, nb, n_blocks,
                   _paged.TILE, hd ** -0.5, _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {rc}")
    _paged.count_launch(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
