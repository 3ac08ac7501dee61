"""Packed span attention (the chunked-prefill step's attention), over
a bf16 cache and over the int8 cache, paged or in contiguous rows.

CUDA kernels, paged:

- ``csrc/paged_span_attention.cu`` replaces the TPU kernel
  ``repro/kernels/span_attention.py:611`` (``paged_span_attention``).
  Its body is ``csrc/span_attention_tiled.cuh`` in its full-cache mode: a
  planning pass groups the span's tokens by row, then one block computes
  64 query rows (64 / g tokens of one row x g heads) of one kv head on the
  tensor cores, over each row's prefix read once per block.
- ``csrc/paged_span_attention_quant.cu`` replaces
  ``repro/kernels/span_attention.py:656`` (``paged_span_attention_quant``)
  for ``kv_quant`` models: exact int8 dots, q and the probabilities
  quantized on the fly.  Its body (and rows 8, 10 and 12's) is
  ``csrc/span_attention_quant_tiled.cuh``: the bf16 body's plan and query
  tiles with both dots on the int8 tensor cores, in its full-cache mode.

- ``csrc/paged_span_attention_rolling.cu`` replaces
  ``repro/kernels/span_attention.py:703``
  (``paged_span_attention_rolling``) for sliding-window models, whose
  rolling cache keeps position p at slot p % W: two sources, the old cache
  through the table and the span's own fresh K/V, under one softmax,
  attended before the caller scatters the span.  Its body (and row 11's,
  over rows) is ``csrc/span_attention_tiled.cuh`` in its rolling mode.
- ``csrc/paged_span_attention_rolling_quant.cu`` replaces
  ``repro/kernels/span_attention.py:761``
  (``paged_span_attention_rolling_quant``): the same over the int8
  rolling cache, with the int8 kernel's math on the old cache and
  full-precision dots on the fresh span (the int8 body in its rolling
  mode).

CUDA kernels over contiguous rows (the contiguous KV layout: caches
[R, S, Kv, hd], ``seq_idx`` the cache row of each token), the same
bodies over another address computation:

- ``csrc/span_attention.cu`` replaces ``repro/kernels/span_attention.py:132``
  (``span_attention``);
- ``csrc/span_attention_quant.cu`` replaces :239
  (``span_attention_quant``); its p-quantization tile is ``kv_block``
  halved until it divides S;
- ``csrc/span_attention_rolling.cu`` replaces :519
  (``span_attention_rolling``), rows exactly one window wide;
- ``csrc/span_attention_rolling_quant.cu`` replaces :456
  (``span_attention_rolling_quant``).

All eight are memory-bound at the engine's shapes: the least they must
move is each row's K/V prefix (or window) once, plus q, the fresh span and
the output.  The bf16 four share ``csrc/span_attention_tiled.cuh``, the
int8 four ``csrc/span_attention_quant_tiled.cuh`` (over the same plan and
query tiles).

Plain versions: :func:`paged_span_attention_plain`, the reference
oracle's gather-then-attend (``repro.models.attention.
paged_span_attention``) with its dtype casts, and
:func:`paged_span_attention_quant_plain`,
:func:`paged_span_attention_rolling_plain` and
:func:`paged_span_attention_rolling_quant_plain`, the reference engine's
paths off the TPU (the ``attention.*_native`` functions, which read
through the table tile by tile); over rows, the reference's jnp
oracles themselves (``packed_span_attention{,_quant,_rolling,
_rolling_quant}``), which the Pallas kernels were held against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _paged
from repro_torch.models.attention import (
    kv_tile, gather_paged_cache, packed_span_attention,
    packed_span_attention_quant, packed_span_attention_rolling,
    packed_span_attention_rolling_quant, paged_span_attention_quant_native,
    paged_span_attention_rolling_native,
    paged_span_attention_rolling_quant_native)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    return _build.load("paged_span_attention", "paged_span_attention",
                       [_P] * 8 + [_I] * 8
                       + [ctypes.c_longlong, ctypes.c_float, _P])


@functools.cache
def _quant_kernel():
    return _build.load("paged_span_attention_quant",
                       "paged_span_attention_quant",
                       [_P] * 10 + [_I] * 9
                       + [ctypes.c_longlong, ctypes.c_float, _P])


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
    the tiled kernel (bf16, g = H / Kv in 1..16, hd in {16, 32, 64, 128};
    other shapes raise ValueError), a planning pass and the main kernel,
    with no host synchronisation."""
    if window:
        raise NotImplementedError(
            "windowed span attention over a full cache is not ported; "
            "windowed models keep rolling caches "
            "(paged_span_attention_rolling)")
    _paged.check(q, k_cache, v_cache, block_tables,
                 {"positions": positions, "seq_idx": seq_idx})
    if q.device.type == "cpu":
        return paged_span_attention_plain(q, k_cache, v_cache, block_tables,
                                          positions, seq_idx)
    t, h, hd = q.shape
    n_blocks, bs, kv = k_cache.shape[:3]
    b, nb = block_tables.shape
    _paged.check_tiled(q, kv, (q, k_cache, v_cache))
    plan = torch.empty(_paged.plan_ints(t, b, h // kv), dtype=torch.int32,
                       device=q.device)
    out = torch.empty((t, h * hd), dtype=q.dtype, device=q.device)
    rc = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   block_tables.data_ptr(), positions.data_ptr(),
                   seq_idx.data_ptr(), plan.data_ptr(), out.data_ptr(), t, h,
                   kv, hd, bs, b, nb, n_blocks, plan.numel(), hd ** -0.5,
                   _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"paged_span_attention launch failed: CUDA "
                           f"error {rc}")
    _paged.count_launch(paged_span_attention)
    return out


paged_span_attention.launches = 0


def paged_span_attention_quant_plain(q, k8, ks, v8, vs, block_tables,
                                     positions, seq_idx, *,
                                     kv_block: int = 512):
    """q [T, H, hd]; k8/v8 [n_blocks, bs, Kv, hd] int8; ks/vs [n_blocks,
    bs, Kv] bf16; block_tables [B, nb]; positions/seq_idx [T] ->
    [T, H*hd]."""
    return paged_span_attention_quant_native(
        q, k8, ks, v8, vs, block_tables, positions, seq_idx,
        kv_block=kv_block)


def paged_span_attention_quant(q: torch.Tensor, k8: torch.Tensor,
                               ks: torch.Tensor, v8: torch.Tensor,
                               vs: torch.Tensor, block_tables: torch.Tensor,
                               positions: torch.Tensor, seq_idx: torch.Tensor,
                               *, kv_block: int = 512) -> torch.Tensor:
    """:func:`paged_span_attention` over the int8 cache (k8/v8 int8
    [n_blocks, bs, Kv, hd] with bf16 scales ks/vs [n_blocks, bs, Kv]).
    The probabilities are quantized per tile of ``kv_block`` slots,
    clipped and halved until it divides the table's ``nb * bs`` slots (the
    reference engine's rule; ``kv_block = bs`` gives the Pallas kernel's
    one-page tiles).  CPU tensors take the plain version; CUDA tensors
    launch the tiled int8 kernel (the shapes of
    :func:`paged_span_attention`; other shapes raise ValueError), a
    planning pass and the main kernel, with no host synchronisation."""
    _paged.check_quant(q, k8, ks, v8, vs, block_tables,
                       {"positions": positions, "seq_idx": seq_idx})
    if q.device.type == "cpu":
        return paged_span_attention_quant_plain(
            q, k8, ks, v8, vs, block_tables, positions, seq_idx,
            kv_block=kv_block)
    t, h, hd = q.shape
    n_blocks, bs, kv = k8.shape[:3]
    b, nb = block_tables.shape
    tile = kv_tile(kv_block, nb * bs)
    _paged.check_tiled(q, kv, (q, k8, v8))
    plan = torch.empty(_paged.plan_ints(t, b, h // kv), dtype=torch.int32,
                       device=q.device)
    out = torch.empty((t, h * hd), dtype=q.dtype, device=q.device)
    rc = _quant_kernel()(q.data_ptr(), k8.data_ptr(), ks.data_ptr(),
                         v8.data_ptr(), vs.data_ptr(), block_tables.data_ptr(),
                         positions.data_ptr(), seq_idx.data_ptr(),
                         plan.data_ptr(), out.data_ptr(), t, h, kv, hd, bs, b,
                         nb, n_blocks, tile, plan.numel(), hd ** -0.5,
                         _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"paged_span_attention_quant launch failed: CUDA "
                           f"error {rc}")
    _paged.count_launch(paged_span_attention_quant)
    return out


paged_span_attention_quant.launches = 0


@functools.cache
def _rolling_kernel():
    return _build.load("paged_span_attention_rolling",
                       "paged_span_attention_rolling",
                       [_P] * 11 + [_I] * 10
                       + [ctypes.c_longlong, ctypes.c_float, _P])


@functools.cache
def _rolling_quant_kernel():
    return _build.load("paged_span_attention_rolling_quant",
                       "paged_span_attention_rolling_quant",
                       [_P] * 13 + [_I] * 11
                       + [ctypes.c_longlong, ctypes.c_float, _P])


def _check_rolling(q, k_span, v_span, offsets, n_valid, window):
    if window < 1:
        raise ValueError(f"a rolling window must be >= 1, got {window}")
    t, h, hd = q.shape
    if k_span.shape != v_span.shape or k_span.dim() != 3 or \
            k_span.shape[0] != t or k_span.shape[2] != hd:
        raise ValueError(f"k_span/v_span must be [{t}, Kv, {hd}], got "
                         f"{tuple(k_span.shape)}, {tuple(v_span.shape)}")
    if k_span.dtype != q.dtype or v_span.dtype != q.dtype:
        raise TypeError(f"the span's K/V must be {q.dtype}, got "
                        f"{k_span.dtype}, {v_span.dtype}")
    if offsets.shape != (t,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be [{t}] int32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if not 0 <= int(n_valid) <= t:
        raise ValueError(f"n_valid must be in [0, {t}], got {n_valid}")
    tensors = [q, k_span, v_span, offsets]
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all inputs must be on one device")
    if q.device.type == "cuda" and not (k_span.is_contiguous()
                                        and v_span.is_contiguous()):
        raise ValueError("the CUDA kernel needs contiguous inputs")


def paged_span_attention_rolling_plain(q, k_cache, v_cache, k_span, v_span,
                                       block_tables, positions, seq_idx,
                                       offsets, n_valid, *, window: int,
                                       kv_block: int = 512):
    """q [T, H, hd]; caches [n_blocks, bs, Kv, hd]; k_span/v_span
    [T, Kv, hd]; block_tables [B, nb]; positions/seq_idx/offsets [T];
    n_valid an int -> [T, H*hd]."""
    return paged_span_attention_rolling_native(
        q, k_cache, v_cache, k_span, v_span, block_tables, positions,
        seq_idx, offsets, n_valid, window=window, kv_block=kv_block)


def paged_span_attention_rolling(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, k_span: torch.Tensor,
                                 v_span: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 positions: torch.Tensor,
                                 seq_idx: torch.Tensor, offsets: torch.Tensor,
                                 n_valid: int, *,
                                 window: int) -> torch.Tensor:
    """Token t (row ``seq_idx[t]``, position ``positions[t]``, whose row
    cache holds positions [0, ``offsets[t]``) at slots pos % W) attends
    the old rolling cache through its table row (stored positions rebuilt
    against the table's width nb * bs) and the span's own fresh K/V
    (same row, causal, inside the window, index < ``n_valid``), all
    within ``window``.  The caches are read only: the caller scatters the
    span afterwards.  q [T, H, hd]; caches [n_blocks, bs, Kv, hd];
    k_span/v_span [T, Kv, hd]; block_tables [B, nb] int32;
    positions/seq_idx/offsets [T] int32 -> [T, H*hd].  CPU tensors take
    the plain version; CUDA tensors launch the tiled kernel (bf16, g = H /
    Kv in 1..16, hd in {16, 32, 64, 128}; other shapes raise ValueError),
    a planning pass and the main kernel, with no host synchronisation."""
    _paged.check(q, k_cache, v_cache, block_tables,
                 {"positions": positions, "seq_idx": seq_idx})
    _check_rolling(q, k_span, v_span, offsets, n_valid, window)
    if q.device.type == "cpu":
        return paged_span_attention_rolling_plain(
            q, k_cache, v_cache, k_span, v_span, block_tables, positions,
            seq_idx, offsets, n_valid, window=window)
    t, h, hd = q.shape
    n_blocks, bs, kv = k_cache.shape[:3]
    b, nb = block_tables.shape
    _paged.check_tiled(q, kv, (q, k_cache, v_cache, k_span, v_span))
    plan = torch.empty(_paged.plan_ints(t, b, h // kv), dtype=torch.int32,
                       device=q.device)
    out = torch.empty((t, h * hd), dtype=q.dtype, device=q.device)
    rc = _rolling_kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_span.data_ptr(), v_span.data_ptr(), block_tables.data_ptr(),
        positions.data_ptr(), seq_idx.data_ptr(), offsets.data_ptr(),
        plan.data_ptr(), out.data_ptr(), t, h, kv, hd, bs, b, nb, n_blocks,
        window, int(n_valid), plan.numel(), hd ** -0.5,
        _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"paged_span_attention_rolling launch failed: "
                           f"CUDA error {rc}")
    _paged.count_launch(paged_span_attention_rolling)
    return out


paged_span_attention_rolling.launches = 0


def paged_span_attention_rolling_quant_plain(q, k8, ks, v8, vs, k_span,
                                             v_span, block_tables, positions,
                                             seq_idx, offsets, n_valid, *,
                                             window: int,
                                             kv_block: int = 512):
    """q [T, H, hd]; k8/v8 [n_blocks, bs, Kv, hd] int8; ks/vs [n_blocks,
    bs, Kv] bf16; the rest as :func:`paged_span_attention_rolling_plain`
    -> [T, H*hd]."""
    return paged_span_attention_rolling_quant_native(
        q, k8, ks, v8, vs, k_span, v_span, block_tables, positions, seq_idx,
        offsets, n_valid, window=window, kv_block=kv_block)


def paged_span_attention_rolling_quant(
        q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
        v8: torch.Tensor, vs: torch.Tensor, k_span: torch.Tensor,
        v_span: torch.Tensor, block_tables: torch.Tensor,
        positions: torch.Tensor, seq_idx: torch.Tensor,
        offsets: torch.Tensor, n_valid: int, *, window: int,
        kv_block: int = 512) -> torch.Tensor:
    """:func:`paged_span_attention_rolling` over the int8 rolling cache
    (k8/v8 int8 [n_blocks, bs, Kv, hd] with bf16 scales ks/vs [n_blocks,
    bs, Kv]); the fresh span K/V stays bf16.  The old cache's
    probabilities are quantized per tile of ``kv_block`` slots, clipped
    and halved until it divides the table's ``nb * bs`` slots (the
    reference engine's rule).  CPU tensors take the plain version; CUDA
    tensors launch the tiled int8 kernel (the shapes of
    :func:`paged_span_attention_rolling`; other shapes raise ValueError),
    a planning pass and the main kernel, with no host synchronisation."""
    _paged.check_quant(q, k8, ks, v8, vs, block_tables,
                       {"positions": positions, "seq_idx": seq_idx})
    _check_rolling(q, k_span, v_span, offsets, n_valid, window)
    if q.device.type == "cpu":
        return paged_span_attention_rolling_quant_plain(
            q, k8, ks, v8, vs, k_span, v_span, block_tables, positions,
            seq_idx, offsets, n_valid, window=window, kv_block=kv_block)
    t, h, hd = q.shape
    n_blocks, bs, kv = k8.shape[:3]
    b, nb = block_tables.shape
    tile = kv_tile(kv_block, nb * bs)
    _paged.check_tiled(q, kv, (q, k8, v8, k_span, v_span))
    plan = torch.empty(_paged.plan_ints(t, b, h // kv), dtype=torch.int32,
                       device=q.device)
    out = torch.empty((t, h * hd), dtype=q.dtype, device=q.device)
    rc = _rolling_quant_kernel()(
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), k_span.data_ptr(), v_span.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), seq_idx.data_ptr(),
        offsets.data_ptr(), plan.data_ptr(), out.data_ptr(), t, h, kv, hd,
        bs, b, nb, n_blocks, tile, window, int(n_valid), plan.numel(),
        hd ** -0.5, _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"paged_span_attention_rolling_quant launch "
                           f"failed: CUDA error {rc}")
    _paged.count_launch(paged_span_attention_rolling_quant)
    return out


paged_span_attention_rolling_quant.launches = 0


# ---------------------------------------------------------------------------
# Contiguous rows: caches [R, S, Kv, hd], seq_idx [T] the row of each token
# ---------------------------------------------------------------------------

@functools.cache
def _rows_kernel():
    return _build.load("span_attention", "span_attention",
                       [_P] * 7 + [_I] * 6
                       + [ctypes.c_longlong, ctypes.c_float, _P])


@functools.cache
def _rows_quant_kernel():
    return _build.load("span_attention_quant", "span_attention_quant",
                       [_P] * 9 + [_I] * 7
                       + [ctypes.c_longlong, ctypes.c_float, _P])


@functools.cache
def _rows_rolling_kernel():
    return _build.load("span_attention_rolling", "span_attention_rolling",
                       [_P] * 10 + [_I] * 8
                       + [ctypes.c_longlong, ctypes.c_float, _P])


@functools.cache
def _rows_rolling_quant_kernel():
    return _build.load("span_attention_rolling_quant",
                       "span_attention_rolling_quant",
                       [_P] * 12 + [_I] * 9
                       + [ctypes.c_longlong, ctypes.c_float, _P])


def _launch(wrapper, kernel, q, ptrs, ints):
    """Launch ``kernel`` on q's stream with the output [T, H*hd] after
    ``ptrs`` and the scale after ``ints``; count the launch."""
    t, h, hd = q.shape
    out = torch.empty((t, h * hd), dtype=q.dtype, device=q.device)
    rc = kernel(*(x.data_ptr() for x in ptrs), out.data_ptr(), t, h, *ints,
                hd ** -0.5, _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{rc}")
    _paged.count_launch(wrapper)
    return out


def span_attention_plain(q, k_cache, v_cache, positions, seq_idx, *,
                         kv_block: int = 512):
    """q [T, H, hd]; caches [R, S, Kv, hd]; positions/seq_idx [T] ->
    [T, H*hd]."""
    return packed_span_attention(q, k_cache, v_cache, positions, seq_idx,
                                 kv_block=kv_block)


def span_attention(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, positions: torch.Tensor,
                   seq_idx: torch.Tensor) -> torch.Tensor:
    """Token t attends to slots ``0..positions[t]`` of cache row
    ``seq_idx[t]``.  q [T, H, hd]; caches [R, S, Kv, hd];
    positions/seq_idx [T] int32 -> [T, H*hd].  CPU tensors take the plain
    version; CUDA tensors launch the tiled kernel (the shapes of
    :func:`paged_span_attention`; with the table's nb * bs == S it gives
    the same bits)."""
    _paged.check(q, k_cache, v_cache, None,
                 {"positions": positions, "seq_idx": seq_idx})
    if q.device.type == "cpu":
        return span_attention_plain(q, k_cache, v_cache, positions, seq_idx)
    t, h, hd = q.shape
    r, s, kv = k_cache.shape[:3]
    _paged.check_tiled(q, kv, (q, k_cache, v_cache))
    plan = torch.empty(_paged.plan_ints(t, r, h // kv), dtype=torch.int32,
                       device=q.device)
    return _launch(span_attention, _rows_kernel(), q,
                   (q, k_cache, v_cache, positions, seq_idx, plan),
                   (kv, hd, r, s, plan.numel()))


span_attention.launches = 0


def span_attention_quant_plain(q, k8, ks, v8, vs, positions, seq_idx, *,
                               kv_block: int = 512):
    """q [T, H, hd]; k8/v8 [R, S, Kv, hd] int8; ks/vs [R, S, Kv] bf16;
    positions/seq_idx [T] -> [T, H*hd]."""
    return packed_span_attention_quant(q, k8, ks, v8, vs, positions,
                                       seq_idx, kv_block=kv_block)


def span_attention_quant(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                         v8: torch.Tensor, vs: torch.Tensor,
                         positions: torch.Tensor, seq_idx: torch.Tensor, *,
                         kv_block: int = 512) -> torch.Tensor:
    """:func:`span_attention` over int8 rows (k8/v8 int8 [R, S, Kv, hd]
    with bf16 scales ks/vs [R, S, Kv]).  The probabilities are quantized
    per tile of ``kv_block`` slots halved until it divides S (the Pallas
    kernel's ``_pick_block``).  CPU tensors take the plain version; CUDA
    tensors launch the tiled int8 kernel (the shapes of
    :func:`paged_span_attention_quant`; with the table's nb * bs == S it
    gives the same bits)."""
    _paged.check_quant(q, k8, ks, v8, vs, None,
                       {"positions": positions, "seq_idx": seq_idx})
    if q.device.type == "cpu":
        return span_attention_quant_plain(q, k8, ks, v8, vs, positions,
                                          seq_idx, kv_block=kv_block)
    t, h, hd = q.shape
    r, s, kv = k8.shape[:3]
    tile = kv_tile(kv_block, s)
    _paged.check_tiled(q, kv, (q, k8, v8))
    plan = torch.empty(_paged.plan_ints(t, r, h // kv), dtype=torch.int32,
                       device=q.device)
    return _launch(span_attention_quant, _rows_quant_kernel(), q,
                   (q, k8, ks, v8, vs, positions, seq_idx, plan),
                   (kv, hd, r, s, tile, plan.numel()))


span_attention_quant.launches = 0


def span_attention_rolling_plain(q, k_cache, v_cache, k_span, v_span,
                                 positions, seq_idx, offsets, n_valid, *,
                                 window: int, kv_block: int = 512):
    """q [T, H, hd]; rolling caches [R, W, Kv, hd]; k_span/v_span
    [T, Kv, hd]; positions/seq_idx/offsets [T]; n_valid an int ->
    [T, H*hd]."""
    return packed_span_attention_rolling(
        q, k_cache, v_cache, k_span, v_span, positions, seq_idx, offsets,
        n_valid, window=window, kv_block=kv_block)


def span_attention_rolling(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_span: torch.Tensor,
                           v_span: torch.Tensor, positions: torch.Tensor,
                           seq_idx: torch.Tensor, offsets: torch.Tensor,
                           n_valid: int, *, window: int) -> torch.Tensor:
    """:func:`paged_span_attention_rolling` over contiguous rolling rows:
    token t's row ``seq_idx[t]`` of [R, S, Kv, hd] caches holds positions
    [0, ``offsets[t]``) at slots pos % S (S = W); the old row and the
    span's own fresh K/V (same row, causal, inside the window, index <
    ``n_valid``) are attended within ``window``.  The caches are read
    only: the caller scatters the span afterwards.  CPU tensors take the
    plain version; CUDA tensors launch the tiled kernel (the shapes of
    :func:`paged_span_attention_rolling`; with the table's nb * bs == S it
    gives the same bits)."""
    _paged.check(q, k_cache, v_cache, None,
                 {"positions": positions, "seq_idx": seq_idx})
    _check_rolling(q, k_span, v_span, offsets, n_valid, window)
    if q.device.type == "cpu":
        return span_attention_rolling_plain(
            q, k_cache, v_cache, k_span, v_span, positions, seq_idx, offsets,
            n_valid, window=window)
    t, h, hd = q.shape
    r, s, kv = k_cache.shape[:3]
    _paged.check_tiled(q, kv, (q, k_cache, v_cache, k_span, v_span))
    plan = torch.empty(_paged.plan_ints(t, r, h // kv), dtype=torch.int32,
                       device=q.device)
    out = torch.empty((t, h * hd), dtype=q.dtype, device=q.device)
    rc = _rows_rolling_kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_span.data_ptr(), v_span.data_ptr(), positions.data_ptr(),
        seq_idx.data_ptr(), offsets.data_ptr(), plan.data_ptr(),
        out.data_ptr(), t, h, kv, hd, r, s, window, int(n_valid),
        plan.numel(), hd ** -0.5, _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"span_attention_rolling launch failed: CUDA "
                           f"error {rc}")
    _paged.count_launch(span_attention_rolling)
    return out


span_attention_rolling.launches = 0


def span_attention_rolling_quant_plain(q, k8, ks, v8, vs, k_span, v_span,
                                       positions, seq_idx, offsets, n_valid,
                                       *, window: int, kv_block: int = 512):
    """q [T, H, hd]; k8/v8 [R, W, Kv, hd] int8; ks/vs [R, W, Kv] bf16; the
    rest as :func:`span_attention_rolling_plain` -> [T, H*hd]."""
    return packed_span_attention_rolling_quant(
        q, k8, ks, v8, vs, k_span, v_span, positions, seq_idx, offsets,
        n_valid, window=window, kv_block=kv_block)


def span_attention_rolling_quant(
        q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
        v8: torch.Tensor, vs: torch.Tensor, k_span: torch.Tensor,
        v_span: torch.Tensor, positions: torch.Tensor, seq_idx: torch.Tensor,
        offsets: torch.Tensor, n_valid: int, *, window: int,
        kv_block: int = 512) -> torch.Tensor:
    """:func:`span_attention_rolling` over int8 rolling rows (k8/v8 int8
    [R, S, Kv, hd] with bf16 scales ks/vs [R, S, Kv]); the fresh span K/V
    stays bf16.  The old rows' probabilities are quantized per tile of
    ``kv_block`` slots halved until it divides S.  CPU tensors take the
    plain version; CUDA tensors launch the tiled int8 kernel (the shapes
    of :func:`paged_span_attention_rolling_quant`; with the table's nb *
    bs == S it gives the same bits)."""
    _paged.check_quant(q, k8, ks, v8, vs, None,
                       {"positions": positions, "seq_idx": seq_idx})
    _check_rolling(q, k_span, v_span, offsets, n_valid, window)
    if q.device.type == "cpu":
        return span_attention_rolling_quant_plain(
            q, k8, ks, v8, vs, k_span, v_span, positions, seq_idx, offsets,
            n_valid, window=window, kv_block=kv_block)
    t, h, hd = q.shape
    r, s, kv = k8.shape[:3]
    tile = kv_tile(kv_block, s)
    _paged.check_tiled(q, kv, (q, k8, v8, k_span, v_span))
    plan = torch.empty(_paged.plan_ints(t, r, h // kv), dtype=torch.int32,
                       device=q.device)
    return _launch(span_attention_rolling_quant, _rows_rolling_quant_kernel(),
                   q, (q, k8, ks, v8, vs, k_span, v_span, positions, seq_idx,
                       offsets, plan),
                   (kv, hd, r, s, tile, window, int(n_valid), plan.numel()))


span_attention_rolling_quant.launches = 0
