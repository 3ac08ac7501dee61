"""Single-token (decode) attention, over a bf16 cache and over the int8
cache, paged or in contiguous rows.

CUDA kernels:

- ``csrc/decode_attention.cu`` replaces the TPU kernel
  ``repro/kernels/decode_attention.py:72`` (``decode_attention``).  The
  TPU kernel read contiguous rows; this one reads K/V through the [B, nb]
  block table.  Its body, ``csrc/decode_attention_split.cuh``, splits a
  row's visible slots into chunks of ``_paged.DECODE_SPLIT`` from slot 0,
  folds each on the tensor cores in its own block and merges the chunks in
  order (a second kernel of the same C call, through a workspace the
  wrapper allocates); it takes g = H / Kv up to 16 and hd in {16, 32, 64,
  128, 256}, and raises ``ValueError`` on other CUDA shapes.
- ``csrc/decode_attention_quant.cu`` has no TPU kernel before it: the
  reference runs the jnp ``decode_attention_quant`` on the gathered view
  (repro/models/transformer.py:110-133).  It reads the int8 cache through
  the table.  Its body, ``csrc/decode_attention_quant_split.cuh``, splits
  the visible slots into the same chunks and computes the function in four
  grid-wide passes through a workspace the wrapper allocates
  (``_paged.quant_decode_workspace``), both products on the int8 tensor
  cores; it takes the same shapes but hd 256 and raises ``ValueError``
  on others.

Both have a rolling mode for sliding-window models, whose cache keeps
position p at slot p % W: the visible slots are 0..min(pos + 1, W) - 1
(the reference's ``rolling_window`` decode, transformer.py:102-146).  It
is the port's own (the Pallas ``decode_attention`` has none), and its
wrappers, :func:`paged_decode_attention_rolling` and
:func:`paged_decode_attention_quant_rolling`, count their launches apart
from the full-cache ones.

Both also have a contiguous mode (the contiguous KV layout: caches
[R, S, Kv, hd], decode row b reading cache row ``rows[b]``), the Pallas
``decode_attention``'s own layout with lengths = positions + 1, over
the same bodies (their ``ContiguousChunk`` and ``ContiguousRows``):
:func:`contiguous_decode_attention`,
:func:`contiguous_decode_attention_rolling`,
:func:`contiguous_decode_attention_quant` and
:func:`contiguous_decode_attention_quant_rolling`, each counting its own
launches.  The reference runs the jnp ``decode_attention{,_quant}`` on
its cache rows there (repro/models/transformer.py:145-167).

All are memory-bound: the least they must move is each row's K/V
prefix (or window) once, plus q and the output.

Plain versions: :func:`paged_decode_attention_plain`, the reference's
paged decode (``attention.decode_attention`` over ``gather_paged_cache``,
repro/models/transformer.py:140-143): scores in the input dtype, softmax
in fp32, probabilities cast back; and
:func:`paged_decode_attention_quant_plain`, ``decode_attention_quant``
over the gathered int8 view, as the reference computes it; the
contiguous modes' plain versions are the same oracles on the batch's
rows, :func:`contiguous_decode_attention_plain` and
:func:`contiguous_decode_attention_quant_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _paged
from repro_torch.models.attention import (decode_attention,
                                          decode_attention_quant,
                                          gather_paged_cache)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    return _build.load("decode_attention", "paged_decode_attention",
                       [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P])


@functools.cache
def _quant_kernel():
    return _build.load("decode_attention_quant",
                       "paged_decode_attention_quant",
                       [_P] * 9 + [_I] * 9 + [ctypes.c_float, _P])


def _check_window(window: int) -> None:
    if window < 1:
        raise ValueError(f"a rolling window must be >= 1, got {window}")


def paged_decode_attention_plain(q, k_cache, v_cache, block_tables,
                                 positions, *, rolling_window: int = 0):
    """q [B, H, hd]; caches [n_blocks, bs, Kv, hd]; block_tables [B, nb];
    positions [B] -> [B, H*hd]."""
    return decode_attention(q, gather_paged_cache(k_cache, block_tables),
                            gather_paged_cache(v_cache, block_tables),
                            positions, rolling_window=rolling_window)


def _decode(wrapper, q, k_cache, v_cache, block_tables, positions, window):
    _paged.check(q, k_cache, v_cache, block_tables, {"positions": positions})
    if block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"block_tables has {block_tables.shape[0]} rows "
                         f"for {q.shape[0]} queries")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_cache, v_cache,
                                            block_tables, positions,
                                            rolling_window=window)
    b, h, hd = q.shape
    n_blocks, bs, kv = k_cache.shape[:3]
    nb = block_tables.shape[1]
    _paged.check_decode_split(q, kv, (q, k_cache, v_cache),
                              widths=_paged.WIDE_WIDTHS)
    width = min(nb * bs, window) if window else nb * bs
    ws = torch.empty(_paged.decode_workspace(b, h, kv, hd, width),
                     dtype=torch.float32, device=q.device)
    out = torch.empty((b, h * hd), dtype=q.dtype, device=q.device)
    rc = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   block_tables.data_ptr(), positions.data_ptr(),
                   ws.data_ptr(), out.data_ptr(), b, h, kv, hd, bs, nb,
                   n_blocks, _paged.DECODE_SPLIT, window, hd ** -0.5,
                   _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{rc}")
    _paged.count_launch(wrapper)
    return out


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """Row b's new token attends to slots ``0..positions[b]`` of table
    row b.  q [B, H, hd]; caches [n_blocks, bs, Kv, hd]; block_tables
    [B, nb] int32; positions [B] int32 -> [B, H*hd].  CPU tensors take
    the plain version; CUDA tensors launch the kernel (bf16 only)."""
    return _decode(paged_decode_attention, q, k_cache, v_cache,
                   block_tables, positions, 0)


def paged_decode_attention_rolling(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   positions: torch.Tensor, *,
                                   window: int) -> torch.Tensor:
    """:func:`paged_decode_attention` over a rolling cache (slot = pos %
    W): row b attends to slots ``0..min(positions[b] + 1, W) - 1``."""
    _check_window(window)
    return _decode(paged_decode_attention_rolling, q, k_cache, v_cache,
                   block_tables, positions, window)


paged_decode_attention.launches = 0
paged_decode_attention_rolling.launches = 0


def paged_decode_attention_quant_plain(q, k8, ks, v8, vs, block_tables,
                                       positions, *, rolling_window: int = 0):
    """q [B, H, hd]; k8/v8 [n_blocks, bs, Kv, hd] int8; ks/vs [n_blocks,
    bs, Kv] bf16; block_tables [B, nb]; positions [B] -> [B, H*hd]."""
    g = lambda c: gather_paged_cache(c, block_tables)
    return decode_attention_quant(q, g(k8), g(ks), g(v8), g(vs), positions,
                                  rolling_window=rolling_window)


def _quant_workspace(q, kv, width, workspace):
    """The int8 split body's workspace for a CUDA call: ``workspace`` if
    given (a check passes its own to read the quantized probabilities
    back, ``_paged.quant_decode_p8``), else a new one."""
    b, h, hd = q.shape
    size = _paged.quant_decode_workspace(b, h, kv, hd, width)
    if workspace is None:
        return torch.empty(size, dtype=torch.float32, device=q.device)
    if (workspace.numel() < size or workspace.dtype != torch.float32
            or workspace.device != q.device):
        raise ValueError(f"the workspace needs {size} fp32 entries on "
                         f"{q.device}")
    return workspace


def _decode_quant(wrapper, q, k8, ks, v8, vs, block_tables, positions,
                  window, workspace=None):
    _paged.check_quant(q, k8, ks, v8, vs, block_tables,
                       {"positions": positions})
    if block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"block_tables has {block_tables.shape[0]} rows "
                         f"for {q.shape[0]} queries")
    if q.device.type == "cpu":
        return paged_decode_attention_quant_plain(
            q, k8, ks, v8, vs, block_tables, positions,
            rolling_window=window)
    b, h, hd = q.shape
    n_blocks, bs, kv = k8.shape[:3]
    nb = block_tables.shape[1]
    _paged.check_decode_split(q, kv, (k8, v8))
    width = min(nb * bs, window) if window else nb * bs
    ws = _quant_workspace(q, kv, width, workspace)
    out = torch.empty((b, h * hd), dtype=q.dtype, device=q.device)
    rc = _quant_kernel()(q.data_ptr(), k8.data_ptr(), ks.data_ptr(),
                         v8.data_ptr(), vs.data_ptr(), block_tables.data_ptr(),
                         positions.data_ptr(), ws.data_ptr(), out.data_ptr(),
                         b, h, kv, hd, bs, nb, n_blocks, _paged.DECODE_SPLIT,
                         window, hd ** -0.5, _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{rc}")
    _paged.count_launch(wrapper)
    return out


def paged_decode_attention_quant(q: torch.Tensor, k8: torch.Tensor,
                                 ks: torch.Tensor, v8: torch.Tensor,
                                 vs: torch.Tensor, block_tables: torch.Tensor,
                                 positions: torch.Tensor) -> torch.Tensor:
    """:func:`paged_decode_attention` over the int8 cache (k8/v8 int8
    [n_blocks, bs, Kv, hd] with bf16 scales ks/vs [n_blocks, bs, Kv]).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 q, g = H / Kv up to 16, hd in 16, 32, 64, 128)."""
    return _decode_quant(paged_decode_attention_quant, q, k8, ks, v8, vs,
                         block_tables, positions, 0)


def paged_decode_attention_quant_rolling(q: torch.Tensor, k8: torch.Tensor,
                                         ks: torch.Tensor, v8: torch.Tensor,
                                         vs: torch.Tensor,
                                         block_tables: torch.Tensor,
                                         positions: torch.Tensor, *,
                                         window: int) -> torch.Tensor:
    """:func:`paged_decode_attention_quant` over a rolling int8 cache:
    row b attends to slots ``0..min(positions[b] + 1, W) - 1``."""
    _check_window(window)
    return _decode_quant(paged_decode_attention_quant_rolling, q, k8, ks, v8,
                         vs, block_tables, positions, window)


paged_decode_attention_quant.launches = 0
paged_decode_attention_quant_rolling.launches = 0


# ---------------------------------------------------------------------------
# Contiguous rows: caches [R, S, Kv, hd], rows [B] the cache row of each
# decode row
# ---------------------------------------------------------------------------

@functools.cache
def _rows_kernel():
    return _build.load("decode_attention", "contiguous_decode_attention",
                       [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P])


@functools.cache
def _rows_quant_kernel():
    return _build.load("decode_attention_quant",
                       "contiguous_decode_attention_quant",
                       [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P])


def contiguous_decode_attention_plain(q, k_cache, v_cache, rows, positions,
                                      *, rolling_window: int = 0):
    """q [B, H, hd]; caches [R, S, Kv, hd]; rows/positions [B] ->
    [B, H*hd]."""
    r = rows.long()
    return decode_attention(q, k_cache[r], v_cache[r], positions,
                            rolling_window=rolling_window)


def _rows_decode(wrapper, q, k_cache, v_cache, rows, positions, window):
    _paged.check(q, k_cache, v_cache, None,
                 {"rows": rows, "positions": positions})
    if q.device.type == "cpu":
        return contiguous_decode_attention_plain(
            q, k_cache, v_cache, rows, positions, rolling_window=window)
    b, h, hd = q.shape
    r, s, kv = k_cache.shape[:3]
    _paged.check_decode_split(q, kv, (q, k_cache, v_cache),
                              widths=_paged.WIDE_WIDTHS)
    width = min(s, window) if window else s
    ws = torch.empty(_paged.decode_workspace(b, h, kv, hd, width),
                     dtype=torch.float32, device=q.device)
    out = torch.empty((b, h * hd), dtype=q.dtype, device=q.device)
    rc = _rows_kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        rows.data_ptr(), positions.data_ptr(), ws.data_ptr(),
                        out.data_ptr(), b, h, kv, hd, r, s,
                        _paged.DECODE_SPLIT, window, hd ** -0.5,
                        _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{rc}")
    _paged.count_launch(wrapper)
    return out


def contiguous_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, rows: torch.Tensor,
                                positions: torch.Tensor) -> torch.Tensor:
    """Decode row b's new token attends to slots ``0..positions[b]`` of
    cache row ``rows[b]``.  q [B, H, hd]; caches [R, S, Kv, hd];
    rows/positions [B] int32 -> [B, H*hd].  CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16 only)."""
    return _rows_decode(contiguous_decode_attention, q, k_cache, v_cache,
                        rows, positions, 0)


def contiguous_decode_attention_rolling(q: torch.Tensor,
                                        k_cache: torch.Tensor,
                                        v_cache: torch.Tensor,
                                        rows: torch.Tensor,
                                        positions: torch.Tensor, *,
                                        window: int) -> torch.Tensor:
    """:func:`contiguous_decode_attention` over rolling rows (slot = pos %
    W): row b attends to slots ``0..min(positions[b] + 1, W) - 1``."""
    _check_window(window)
    return _rows_decode(contiguous_decode_attention_rolling, q, k_cache,
                        v_cache, rows, positions, window)


contiguous_decode_attention.launches = 0
contiguous_decode_attention_rolling.launches = 0


def contiguous_decode_attention_quant_plain(q, k8, ks, v8, vs, rows,
                                            positions, *,
                                            rolling_window: int = 0):
    """q [B, H, hd]; k8/v8 [R, S, Kv, hd] int8; ks/vs [R, S, Kv] bf16;
    rows/positions [B] -> [B, H*hd]."""
    r = rows.long()
    return decode_attention_quant(q, k8[r], ks[r], v8[r], vs[r], positions,
                                  rolling_window=rolling_window)


def _rows_decode_quant(wrapper, q, k8, ks, v8, vs, rows, positions, window,
                       workspace=None):
    _paged.check_quant(q, k8, ks, v8, vs, None,
                       {"rows": rows, "positions": positions})
    if q.device.type == "cpu":
        return contiguous_decode_attention_quant_plain(
            q, k8, ks, v8, vs, rows, positions, rolling_window=window)
    b, h, hd = q.shape
    r, s, kv = k8.shape[:3]
    _paged.check_decode_split(q, kv, (k8, v8))
    ws = _quant_workspace(q, kv, min(s, window) if window else s, workspace)
    out = torch.empty((b, h * hd), dtype=q.dtype, device=q.device)
    rc = _rows_quant_kernel()(q.data_ptr(), k8.data_ptr(), ks.data_ptr(),
                              v8.data_ptr(), vs.data_ptr(), rows.data_ptr(),
                              positions.data_ptr(), ws.data_ptr(),
                              out.data_ptr(), b, h, kv, hd, r, s,
                              _paged.DECODE_SPLIT, window, hd ** -0.5,
                              _paged.stream_ptr(q))
    if rc:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{rc}")
    _paged.count_launch(wrapper)
    return out


def contiguous_decode_attention_quant(q: torch.Tensor, k8: torch.Tensor,
                                      ks: torch.Tensor, v8: torch.Tensor,
                                      vs: torch.Tensor, rows: torch.Tensor,
                                      positions: torch.Tensor) -> torch.Tensor:
    """:func:`contiguous_decode_attention` over int8 rows (k8/v8 int8
    [R, S, Kv, hd] with bf16 scales ks/vs [R, S, Kv]).  CPU tensors take
    the plain version; CUDA tensors launch the kernel (bf16 q, g = H / Kv
    up to 16, hd in 16, 32, 64, 128)."""
    return _rows_decode_quant(contiguous_decode_attention_quant, q, k8, ks,
                              v8, vs, rows, positions, 0)


def contiguous_decode_attention_quant_rolling(
        q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
        v8: torch.Tensor, vs: torch.Tensor, rows: torch.Tensor,
        positions: torch.Tensor, *, window: int) -> torch.Tensor:
    """:func:`contiguous_decode_attention_quant` over rolling int8 rows:
    row b attends to slots ``0..min(positions[b] + 1, W) - 1``."""
    _check_window(window)
    return _rows_decode_quant(contiguous_decode_attention_quant_rolling, q,
                              k8, ks, v8, vs, rows, positions, window)


contiguous_decode_attention_quant.launches = 0
contiguous_decode_attention_quant_rolling.launches = 0
