"""Input checks and launch geometry shared by the attention kernels
(``span_attention``, ``decode_attention``), paged and contiguous; see
``csrc/paged_attention.cuh`` and ``csrc/paged_attention_quant.cuh`` for
the kernels' common bodies.

Two cache layouts: paged, [n_blocks, bs, Kv, hd] leaves read through
[B, nb] int32 block tables; and contiguous rows, [R, S, Kv, hd] leaves
indexed by an int32 row per token or per decode row (``block_tables``
None below).  int8 scales drop the last axis."""
from __future__ import annotations

import threading

import torch

TILE = 64                   # KV slots staged in shared memory per step

# A kernel (bf16 in, fp32 inside, bf16 out) against its plain version run
# in fp32 on the same values: |kernel - plain| <= KERNEL_REL * |plain| +
# KERNEL_ABS, one bf16 step of the output (2^-7 relative; rounding moves it
# by half that) plus fp32 summation-order noise.  Dropping one of n
# visible slots moves an output by ~|v|/n, ~1e-3 at n = 1000: several
# steps of a typical output.  chip_smoke.py holds every attention kernel to
# it; tests/test_torch_rolling_tiles.py shows that the tiled rolling body
# needs its probabilities as bf16 hi + lo to stay inside it.
KERNEL_REL = 2.0 ** -7
KERNEL_ABS = 1e-5

# The tiled rolling span body (csrc/span_attention_tiled.cuh): blocks of
# QUERY_ROWS query rows, 64 / g tokens x g heads of one kv head
QUERY_ROWS = 64
TILED_GROUPS = (1, 2, 4, 8)         # g = H / Kv
TILED_WIDTHS = (16, 32, 64, 128)    # hd


def check_tiled(q: torch.Tensor, kv_heads: int, tensors) -> None:
    """The tiled body's shapes, for a CUDA call: g = H / Kv in
    TILED_GROUPS, hd in TILED_WIDTHS, 16-byte aligned data (cp.async).
    Raises ValueError; the caller never falls back to the plain version."""
    h, hd = q.shape[1], q.shape[2]
    if h // kv_heads not in TILED_GROUPS or hd not in TILED_WIDTHS:
        raise ValueError(f"the tiled rolling kernel takes g = H / Kv in "
                         f"{TILED_GROUPS} and hd in {TILED_WIDTHS}, got g = "
                         f"{h // kv_heads}, hd = {hd}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the tiled rolling kernel needs 16-byte aligned "
                         "inputs")


def plan_ints(t: int, rows: int, g: int) -> int:
    """int32 entries of the tiled body's planning workspace for T = t
    tokens over ``rows`` cache (or table) rows (tiled::plan_ints)."""
    tq = QUERY_ROWS // g
    max_tiles = -(-t // tq) + min(rows, t)
    return 1 + 3 * max_tiles + 2 * t + 3 * rows


def _check_shapes(q: torch.Tensor, cache_shape, block_tables,
                  index_vectors) -> None:
    layout = ("[R, S, Kv, hd]" if block_tables is None
              else "[n_blocks, bs, Kv, hd]")
    if q.dim() != 3 or len(cache_shape) != 4:
        raise ValueError(f"q must be [N, H, hd] and the caches {layout}; "
                         f"got {tuple(q.shape)} and {tuple(cache_shape)}")
    n, h, hd = q.shape
    kv = cache_shape[2]
    if cache_shape[3] != hd or h % kv:
        raise ValueError(f"q heads/width {h}x{hd} do not fit cache kv "
                         f"heads/width {kv}x{cache_shape[3]}")
    if block_tables is not None and block_tables.dim() != 2:
        raise ValueError(f"block_tables must be [B, nb], got "
                         f"{tuple(block_tables.shape)}")
    for name, v in index_vectors.items():
        if v.shape != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(v.shape)}")
    tables = {} if block_tables is None else {"block_tables": block_tables}
    for name, v in (*tables.items(), *index_vectors.items()):
        if v.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {v.dtype}")


def _check_devices(q: torch.Tensor, tensors) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device, got "
                         f"{sorted(str(t.device) for t in tensors)}")
    dev = q.device.type
    if dev == "cpu":
        if q.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the plain version takes bf16 or fp32, got "
                            f"{q.dtype}")
        return
    if dev != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16, got {q.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel needs contiguous inputs")


def check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          block_tables, index_vectors) -> None:
    """Validate an attention call: q [N, H, hd]; caches [n_blocks, bs, Kv,
    hd] with tables [B, nb] int32, or rows [R, S, Kv, hd] with
    ``block_tables`` None; each index vector [N] int32; everything on one
    device.  Raises ValueError/TypeError."""
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v cache shapes differ: {tuple(k_cache.shape)} "
                         f"vs {tuple(v_cache.shape)}")
    _check_shapes(q, k_cache.shape, block_tables, index_vectors)
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    _check_devices(q, [q, k_cache, v_cache, *_tables(block_tables),
                       *index_vectors.values()])


def check_quant(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                v8: torch.Tensor, vs: torch.Tensor,
                block_tables, index_vectors) -> None:
    """Validate an int8 attention call: q [N, H, hd] (bf16; fp32 too on
    the CPU); k8/v8 [n_blocks, bs, Kv, hd] (or rows [R, S, Kv, hd]) int8;
    ks/vs the same without hd, bf16; tables and index vectors as in
    :func:`check`.  The CUDA kernels read K 16 bytes at a time, so there
    hd must be a multiple of 16 and the int8 caches 16-byte aligned."""
    if v8.shape != k8.shape:
        raise ValueError(f"k/v cache shapes differ: {tuple(k8.shape)} "
                         f"vs {tuple(v8.shape)}")
    _check_shapes(q, k8.shape, block_tables, index_vectors)
    for name, c, dt in (("k8", k8, torch.int8), ("v8", v8, torch.int8),
                        ("ks", ks, torch.bfloat16), ("vs", vs, torch.bfloat16)):
        if c.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {c.dtype}")
    for name, c in (("ks", ks), ("vs", vs)):
        if c.shape != k8.shape[:3]:
            raise ValueError(f"{name} must be {tuple(k8.shape[:3])}, got "
                             f"{tuple(c.shape)}")
    tensors = [q, k8, ks, v8, vs, *_tables(block_tables),
               *index_vectors.values()]
    _check_devices(q, tensors)
    if q.device.type == "cuda":
        if q.shape[2] % 16:
            raise ValueError(f"the CUDA kernel needs hd % 16 == 0, got "
                             f"{q.shape[2]}")
        if k8.data_ptr() % 16 or v8.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned int8 "
                             "caches")


def _tables(block_tables) -> list:
    return [] if block_tables is None else [block_tables]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; the pipeline's stage threads
    launch concurrently, and ``+=`` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1
