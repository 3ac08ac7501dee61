"""Input checks and launch geometry shared by the paged attention kernels
(``span_attention``, ``decode_attention``); see
``csrc/paged_attention.cuh`` for the kernels' common body."""
from __future__ import annotations

import threading

import torch

TILE = 64                   # KV slots staged in shared memory per step


def check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          block_tables: torch.Tensor, index_vectors) -> None:
    """Validate a paged attention call: q [N, H, hd]; caches
    [n_blocks, bs, Kv, hd]; tables [B, nb] int32; each index vector [N]
    int32; everything on one device.  Raises ValueError/TypeError."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [N, H, hd] and the caches "
                         f"[n_blocks, bs, Kv, hd]; got {tuple(q.shape)} "
                         f"and {tuple(k_cache.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v cache shapes differ: {tuple(k_cache.shape)} "
                         f"vs {tuple(v_cache.shape)}")
    n, h, hd = q.shape
    kv = k_cache.shape[2]
    if k_cache.shape[3] != hd or h % kv:
        raise ValueError(f"q heads/width {h}x{hd} do not fit cache kv "
                         f"heads/width {kv}x{k_cache.shape[3]}")
    if block_tables.dim() != 2:
        raise ValueError(f"block_tables must be [B, nb], got "
                         f"{tuple(block_tables.shape)}")
    for name, v in index_vectors.items():
        if v.shape != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(v.shape)}")
    for name, v in (("block_tables", block_tables), *index_vectors.items()):
        if v.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {v.dtype}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    tensors = [q, k_cache, v_cache, block_tables, *index_vectors.values()]
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


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; the pipeline's stage threads
    launch concurrently, and ``+=`` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1
