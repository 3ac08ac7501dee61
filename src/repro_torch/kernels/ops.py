"""Public entry point for the port's kernels: the reference's five layout
adapters (``repro/kernels/ops.py``) with their names, argument order and
layouts, each over the port's kernel for it.

The reference picks interpret mode off the TPU; here the device of the
tensors decides: CPU tensors take each kernel's plain PyTorch version,
CUDA tensors launch the CUDA kernel or raise.  Nothing falls back.

The tile arguments (``q_block``, ``kv_block``, ``t_block``, ``f_block``)
are accepted for the reference's signatures.  The CUDA kernels fix their
own tiles, and a tile changes at most the order of fp32 sums; on the CPU
``kv_block`` is the plain attention versions' kv tile, the others are
not read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import contiguous_decode_attention
from repro_torch.kernels.flash_attention import flash_attention, \
    flash_attention_noncausal
from repro_torch.kernels.rmsnorm_matmul import rmsnorm_matmul
from repro_torch.kernels.span_attention import span_attention
from repro_torch.kernels.swiglu import swiglu


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         q_block: int = 256, kv_block: int = 256):
    """Model-layout adapter: q [B,S,H,hd], k/v [B,S,Kv,hd] -> [B,S,H*hd].
    Causal: query i is at position i (a prompt from position 0), with an
    optional sliding window.  Non-causal takes no window (not ported:
    ROADMAP.md) and may have another key length."""
    if not causal:
        if window:
            raise ValueError("flash_attention_bshd: a window needs the "
                             "causal form; non-causal windowed attention "
                             "is not ported (ROADMAP.md)")
        return flash_attention_noncausal(q, k, v, kv_block=kv_block)
    positions = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    return flash_attention(q, k, v, positions, window=window,
                           kv_block=kv_block)


def decode_attention_cached(q, k_cache, v_cache, lengths, *,
                            kv_block: int = 512):
    """q [B,H,hd]; caches [B,S,Kv,hd]; lengths [B] (1..S valid slots of
    each row) -> [B, H*hd]."""
    b, s = q.shape[0], k_cache.shape[1]
    if lengths.shape != (b,):
        raise ValueError(f"decode_attention_cached: lengths must be [{b}], "
                         f"got {tuple(lengths.shape)}")
    if b and (int(lengths.min()) < 1 or int(lengths.max()) > s):
        raise ValueError(f"decode_attention_cached: every length must be in "
                         f"1..{s}, got {lengths.tolist()}")
    rows = torch.arange(b, dtype=torch.int32, device=q.device)
    return contiguous_decode_attention(q, k_cache, v_cache, rows,
                                       (lengths - 1).to(torch.int32))


def span_attention_packed(q, k_cache, v_cache, positions, seq_idx, *,
                          window: int = 0, kv_block: int = 512):
    """Packed ragged chunk attention: q [T,H,hd]; caches [B,S,Kv,hd];
    positions/seq_idx [T] -> [T, H*hd]."""
    if window:
        raise NotImplementedError(
            "span_attention_packed: a window over a full cache is not "
            "ported (ROADMAP.md); windowed models keep rolling caches")
    return span_attention(q, k_cache, v_cache, positions.to(torch.int32),
                          seq_idx.to(torch.int32))


def swiglu_fused(x, w1, w3, w2, *, t_block: int = 256, f_block: int = 512):
    """x [..., d] -> [..., d] fused gated MLP."""
    lead = x.shape[:-1]
    y = swiglu(x.reshape(-1, x.shape[-1]), w1, w3, w2)
    return y.reshape(*lead, -1)


def rmsnorm_matmul_fused(x, w_norm, w_proj, *, eps: float = 1e-5,
                         t_block: int = 256, f_block: int = 512):
    """Fused block-entry norm + projection: x [..., d] -> [..., F]."""
    lead = x.shape[:-1]
    y = rmsnorm_matmul(x.reshape(-1, x.shape[-1]), w_norm, w_proj, eps=eps)
    return y.reshape(*lead, -1)
