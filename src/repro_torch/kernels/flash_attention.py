"""Prefill attention: causal (the monolithic prefill step's attention)
or non-causal (the whisper encoder's self-attention and the decoder's
cross-attention to the encoder output).

CUDA kernel: ``csrc/flash_attention.cu``, which replaces the TPU kernel
``repro/kernels/flash_attention.py:80`` (``flash_attention``, both its
``causal`` forms) together with its layout adapter
``repro/kernels/ops.py:27`` (``flash_attention_bshd``): it takes the
model's [B, S, H, hd] layout and returns [B, S, H*hd].  Memory bounds it
at the engine's prompt lengths (up to S ~ 1200 with H = Kv; the bf16
tensor cores beyond, and for the encoder's 1500 frames).  One block of 4
warps computes 64 query rows (64 / g positions x the g heads of one kv
head) on the tensor cores (``mma.sync``, P as bf16 hi + lo) over K/V
tiles of 64 keys staged by ``cp.async``, skipping whole tiles outside the
causal (and window) band.  The two forms count their launches apart:
:func:`flash_attention` (causal) and :func:`flash_attention_noncausal`.

Plain version: :func:`flash_attention_plain`, the reference's prefill
attention with its dtype casts: ``repro.models.attention.
chunked_attention`` (what its ``prefill`` mode runs off the TPU), for a
sliding window ``local_attention`` (the windowed prefill, which keeps
its scores and unnormalised probabilities in the input dtype), and
non-causal ``cross_attention`` (``chunked_attention(causal=False)``,
what the encoder and the cross-attention run).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _paged
from repro_torch.models.attention import chunked_attention, \
    cross_attention, local_attention

_P, _I = ctypes.c_void_p, ctypes.c_int
HEAD_DIMS = _paged.WIDE_WIDTHS       # the kernel's compiled head widths


@functools.cache
def _kernel():
    return _build.load("flash_attention", "flash_attention",
                       [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P])


def flash_attention_plain(q, k, v, q_positions=None, *, causal: bool = True,
                          window: int = 0, kv_block: int = 512):
    """q [B, Sq, H, hd]; k, v [B, Skv, Kv, hd]; q_positions [Sq] (causal
    only) -> [B, Sq, H*hd].  With a window, the reference's
    ``local_attention`` (query blocks of ``kv_block`` rows), which takes a
    prompt from position 0: q_positions must be ``arange(Sq)`` and Skv ==
    Sq.  Non-causal, ``cross_attention`` (positions are not read)."""
    if not causal:
        return cross_attention(q, k, v, kv_block=kv_block)
    if window:
        sq = q.shape[1]
        if k.shape[1] != sq or not torch.equal(
                q_positions.long(), torch.arange(sq, device=q.device)):
            raise ValueError("windowed prefill attention takes a prompt "
                             "from position 0 (q_positions = arange(S))")
        return local_attention(q, k, v, window=window, q_block=kv_block)
    return chunked_attention(q, k, v, window=window, kv_block=kv_block,
                             q_positions=q_positions)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions=None, *, causal: bool = True,
                    window: int = 0, kv_block: int = 512) -> torch.Tensor:
    """Causal: query row i (at position ``q_positions[i]``) of batch row b
    attends to keys ``j <= q_positions[i]`` with ``j > q_positions[i] -
    window`` (window > 0) of the same batch row.  Non-causal
    (``causal=False``; no window, positions ignored): every key of the
    batch row.  GQA maps query head h to kv head ``h // (H // Kv)``.
    q [B, Sq, H, hd]; k, v [B, Skv, Kv, hd]; q_positions [Sq] int32
    (causal) -> [B, Sq, H*hd].  CPU tensors take the plain version, whose
    kv tile (query block with a window) is ``kv_block`` (the kernel's
    tiles are 64 keys wide; the tile changes only the order of fp32 sums,
    and in bf16 where the probabilities round); CUDA tensors launch the
    kernel (bf16, hd in ``HEAD_DIMS``, H / Kv in 1..16, 16-byte aligned;
    other shapes raise ValueError), counted by
    :func:`flash_attention` (causal) or :func:`flash_attention_noncausal`."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, S, H, hd] and k, v one [B, S, Kv, "
                         f"hd] shape; got {tuple(q.shape)}, {tuple(k.shape)}"
                         f", {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kv or skv == 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    tensors = [q, k, v]
    if causal:
        if (q_positions is None or q_positions.shape != (sq,)
                or q_positions.dtype != torch.int32):
            got = (None if q_positions is None
                   else (tuple(q_positions.shape), q_positions.dtype))
            raise ValueError(f"causal attention needs q_positions [{sq}] "
                             f"int32, got {got}")
        tensors.append(q_positions)
    elif window:
        raise ValueError("a window needs the causal form: non-causal "
                         "windowed attention is not ported (ROADMAP.md)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device, got "
                         f"{sorted(str(t.device) for t in tensors)}")
    if q.device.type == "cpu":
        if q.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the plain version takes bf16 or fp32, got "
                            f"{q.dtype}")
        return flash_attention_plain(q, k, v, q_positions, causal=causal,
                                     window=window, kv_block=kv_block)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16, got {q.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    _paged.check_tiled(q, kv, (q, k, v), widths=HEAD_DIMS)
    out = torch.empty((b, sq, h * hd), dtype=q.dtype, device=q.device)
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   q_positions.data_ptr() if causal else None,
                   out.data_ptr(), b, sq, skv, h, kv, hd, int(causal),
                   window, hd ** -0.5, _paged.stream_ptr(q))
    wrapper = flash_attention if causal else flash_attention_noncausal
    if rc:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{rc}")
    _paged.count_launch(wrapper)
    return out


def flash_attention_noncausal(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              kv_block: int = 512) -> torch.Tensor:
    """:func:`flash_attention` with ``causal=False``: every query attends
    to every key of its batch row (the encoder's self-attention, the
    decoder's cross-attention).  Its launches count here."""
    return flash_attention(q, k, v, causal=False, kv_block=kv_block)


flash_attention.launches = 0
flash_attention_noncausal.launches = 0
