"""The layer-group loop shared by the model and the pipeline stages.

A model is: embed -> Stack -> final norm -> lm head.  A Stack is ``n``
groups of layers whose parameters (and KV caches) are stacked on a
leading ``[groups, ...]`` axis, as in the reference; where the reference
scans over that axis, the port loops in Python.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.common import ParamSpec

PyTree = Any


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through block apply functions."""

    mode: str                      # train | prefill | decode | chunk
    positions: torch.Tensor        # prefill: [S]; decode: [B]; chunk: [T]
    rope_cos: Optional[torch.Tensor] = None
    rope_sin: Optional[torch.Tensor] = None
    # chunk mode (packed ragged layout): batch row of each packed token [T]
    seq_idx: Optional[torch.Tensor] = None
    # chunk mode, windowed models: per-row span starts [B] (tokens already
    # in the rolling cache) and the unpadded token count (None = all T)
    span_starts: Optional[torch.Tensor] = None
    n_valid: Optional[int] = None
    # prefill mode: per-row real token counts [B] of a ragged
    # (right-padded) batch; windowed models need them to keep pad-tail
    # K/V out of a rolling cache (None = batch is unpadded)
    seq_lens: Optional[torch.Tensor] = None
    # paged KV layout: per-row physical block ids [B, nb]; cache leaves are
    # block-major [n_blocks, block_size, ...] and attention reads and
    # writes through the table
    block_tables: Optional[torch.Tensor] = None
    # contiguous KV layout (block_tables None): the cache row of each batch
    # row [B] int32 in the [R, S, ...] leaves, read and written in place
    # (None: the cache holds exactly the batch's rows, in order)
    rows: Optional[torch.Tensor] = None
    # vlm: the image patch embeddings [B, P, d] the cross-attention layers
    # read at prefill (the stubbed vision tower's output)
    patches: Optional[torch.Tensor] = None
    # whisper: the encoder's output [B, Se, d], which the decoder's
    # cross-attention reads at prefill
    enc_out: Optional[torch.Tensor] = None
    # prefill attention's kv tile (its plain version's; ModelOptions)
    kv_block: int = 512
    # int8 KV cache: {k, v} int8 with bf16 scales {ks, vs}
    kv_quant: bool = False
    # a shared expert inside the MoE FFN's sum (ModelOptions)
    fuse_shared_expert: bool = False


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """One layer group's cache leaf: its shape, dtype and which axis of
    the shape is the batch's."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    batch_axis: int = 0


@dataclasses.dataclass
class Stack:
    """``apply(group_params, x, ctx, cache_group) -> x``; the group's
    cache is updated in place (in prefill mode it receives the group's
    fresh state or K/V: ``Model.prefill_cache`` allocates it, or, for the
    hybrid, ssm and vlm families, ``Model.prefill`` from ``cache_spec``).
    A stack without a cache (the whisper encoder) gets ``cache_group``
    None.  ``cache_spec(batch, cache_len, dtype)``, where given, is one
    group's cache tree of :class:`CacheSpec` leaves, as the reference's
    ``Stack.cache_spec``."""

    n: int
    specs: PyTree
    apply: Callable
    cache_spec: Optional[Callable] = None


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_specs(stack: Stack) -> PyTree:
    """Per-group specs with the leading ``[groups]`` axis added."""
    return tree_map(lambda s: ParamSpec((stack.n,) + s.shape, s.init,
                                        s.fan_in, s.dtype), stack.specs)


def run_stack(stack: Stack, params_stacked: PyTree, x: torch.Tensor,
              ctx: Ctx, cache_stacked: PyTree = None) -> torch.Tensor:
    """Run the ``n`` groups in order; caches (nested dicts of [groups,
    ...] leaves, or None) are written in place."""
    for i in range(stack.n):
        cache = (None if cache_stacked is None
                 else tree_map(lambda c: c[i], cache_stacked))
        x = stack.apply(tree_map(lambda p: p[i], params_stacked), x, ctx,
                        cache)
    return x
