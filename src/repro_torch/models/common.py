"""Shared model numerics: RMSNorm, RoPE, sinusoidal positions, and the
port's random init.

Each function follows the reference's (``repro.models.common``) dtype
casts op for op, so the parity tests compare like with like.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * w


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (cos, sin) of shape [..., head_dim/2], fp32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., n_heads, head_dim]; cos/sin broadcastable [..., 1, head_dim/2]."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     -1).to(x.dtype)


def sinusoid_positions(length: int, d_model: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embedding [length, d_model]
    (bf16): computed in numpy float64, then rounded, as the reference
    does."""
    half = d_model // 2
    scale = np.log(10000.0) / max(half - 1, 1)
    inv = np.exp(-scale * np.arange(half))
    pos = np.arange(length)[:, None] * inv[None, :]
    emb = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    return torch.from_numpy(emb).to(torch.bfloat16)


def init_tensor(shape, init: str, generator: torch.Generator, *,
                device, fan_in: int = 0,
                dtype=torch.bfloat16) -> torch.Tensor:
    """One parameter under the reference's init schemes: ``zeros``,
    ``ones``, ``small`` (N(0, 0.02^2)) or ``normal`` (N(0, 1/fan_in)), drawn in
    fp32 from ``generator`` (which must live on ``device``) and cast.  A
    leaf above ``_DRAW_LIMIT`` elements is drawn one leading slice at a
    time (recursively) straight into its place, so neither its fp32 draw
    nor a copy of a slice adds to the memory it takes (a stacked expert
    leaf of mixtral-8x7b is 7.5 G elements, of llama4-maverick 10.7 G)."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan = fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])
    scale = 0.02 if init == "small" else 1.0 / math.sqrt(max(fan, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    _draw_into(out, scale, generator)
    return out


def _draw_into(out: torch.Tensor, scale: float,
               generator: torch.Generator) -> None:
    """Fill ``out`` with N(0, scale^2) drawn in fp32, one leading slice at
    a time while it is above ``_DRAW_LIMIT`` elements."""
    if out.numel() > _DRAW_LIMIT and out.dim() > 1:
        for part in out:
            _draw_into(part, scale, generator)
        return
    x = torch.randn(out.shape, generator=generator, dtype=torch.float32,
                    device=out.device)
    out.copy_(x * scale)


_DRAW_LIMIT = 1 << 30


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + init scheme (see :func:`init_tensor`)
    + dtype."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | small
    fan_in: int = 0
    dtype: torch.dtype = torch.bfloat16
