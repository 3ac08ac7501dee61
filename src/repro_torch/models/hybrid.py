"""RecurrentGemma / Griffin hybrid family: RG-LRU temporal blocks + local
attention, in repeating (rglru, rglru, attn) superblocks, each mixing block
followed by a gated-GeLU MLP residual.

Ports ``repro.models.hybrid``.  RG-LRU recurrence (fp32):
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t), with
a_t = exp(-c * softplus(Lambda) * r_t) and r/i = sigmoid(diag-gates(u_t)).
Prefill runs the recurrence as a log-depth doubling scan over the
sequence (the reference's ``jax.lax.associative_scan`` with the same
combine); decode is a single step.  The reference computes both outside
any Pallas kernel, so plain tensor arithmetic is the port here.  The
attention layers are :func:`repro_torch.models.transformer.
self_attn_block` over rolling rows of W slots: the flash kernel's window
band at prefill, the contiguous rolling decode kernel at decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamSpec, rmsnorm
from repro_torch.models.stacked import CacheSpec, Ctx, Stack
from repro_torch.models.transformer import (attn_specs, mlp_specs,
                                            self_attn_block, self_cache_spec)

RG_C = 8.0
CONV_W = 4


def rglru_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    dr = cfg.d_model  # lru width == d_model (recurrentgemma-9b)
    f32 = torch.float32
    return {
        "ln": ParamSpec((d,), "ones"),
        "wx": ParamSpec((d, dr)),
        "wg": ParamSpec((d, dr)),
        "conv_w": ParamSpec((CONV_W, dr), "small"),
        "conv_b": ParamSpec((dr,), "zeros"),
        "lam": ParamSpec((dr,), "ones", dtype=f32),
        "wa": ParamSpec((dr,), "small", dtype=f32),
        "ba": ParamSpec((dr,), "zeros", dtype=f32),
        "wi": ParamSpec((dr,), "small", dtype=f32),
        "bi": ParamSpec((dr,), "zeros", dtype=f32),
        "wout": ParamSpec((dr, d), fan_in=dr),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail=None):
    """Depthwise causal conv of width 4 over [B, S, dr] by shifted adds;
    returns it and the last CONV_W - 1 inputs (the decode state).
    Decode: u [B, dr] with ``tail`` [B, CONV_W - 1, dr]."""
    if u.dim() == 2:
        hist = torch.cat([tail, u[:, None, :]], 1)       # [B, 4, dr]
        y = torch.einsum("btd,td->bd", hist, w) + b
        return y, hist[:, 1:]
    pad = (torch.zeros((u.shape[0], CONV_W - 1, u.shape[2]), dtype=u.dtype,
                       device=u.device) if tail is None else tail)
    up = torch.cat([pad, u], 1)
    y = sum(up[:, i:i + u.shape[1]] * w[i] for i in range(CONV_W)) + b
    return y, up[:, -(CONV_W - 1):]


def _rglru_gates(p, u: torch.Tensor):
    """The recurrence's decay a and input (beta * i * u), fp32."""
    uf = u.float()
    r = torch.sigmoid(p["wa"] * uf + p["ba"])
    i = torch.sigmoid(p["wi"] * uf + p["bi"])
    lam = p["lam"]
    # jax.nn.softplus is logaddexp(x, 0)
    log_a = -RG_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
    return a, beta * (i * uf)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """States h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 over axis 1, by
    doubling (Hillis-Steele): after the step of offset o each position
    holds the combine of its last 2o inputs, with the reference's
    combine (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r), l the
    earlier; log2(S) steps of elementwise work."""
    o = 1
    s = a.shape[1]
    while o < s:
        b = torch.cat([b[:, :o], b[:, :-o] * a[:, o:] + b[:, o:]], 1)
        a = torch.cat([a[:, :o], a[:, :-o] * a[:, o:]], 1)
        o *= 2
    return b


def rglru_block(p, x: torch.Tensor, ctx: Ctx, cache,
                cfg: ArchConfig) -> torch.Tensor:
    """cache ``{"h": [B, dr] fp32, "conv": [B, 3, dr]}``, written in place
    (prefill: the last state and inputs; decode: one step), or None
    (train)."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    u = h @ p["wx"]
    gate = _gelu(h @ p["wg"])
    if ctx.mode == "decode":                              # x [B, d]
        u, tail = _causal_conv(u, p["conv_w"], p["conv_b"], cache["conv"])
        a, w_in = _rglru_gates(p, u)
        state = a * cache["h"] + w_in
        cache["h"].copy_(state)
        cache["conv"].copy_(tail)
        return x + (state.to(x.dtype) * gate) @ p["wout"]
    u, tail = _causal_conv(u, p["conv_w"], p["conv_b"])  # [B, S, dr]
    a, w_in = _rglru_gates(p, u)
    states = linear_scan(a, w_in)
    if ctx.mode == "prefill":
        cache["h"].copy_(states[:, -1])
        cache["conv"].copy_(tail)
    return x + (states.to(x.dtype) * gate) @ p["wout"]


def gelu_mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The hybrid family's MLP residual: GELU(h w1) * (h w3) w2."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + (_gelu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]


def hybrid_stack(cfg: ArchConfig) -> Stack:
    """(rglru, rglru, attn) superblocks, layers ``l<i>`` of {mix, ffn};
    each group's cache is ``{"l<i>": {h, conv} or {k, v}}``."""
    pattern = cfg.block_pattern
    n = (cfg.num_layers - len(cfg.tail_pattern)) // len(pattern)
    specs: Dict[str, Any] = {}
    for i, kind in enumerate(pattern):
        mix = rglru_specs(cfg) if kind == "rglru" else attn_specs(cfg)
        specs[f"l{i}"] = {"mix": mix, "ffn": mlp_specs(cfg)}

    def apply(gp, x, ctx: Ctx, cache_g):
        for i, kind in enumerate(pattern):
            lp = gp[f"l{i}"]
            c = None if cache_g is None else cache_g[f"l{i}"]
            block = rglru_block if kind == "rglru" else self_attn_block
            x = block(lp["mix"], x, ctx, c, cfg)
            x = gelu_mlp(lp["ffn"], x, cfg)
        return x

    dr = cfg.d_model

    def cache_spec(batch: int, cache_len: int, dtype):
        return {f"l{i}": ({"h": CacheSpec((batch, dr), torch.float32),
                           "conv": CacheSpec((batch, CONV_W - 1, dr), dtype)}
                          if kind == "rglru" else
                          self_cache_spec(cfg, batch, cache_len, dtype))
                for i, kind in enumerate(pattern)}

    return Stack(n, specs, apply, cache_spec)


def hybrid_tail_stack(cfg: ArchConfig) -> Stack:
    """The trailing layers (38 = 12 * 3 + 2 for recurrentgemma-9b): one
    group of ``cfg.tail_pattern``."""
    sub = dataclasses.replace(cfg, block_pattern=cfg.tail_pattern,
                              tail_pattern=(),
                              num_layers=len(cfg.tail_pattern))
    return hybrid_stack(sub)
