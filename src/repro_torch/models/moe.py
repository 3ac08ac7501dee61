"""Sparse mixture-of-experts FFN with sort-based dispatch.

A port of ``repro.models.moe`` on one device: ``moe_specs``,
``_capacity``, ``_moe_local`` without a mesh axis, and the plain branch
of ``moe_ffn``; expert parallelism waits for the port's multi-card path
(ROADMAP.md).  Tokens are routed to their top-k experts, sorted by
expert, and packed into per-expert buffers of ``_capacity`` slots; tokens
past an expert's capacity are dropped.  The expert products are batched
matrix products, as the reference leaves them to XLA.

Parity with the reference is about order and ties, not arithmetic: the
top k are taken with a stable descending sort (``jax.lax.top_k`` breaks
ties to the lower index; ``torch.topk`` leaves the order unspecified),
the dispatch sort is stable (``jnp.argsort``), and the combine adds the
gated expert outputs in the activations' dtype, as the reference's
scatter-add does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import ParamSpec


def moe_specs(d_model: int, moe: MoEConfig) -> Dict[str, ParamSpec]:
    e, ff = moe.num_experts, moe.expert_d_ff
    if ff <= 0:
        raise ValueError("MoEConfig.expert_d_ff must be set")
    return {
        "router": ParamSpec((d_model, e), "small"),
        "w1": ParamSpec((e, d_model, ff)),
        "w3": ParamSpec((e, d_model, ff)),
        "w2": ParamSpec((e, ff, d_model), fan_in=ff),
    }


def capacity(tokens: int, moe: MoEConfig) -> int:
    """Slots per expert for ``tokens`` routed tokens: the capacity factor's
    share, rounded up to 8 (at least 8) from 64 tokens on, else at least
    4."""
    c = int(math.ceil(tokens * moe.top_k * moe.capacity_factor
                      / moe.num_experts))
    return max(8, int(math.ceil(c / 8)) * 8) if tokens >= 64 else max(c, 4)


def moe_local(x2d: torch.Tensor, params, moe: MoEConfig,
              shared: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
    """MoE over tokens x2d [T, d] -> [T, d] (the reference's
    ``_moe_local`` with every expert on this device).  ``shared``
    (``{w1, w3, w2}``, llama4's shared expert in its fused form): its
    SwiGLU of every token is added to the routed sum before the final
    cast, as the reference folds it into the routed experts' sum."""
    t, d = x2d.shape
    e, k = moe.num_experts, moe.top_k
    cap = capacity(t, moe)
    logits = (x2d @ params["router"]).float()                  # [T, E]
    gate_vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(gate_vals[:, :k], dim=-1)  # over the selected k
    expert_flat = ids[:, :k].reshape(-1)             # [T*k], token-major
    gate_flat = gates.reshape(-1)
    token_flat = torch.arange(t * k, device=x2d.device) // k
    order = torch.argsort(expert_flat, stable=True)
    se, st, sg = expert_flat[order], token_flat[order], gate_flat[order]
    starts = torch.searchsorted(se, torch.arange(e, device=x2d.device))
    pos = torch.arange(t * k, device=x2d.device) - starts[se]  # slot in expert
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))
    # each kept (token, expert) pair owns one buffer row; the dropped ones
    # share the dump row e * cap, which is cut off
    xb = x2d.new_zeros((e * cap + 1, d)).index_put_((dest,), x2d[st],
                                                    accumulate=True)
    h = xb[:e * cap].reshape(e, cap, d)
    a = torch.bmm(h, params["w1"])
    b = torch.bmm(h, params["w3"])
    y = torch.bmm(F.silu(a) * b, params["w2"])                 # [E, C, d]
    y_flat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    contrib = y_flat[dest] * sg[:, None].to(y.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    out = y.new_zeros((t, d)).index_put_((st,), contrib, accumulate=True)
    if shared is not None:
        a = F.silu(x2d @ shared["w1"]) * (x2d @ shared["w3"])
        out = out + (a @ shared["w2"]).to(out.dtype)
    return out.to(x2d.dtype)


def moe_ffn(x: torch.Tensor, params, moe: MoEConfig,
            shared: Optional[Dict[str, torch.Tensor]] = None
            ) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: every token of the batch, padding
    included, is routed together, as in the reference; ``shared`` as
    :func:`moe_local`."""
    return moe_local(x.reshape(-1, x.shape[-1]), params, moe,
                     shared).reshape(x.shape)
