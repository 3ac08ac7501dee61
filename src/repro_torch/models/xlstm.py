"""xLSTM family: mLSTM (matrix memory) + sLSTM (scalar memory) blocks.

Ports ``repro.models.xlstm``.  mLSTM prefill runs the chunkwise-parallel
form (log-space exp-gating with a running stabiliser): within a chunk of
CHUNK tokens attention-like [T, T] products, between chunks the state
(C, n, m) carried in order; decode is one step of the recurrence.  sLSTM
reads h_{t-1} through recurrent block-diagonal weights, so it runs token
by token; 1 block in 8 is sLSTM (xlstm-1.3b: 6 groups of 1 sLSTM + 7
mLSTM).  Every gate and state stays fp32, as in the reference, which
computes all of it outside any Pallas kernel: plain tensor arithmetic is
the port here.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamSpec, rmsnorm
from repro_torch.models.stacked import CacheSpec, Ctx, Stack, stack_specs, \
    tree_map

CHUNK = 128


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h = cfg.num_heads
    return {
        "ln": ParamSpec((d,), "ones"),
        "wu": ParamSpec((d, 2 * d)),               # (cell input, z gate)
        "wq": ParamSpec((d, d)),
        "wk": ParamSpec((d, d)),
        "wv": ParamSpec((d, d)),
        "wif": ParamSpec((d, 2 * h), "small"),     # per-head i, f
        "wog": ParamSpec((d, d), "small"),         # output gate
        "wd": ParamSpec((d, d)),                   # down projection
        "gn": ParamSpec((d,), "ones"),             # per-head norm
    }


def _mlstm_qkvif(p, xm: torch.Tensor, cfg: ArchConfig):
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    lead = xm.shape[:-1]
    q = (xm @ p["wq"]).reshape(*lead, h, hd)
    k = ((xm @ p["wk"]) * (hd ** -0.5)).reshape(*lead, h, hd)
    v = (xm @ p["wv"]).reshape(*lead, h, hd)
    gif = (xm @ p["wif"]).float().reshape(*lead, 2, h)
    i_raw, f_raw = gif[..., 0, :], gif[..., 1, :]
    return q, k, v, i_raw, F.logsigmoid(f_raw)


def _mlstm_chunk(q, k, v, i_raw, f_log, carry):
    """One chunk, batched over [B, H]: q/k/v [B, T, H, hd]; gates [B, T,
    H]; carry (C [B, H, dk, dv], n [B, H, dk], m [B, H]), the stabilised
    state.  Returns the new carry and the chunk's outputs [B, T, H, hd]."""
    C, n, m = carry
    t = q.shape[1]
    Fc = torch.cumsum(f_log, 1)                          # [B, T, H]
    g = i_raw - Fc                                       # log i_j - F_j
    M = torch.cummax(g, 1).values                        # running max
    m_i = Fc + torch.maximum(m[:, None], M)              # [B, T, H]

    # intra-chunk: D_ij = exp(F_i - F_j + i_j - m_i), j <= i
    logD = (Fc[:, :, None] - Fc[:, None, :] + i_raw[:, None, :]
            - m_i[:, :, None])
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))
    D = torch.where(causal[None, :, :, None], torch.exp(logD),
                    torch.zeros((), device=q.device))  # [B, Ti, Tj, H]
    qf, kf, vf = q.float(), k.float(), v.float()
    s_att = torch.einsum("bihd,bjhd->bijh", qf, kf) * D
    h_intra = torch.einsum("bijh,bjhd->bihd", s_att, vf)
    n_intra = torch.einsum("bijh,bjhd->bihd", D, kf)

    # inter-chunk
    scale_i = torch.exp(Fc + m[:, None] - m_i)           # [B, T, H]
    h_inter = torch.einsum("bihd,bhde->bihe", qf, C) * scale_i[..., None]
    n_inter = n[:, None] * scale_i[..., None]
    n_i = n_intra + n_inter

    denom = torch.maximum(torch.einsum("bihd,bihd->bih", qf, n_i).abs(),
                          torch.exp(-m_i))
    h_out = (h_intra + h_inter) / denom[..., None]

    # the carry at the chunk's end
    F_T = Fc[:, -1]                                      # [B, H]
    m_new = F_T + torch.maximum(m, M[:, -1])
    w_j = torch.exp(F_T[:, None] - Fc + i_raw - m_new[:, None])  # [B, T, H]
    decay = torch.exp(F_T + m - m_new)
    C_new = C * decay[..., None, None] + torch.einsum(
        "bthd,bthe,bth->bhde", kf, vf, w_j)
    n_new = n * decay[..., None] + torch.einsum("bthd,bth->bhd", kf, w_j)
    return (C_new, n_new, m_new), h_out


def mlstm_block(p, x: torch.Tensor, ctx: Ctx, cache,
                cfg: ArchConfig) -> torch.Tensor:
    """cache ``{"C": [B, H, hd, hd], "n": [B, H, hd], "m": [B, H]}`` fp32,
    written in place (prefill: the state after the prompt; decode: one
    step), or None (train)."""
    h_heads, hd = cfg.num_heads, cfg.resolved_head_dim
    d = cfg.d_model
    hx = rmsnorm(x, p["ln"], cfg.norm_eps)
    u = hx @ p["wu"]
    xm, zg = u[..., :d], u[..., d:]
    q, k, v, i_raw, f_log = _mlstm_qkvif(p, xm, cfg)

    if ctx.mode == "decode":                             # x [B, d]
        C, n, m = cache["C"], cache["n"], cache["m"]
        m_new = torch.maximum(f_log + m, i_raw)
        fs = torch.exp(f_log + m - m_new)
        is_ = torch.exp(i_raw - m_new)
        kf, vf, qf = k.float(), v.float(), q.float()
        C_new = C * fs[..., None, None] + is_[..., None, None] * \
            torch.einsum("bhd,bhe->bhde", kf, vf)
        n_new = n * fs[..., None] + is_[..., None] * kf
        denom = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                              torch.exp(-m_new))
        hv = torch.einsum("bhd,bhde->bhe", qf, C_new) / denom[..., None]
        for key, val in (("C", C_new), ("n", n_new), ("m", m_new)):
            cache[key].copy_(val)
        return x + _mlstm_out(p, hv.reshape(-1, d), zg, xm, cfg)

    # chunks of CHUNK tokens, the last one short where CHUNK does not
    # divide S (the reference halves its chunk until it divides S: 1-token
    # chunks at an odd S; the same recurrence, summed in other groups)
    b, s, _ = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((b, h_heads, hd, hd), **f32),
             torch.zeros((b, h_heads, hd), **f32),
             torch.full((b, h_heads), -1e30, **f32))
    outs = []
    for c0 in range(0, s, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        carry, h_out = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl],
                                    i_raw[:, sl], f_log[:, sl], carry)
        outs.append(h_out)
    hv = torch.cat(outs, 1).reshape(b, s, d)
    if ctx.mode == "prefill":
        for key, val in zip("Cnm", carry):
            cache[key].copy_(val)
    return x + _mlstm_out(p, hv, zg, xm, cfg)


def _mlstm_out(p, hv: torch.Tensor, zg: torch.Tensor, xm: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    shape = hv.shape
    hn = rmsnorm(hv.reshape(*shape[:-1], h, hd), p["gn"].reshape(h, hd),
                 cfg.norm_eps).reshape(shape)
    og = torch.sigmoid((xm @ p["wog"]).float()).to(zg.dtype)
    return (hn.to(zg.dtype) * og * F.silu(zg)) @ p["wd"]


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    ffs = int(round(4 * d / 3 / 8)) * 8
    sp = {"ln": ParamSpec((d,), "ones")}
    for gname in "zifo":
        sp[f"w{gname}"] = ParamSpec((d, d))
        sp[f"r{gname}"] = ParamSpec((h, hd, hd), "small")
        sp[f"b{gname}"] = ParamSpec((d,), "zeros", dtype=torch.float32)
    sp.update(
        gn=ParamSpec((d,), "ones"),
        w1=ParamSpec((d, ffs)),
        w3=ParamSpec((d, ffs)),
        w2=ParamSpec((ffs, d), fan_in=ffs),
    )
    return sp


def _slstm_step(r: torch.Tensor, pre, carry):
    """One token.  r: the four recurrent weights side by side, [H, hd,
    4 hd] fp32 (z, i, f, o); pre: the four pre-activations [B, H, hd]
    fp32; carry (h, c, n, m) fp32 [B, H, hd]."""
    hprev, c, n, m = carry
    rz, ri, rf, ro = torch.einsum("bhd,hde->bhe", hprev, r).chunk(4, -1)
    xz, xi, xf, xo = pre
    z = torch.tanh(xz + rz)
    i_raw = xi + ri
    f_log = F.logsigmoid(xf + rf)
    o = torch.sigmoid(xo + ro)
    m_new = torch.maximum(f_log + m, i_raw)
    fs, is_ = torch.exp(f_log + m - m_new), torch.exp(i_raw - m_new)
    c = fs * c + is_ * z
    n = fs * n + is_
    h_new = o * (c / torch.maximum(n, torch.exp(-m_new)))
    return h_new, c, n, m_new


def slstm_block(p, x: torch.Tensor, ctx: Ctx, cache,
                cfg: ArchConfig) -> torch.Tensor:
    """cache ``{"h", "c", "n", "m"}`` fp32 [B, H, hd], written in place
    (prefill: the state after the prompt; decode: one step), or None
    (train).  Prefill loops over the tokens."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    hx = rmsnorm(x, p["ln"], cfg.norm_eps)
    pre = [(hx @ p[f"w{g}"] + p[f"b{g}"].to(x.dtype)).float()
           .reshape(*x.shape[:-1], h, hd) for g in "zifo"]
    r = torch.cat([p[f"r{g}"] for g in "zifo"], -1).float()

    if ctx.mode == "decode":                             # x [B, d]
        carry = _slstm_step(r, pre, tuple(cache[kk] for kk in "hcnm"))
        for kk, val in zip("hcnm", carry):
            cache[kk].copy_(val)
        return x + _slstm_out(p, carry[0][:, None], x[:, None, :], cfg)[:, 0]

    b, s = x.shape[:2]
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((b, h, hd), **f32), torch.zeros((b, h, hd), **f32),
             torch.zeros((b, h, hd), **f32),
             torch.full((b, h, hd), -1e30, **f32))
    hseq = []
    for i in range(s):
        carry = _slstm_step(r, [a[:, i] for a in pre], carry)
        hseq.append(carry[0])
    if ctx.mode == "prefill":
        for kk, val in zip("hcnm", carry):
            cache[kk].copy_(val)
    return x + _slstm_out(p, torch.stack(hseq, 1), x, cfg)


def _slstm_out(p, hseq: torch.Tensor, x: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    h, hd, d = cfg.num_heads, cfg.resolved_head_dim, cfg.d_model
    hn = rmsnorm(hseq, p["gn"].reshape(h, hd), cfg.norm_eps)
    hn = hn.reshape(*hseq.shape[:-2], d).to(x.dtype)
    a = F.gelu(hn @ p["w1"], approximate="tanh") * (hn @ p["w3"])
    return a @ p["w2"]


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def xlstm_stack(cfg: ArchConfig) -> Stack:
    """Groups of 1 sLSTM and ``xlstm_group - 1`` mLSTM blocks (``slstm``
    and ``mlstm``, the mLSTM leaves stacked a second time: [groups, n_m,
    ...]); each group's cache is ``{"slstm": {h, c, n, m}, "mlstm": {C, n,
    m}}``, the mLSTM leaves [n_m, B, ...]."""
    group = cfg.xlstm_group or 4
    n_s = cfg.xlstm_slstm_per_group
    n_m = group - n_s
    n = cfg.num_layers // group
    specs = {"mlstm": stack_specs(Stack(n_m, mlstm_specs(cfg), None))}
    if n_s:
        specs["slstm"] = slstm_specs(cfg)

    def apply(gp, x, ctx: Ctx, cache_g):
        if n_s:
            x = slstm_block(gp["slstm"], x, ctx,
                            None if cache_g is None else cache_g["slstm"],
                            cfg)
        for j in range(n_m):
            c = (None if cache_g is None
                 else tree_map(lambda a: a[j], cache_g["mlstm"]))
            x = mlstm_block(tree_map(lambda a: a[j], gp["mlstm"]), x, ctx, c,
                            cfg)
        return x

    h, hd = cfg.num_heads, cfg.resolved_head_dim

    def cache_spec(batch: int, cache_len: int, dtype):
        f32 = torch.float32
        c = {"mlstm": {
            "C": CacheSpec((n_m, batch, h, hd, hd), f32, batch_axis=1),
            "n": CacheSpec((n_m, batch, h, hd), f32, batch_axis=1),
            "m": CacheSpec((n_m, batch, h), f32, batch_axis=1)}}
        if n_s:
            leaf = CacheSpec((batch, h, hd), f32)
            c["slstm"] = {kk: leaf for kk in "hcnm"}
        return c

    return Stack(n, specs, apply, cache_spec)
