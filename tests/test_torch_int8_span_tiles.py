"""The four int8 span kernels (PERF.md rows 7 and 10: the full cache,
paged and over contiguous rows; rows 8 and 12: the rolling cache) share
one tiled body, csrc/span_attention_quant_tiled.cuh, which runs only on
the card.  Here, on the CPU:

(a) their plain versions against the reference's jnp oracles (and, where
    the grid is small, its Pallas kernels in interpret mode) on the
    layouts the tiled body must get right: rows interleaved in seq_idx,
    runs that straddle a query tile (64 / g tokens: 32 at g 2, 4 at g
    16), g 16, wrapped rows, a table narrower than W / bs, bucket padding,
    and p-tiles of 16, 32, 64, 72 and 512 slots beside the body's 64-slot
    sub-tiles;
(b) the body's fold, mirrored in torch: each row's tokens in index order
    cut into query tiles, each p-tile's visible 64-slot sub-tiles in three
    passes (max; p, sum and max |p vs|; p8 and the int8 product), both
    dots as exact integer products, masked scores -inf, sub-tiles no
    query row of the tile sees skipped, then (rolling) the fresh span as
    bf16 hi + lo in log2 units.  Its p8 and ps equal the plain version's
    bit for bit wherever the row has seen a slot, and its output is within
    the limit chip_smoke.py holds the kernels to;
(c) the argument that skipping is exact: the mirror with skipping and -inf
    masks against the same fold over every p-tile with the plain
    version's -1e30 masks (where a row that has seen nothing gets p = 1
    until its first visible score wipes those terms), bit for bit;
(d) the CUDA wrappers' shape check.

Tolerances: fp32 1e-5 (the same operations, summed in other orders);
bf16 2e-2 (both packages round to bf16 after each operation, XLA in a few
other places).  The Pallas kernels keep the int8 q and p scales in fp32
where quantize_kv rounds them to bf16: 2e-2 against them, as in
tests/test_torch_rolling.py.  The limit of (b) is ``kernels/_paged.py``'s
KERNEL_REL / KERNEL_ABS."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.span_attention import (
    paged_span_attention_quant as pallas_paged_quant,
    paged_span_attention_rolling_quant as pallas_paged_rolling_quant,
    span_attention_quant as pallas_rows_quant,
    span_attention_rolling_quant as pallas_rows_rolling_quant)
from repro.models import attention as A
from repro_torch.kernels import _paged
from repro_torch.kernels import span_attention as ksa
from repro_torch.models import attention as P

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PALLAS = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WIDTHS = [(2, 16), (16, 16)]     # (g, hd): mixtral-smoke's g, and g 16
KV_BLOCKS = (16, 512)
LOG2E = 1.4426950408889634
NONE = -1e30
FLIP = 16       # ulps of x within which two exps may round p8 apart

# name: (window (0: full cache), spans, pad, order, nb, bs).  spans[r] =
# (off, c): full cache, row r's span is positions off..off+c-1 (the cache
# holds them); rolling, row r holds positions [0, off) and the span brings
# off..off+c-1.  nb: the table's width (default: the widest row).
CASES = {
    # full cache: interleaved runs of 37 and 19 beside a 1-token row and a
    # row of 9 (nb * bs = 72: p-tiles of 72 and 8)
    "full": (0, [(0, 37), (20, 19), (5, 1), (60, 9)], 0, "interleaved", None,
             4),
    # full cache over 512 slots: p-tiles of 16 and 512
    "full_long": (0, [(0, 21), (250, 30), (500, 12)], 0, "packed", None, 16),
    # rolling: decode rows beside chunks of 37 (from off = 0) and 19, padded
    "mixed": (32, [(0, 37), (40, 1), (70, 1), (13, 19), (5, 1)], 3,
              "interleaved", None, 4),
    # rows wrapped many times; a decode row at off = W; a run of 41
    "wrapped": (64, [(200, 23), (64, 1), (130, 41)], 0, "packed", None, 4),
    # a table of 32 slots < W = 64: no row has wrapped
    "narrow": (64, [(3, 21), (9, 1), (0, 5)], 2, "interleaved", 8, 4),
    # W = 512: p-tiles of 16 and 512; a run whose later tokens' arcs
    # start past slot 16
    "long": (512, [(700, 9), (150, 11), (500, 40), (511, 1)], 1,
             "interleaved", None, 16),
}
SMALL = ("full", "mixed", "wrapped", "narrow")    # Pallas-sized grids
# the fold's mirror at every case and width, and at g 5 (llama4's 40 / 8:
# 12 tokens x 5 heads a query tile, 4 idle rows) on the smaller cases
FOLD = [(g, hd, name) for g, hd in WIDTHS for name in CASES] \
    + [(5, 16, name) for name in SMALL]


def _case(seed, name, g, hd, kv=None):
    """Numpy inputs of both layouts: a shuffled paged int8 cache
    [n_phys, bs, Kv, hd] (bf16 scales [n_phys, bs, Kv], as fp32) with
    tables [B, nb], and its rows [B, nb * bs, Kv, hd] (the gathered view:
    one logical cache), the queries and (rolling) the fresh span."""
    window, spans, pad, order, nb, bs = CASES[name]
    kv = kv or (1 if g == 16 else 2)
    rng = np.random.default_rng(seed)
    if window:
        need = [min(-(-(o + c) // bs), window // bs) for o, c in spans]
    else:
        need = [-(-(o + c) // bs) for o, c in spans]
    nb = nb or max(need)
    n_phys = len(spans) * nb + 3
    perm = rng.permutation(n_phys - 1)
    tables = np.full((len(spans), nb), n_phys - 1, np.int32)
    used = 0
    for r, k in enumerate(need):
        tables[r, :k] = perm[used:used + k]
        used += k
    seq = np.concatenate([np.full(c, r) for r, (_, c) in enumerate(spans)])
    pos = np.concatenate([o + np.arange(c) for o, c in spans])
    if order == "interleaved":
        # round robin over the rows: every row's tokens lie apart
        rank = np.concatenate([np.arange(c) for _, c in spans])
        idx = np.lexsort((seq, rank))
        seq, pos = seq[idx], pos[idx]
    offs = np.array([spans[r][0] for r in seq])
    n_valid = len(seq)
    seq, pos, offs = (np.concatenate([a, np.repeat(a[-1:], pad)])
                      for a in (seq, pos, offs))
    t, h = len(seq), kv * g
    cache = {}
    for n in "kv":
        x8, xs = P.quantize_kv(torch.tensor(
            rng.standard_normal((n_phys, bs, kv, hd), np.float32)))
        cache[n], cache[n + "s"] = x8.numpy(), xs.float().numpy()
    gather = lambda a: a[tables].reshape(len(spans), nb * bs, *a.shape[2:])
    k_span = rng.standard_normal((t, kv, hd), np.float32)
    v_span = rng.standard_normal((t, kv, hd), np.float32)
    k_span[n_valid:], v_span[n_valid:] = k_span[n_valid - 1], v_span[n_valid - 1]
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(q=rng.standard_normal((t, h, hd), np.float32),
                **cache, **{f"{n}_rows": gather(cache[n])
                            for n in ("k", "ks", "v", "vs")},
                k_span=k_span, v_span=v_span, tables=tables, pos=i32(pos),
                seq=i32(seq), offs=i32(offs), n_valid=n_valid,
                window=window, g=g)


SCALES = ("ks", "vs", "ks_rows", "vs_rows")


def _jax(case, dt):
    out = {}
    for n, a in case.items():
        if not isinstance(a, np.ndarray):
            out[n] = a
        elif n in SCALES:
            out[n] = jnp.asarray(a, jnp.bfloat16)
        else:
            out[n] = jnp.asarray(a, dt) if a.dtype == np.float32 \
                else jnp.asarray(a)
    return out


def _torch(case, dt):
    out = {}
    for n, a in case.items():
        if not isinstance(a, np.ndarray):
            out[n] = a
        elif n in SCALES:
            out[n] = torch.tensor(a).bfloat16()
        else:
            out[n] = torch.tensor(a).to(dt) if a.dtype == np.float32 \
                else torch.tensor(a)
    return out


def _args(c, layout):
    """The wrapper's positional arguments, in both packages' order."""
    rolling = bool(c["window"])
    if layout == "paged":
        cache = (c["k"], c["ks"], c["v"], c["vs"])
    else:
        cache = (c["k_rows"], c["ks_rows"], c["v_rows"], c["vs_rows"])
    span = (c["k_span"], c["v_span"]) if rolling else ()
    tables = (c["tables"],) if layout == "paged" else ()
    index = (c["pos"], c["seq"]) + ((c["offs"], c["n_valid"]) if rolling
                                    else ())
    return (c["q"], *cache, *span, *tables, *index)


def _port(layout, rolling):
    return {("paged", False): ksa.paged_span_attention_quant,
            ("rows", False): ksa.span_attention_quant,
            ("paged", True): ksa.paged_span_attention_rolling_quant,
            ("rows", True): ksa.span_attention_rolling_quant}[layout, rolling]


def _plain(layout, rolling):
    return {("paged", False): ksa.paged_span_attention_quant_plain,
            ("rows", False): ksa.span_attention_quant_plain,
            ("paged", True): ksa.paged_span_attention_rolling_quant_plain,
            ("rows", True): ksa.span_attention_rolling_quant_plain}[
                layout, rolling]


def _oracle(layout, rolling):
    return {("paged", False): A.paged_span_attention_quant_native,
            ("rows", False): A.packed_span_attention_quant,
            ("paged", True): A.paged_span_attention_rolling_quant_native,
            ("rows", True): A.packed_span_attention_rolling_quant}[
                layout, rolling]


def _kw(c, kv_block):
    return dict(kv_block=kv_block, **({"window": c["window"]}
                                      if c["window"] else {}))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _width(case, layout):
    return case["k_rows"].shape[1] if layout == "rows" else \
        case["tables"].shape[1] * case["k"].shape[1]


# ---------------------------------------------------------------------------
# (a) the plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["paged", "rows"])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("g,hd", WIDTHS)
def test_int8_span_plain_matches_oracles(g, hd, name, layout, dtype):
    """Rows 7, 10, 8 and 12's plain versions against the reference's jnp
    oracles (the table-walking native when paged), at the engine's p-tile
    (kv_block 512) and at 16-slot p-tiles.  PyTorch's and XLA's fp32 exp
    differ in the last bit on ~10% of inputs, so a p8 whose x = p vs /
    scale lies within a few ulps of a rounding half-integer may be one
    step apart: the tolerance adds FLIP's term (one p8 step at each such
    slot, from the fold's mirror on the same values), which is 0 on all
    but a handful of elements."""
    case = _case(31 * g + hd, name, g, hd)
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    rolling = bool(case["window"])
    for kv_block in KV_BLOCKS:
        out = _port(layout, rolling)(*_args(t, layout), **_kw(case, kv_block))
        assert out.shape == (len(case["pos"]), t["q"].shape[1] * hd)
        ref = torch.tensor(np.asarray(_oracle(layout, rolling)(
            *_args(j, layout), **_kw(case, kv_block)), np.float32))
        _, term = _fold(t, layout, P.kv_tile(kv_block, _width(case, layout)),
                        flips=True)
        excess = (out.float() - ref).abs() - TOL[dtype] * (1 + ref.abs()) \
            - term
        assert float(excess.max()) <= 0, (kv_block, float(excess.max()))


@pytest.mark.parametrize("layout", ["paged", "rows"])
@pytest.mark.parametrize("name", SMALL)
def test_int8_span_plain_matches_pallas_interpret(name, layout):
    """The Pallas kernels in interpret mode (fp32; paged: one-page p-tiles,
    the Pallas kernel's; rows: kv_block 16), at g 2, hd 16."""
    case = _case(37, name, 2, 16)
    j, t = _jax(case, jnp.float32), _torch(case, torch.float32)
    rolling = bool(case["window"])
    bs = case["k"].shape[1]
    if layout == "paged":
        tail = (j["pos"], j["seq"])
        if rolling:
            tail += (j["offs"], jnp.asarray([case["n_valid"]], jnp.int32))
            ref = pallas_paged_rolling_quant(
                j["q"], j["k"], j["ks"], j["v"], j["vs"], j["k_span"],
                j["v_span"], *tail, j["tables"], window=case["window"],
                interpret=True)
        else:
            ref = pallas_paged_quant(j["q"], j["k"], j["ks"], j["v"],
                                     j["vs"], *tail, j["tables"],
                                     interpret=True)
        kv_block = bs
    else:
        kv_block = 16
        if rolling:
            ref = pallas_rows_rolling_quant(
                *_args(j, "rows")[:-1],
                jnp.asarray([case["n_valid"]], jnp.int32),
                window=case["window"], kv_block=kv_block, interpret=True)
        else:
            ref = pallas_rows_quant(*_args(j, "rows"), kv_block=kv_block,
                                    interpret=True)
    out = _port(layout, rolling)(*_args(t, layout), **_kw(case, kv_block))
    _close(out, ref, TOL_PALLAS)


# ---------------------------------------------------------------------------
# (b) the tiled body's fold
# ---------------------------------------------------------------------------

def _visible(pos, offs, w, window, slots):
    """[n, len(slots)] old-cache slots each token sees: a prefix from slot
    0 (full cache) or the plain version's rolling mask."""
    if not window:
        return slots[None, :] < torch.clamp(pos.long() + 1, max=w)[:, None]
    return P._rolling_mask(slots, offs, pos, w, window)


def _hi_lo(p):
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def _fold(c, layout, tile, *, skip=True, record=None, events=None,
          flips=False):
    """csrc/span_attention_quant_tiled.cuh's fold in torch on the case's
    values (the gathered rows, whose width is the layout's: nb * bs paged,
    S over rows).  skip: visit only the sub-tiles some token of the query
    tile sees, with -inf masks (the kernel); else every sub-tile of every
    p-tile over the width with the plain version's -1e30 masks.
    record[(t, P)]: (p8 [Kv, G, tile], ps [Kv, G], seen [Kv, G]) of each
    visited p-tile.  events: counts of rows folded over a p-tile they do
    not see, before ("unseen") and after ("seen") their first visible
    slot.  Returns [T, H * hd] bf16 and, with ``flips``, FLIP's term
    [T, H * hd]: the sum over the visible slots whose x = p vs / scale
    lies within FLIP ulps of a rounding half-integer of ps |v8[s, d]|
    (one p8 step), rescaled as the accumulator and divided by l."""
    q = c["q"].float()
    t, h, hd = q.shape
    g = c["g"]
    kv = h // g
    k8, ks, v8, vs = (c[n + "_rows"] for n in ("k", "ks", "v", "vs"))
    w = _width(c, layout)
    k8, ks, v8, vs = (x[:, :w] for x in (k8, ks, v8, vs))
    window, pos, seq, offs = c["window"], c["pos"], c["seq"], c["offs"]
    scale = hd ** -0.5
    q8, qs = P.quantize_kv(q.reshape(t, kv, g, hd))
    mask_value = float("-inf") if skip else NONE
    out = torch.zeros((t, kv, g, hd))
    term = torch.zeros((t, kv, g, hd))
    tq = _paged.QUERY_ROWS // g
    for r in sorted(set(seq.tolist())):
        mine = [u for u in range(t) if seq[u] == r]
        for i in range(0, len(mine), tq):
            toks = torch.tensor(mine[i:i + tq])
            n = len(toks)
            slots = torch.arange(w)
            vis = _visible(pos[toks], offs[toks], w, window, slots)
            if window:
                n_old = int(torch.clamp(offs[toks].long(), max=w).max())
            else:
                n_old = int(torch.clamp(pos[toks].long() + 1, max=w).max())
            m = torch.full((n, kv, g), NONE)
            l = torch.zeros((n, kv, g))
            acc = torch.zeros((n, kv, g, hd))
            tacc = torch.zeros((n, kv, g, hd))
            for p0 in range(0, w if not skip else n_old, tile):
                subs = [(s0, min(s0 + 64, p0 + tile))
                        for s0 in range(p0, p0 + tile, 64)]
                if skip:
                    subs = [(s0, s1) for s0, s1 in subs if s0 < n_old and
                            bool(vis[:, s0:min(s1, n_old)].any())]
                if not subs:
                    continue
                sl = torch.cat([torch.arange(s0, s1) for s0, s1 in subs])
                s32 = torch.einsum("tkgd,skd->tkgs", q8[toks].long(),
                                   k8[r, sl].long())
                sc = s32.float() * qs[toks].float()[..., None] \
                    * ks[r, sl].float().T[None, :, None, :] * scale
                v = vis[:, sl][:, None, None, :]
                sc = torch.where(v, sc, torch.full_like(sc, mask_value))
                mn = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - mn[..., None])
                pv = p * vs[r, sl].float().T[None, :, None, :]
                amax = pv.abs().amax(-1)
                sp = amax / torch.full_like(amax, 127.0) + 1e-8
                p8 = torch.clamp(torch.round(pv / sp[..., None]), -127, 127)
                ps = sp.bfloat16().float()
                corr = torch.exp(m - mn)
                if events is not None:
                    sees = v.any(-1).expand(n, kv, g)
                    events["unseen"] += int((~sees & (m == NONE)).sum())
                    events["seen"] += int((~sees & (m > NONE)).sum())
                # a sequential sum: zeros of skipped slots change no bit
                l = l * corr + torch.cumsum(p, -1)[..., -1]
                o32 = torch.einsum("tkgs,skd->tkgd", p8.long(), v8[r, sl].long())
                acc = acc * corr[..., None] + o32.float() * ps[..., None]
                if flips:
                    ax = (pv / sp[..., None]).abs().double()
                    near = ((ax - torch.floor(ax) - 0.5).abs()
                            <= FLIP * 2.0 ** -24 * ax) & v
                    tacc = tacc * corr[..., None] + torch.einsum(
                        "tkgs,skd->tkgd", near.float(),
                        v8[r, sl].float().abs()) * ps[..., None]
                m = mn
                if record is not None:
                    full8 = torch.zeros((n, kv, g, tile), dtype=torch.long)
                    full8[..., sl - p0] = p8.long()
                    for a, u in enumerate(toks.tolist()):
                        record[u, p0 // tile] = (full8[a], ps[a], m[a] > NONE)
            if window:
                # the fresh span: the row's entries in index order, tiles of
                # 64, in log2 units, P as bf16 hi + lo
                m = torch.where(m == NONE, m, m * LOG2E)
                qf = q[toks].reshape(n, kv, g, hd)
                c2 = scale * LOG2E
                tp = pos[toks].long()[:, None]
                for e0 in range(0, len(mine), 64):
                    ent = torch.tensor(mine[e0:e0 + 64])
                    up = pos[ent].long()
                    ok = (ent < c["n_valid"])[None] & (up[None] <= tp) \
                        & (up[None] > tp - window)
                    s = torch.einsum("tkgd,ukd->tkgu", qf,
                                     c["k_span"][ent].float()) * c2
                    s = torch.where(ok[:, None, None, :], s,
                                    torch.tensor(float("-inf")))
                    mn = torch.maximum(m, s.amax(-1))
                    p = torch.exp2(s - mn[..., None])
                    corr = torch.exp2(m - mn)
                    l = l * corr + p.sum(-1)
                    hi, lo = _hi_lo(p)
                    vf = c["v_span"][ent].float()
                    acc = acc * corr[..., None] \
                        + torch.einsum("tkgu,ukd->tkgd", hi, vf) \
                        + torch.einsum("tkgu,ukd->tkgd", lo, vf)
                    tacc = tacc * corr[..., None]
                    m = mn
            out[toks] = acc / torch.clamp(l[..., None], min=1e-30)
            term[toks] = tacc / torch.clamp(l[..., None], min=1e-30)
    out = out.bfloat16().reshape(t, h * hd)
    return (out, term.reshape(t, h * hd)) if flips else out


def _plain_p8(fn, args, kw):
    """The plain version's output and, in order from slot 0, each
    p-tile's (p8, ps) as its quantize_kv returns them (its first call
    quantizes q)."""
    calls = []
    real = P.quantize_kv

    def spy(x, axis=-1):
        calls.append(real(x, axis))
        return calls[-1]

    with mock.patch.object(P, "quantize_kv", spy):
        out = fn(*args, **kw)
    return out, calls[1:]


@pytest.mark.parametrize("layout", ["paged", "rows"])
@pytest.mark.parametrize("g,hd,name", FOLD)
def test_tiled_fold_keeps_p8_and_holds_the_limit(g, hd, name, layout):
    """The fold's p8 and ps equal the plain version's bit for bit wherever
    the row has seen a slot (up to the p-tile; on a p-tile that no token
    of the query tile sees, which the fold skips, the plain p8 is 0), and
    its output is within the kernels' limit of the plain version run in
    fp32 on the same values."""
    case = _torch(_case(41 * g + hd, name, g, hd), torch.bfloat16)
    rolling = bool(case["window"])
    width = _width(case, layout)
    f32 = [x.float() if torch.is_tensor(x) and x.is_floating_point() else x
           for x in _args(case, layout)]
    for kv_block in KV_BLOCKS:
        tile = P.kv_tile(kv_block, width)
        plain, tiles = _plain_p8(_plain(layout, rolling), f32,
                                 _kw(case, kv_block))
        assert len(tiles) == width // tile
        record = {}
        out = _fold(case, layout, tile, record=record)
        checked = 0
        t = len(case["pos"])
        for u in range(t):
            seen = torch.zeros(tiles[0][1].shape[1:], dtype=torch.bool)
            for pi, (p8, ps) in enumerate(tiles):
                if (u, pi) in record:
                    mine8, mine_ps, seen = record[u, pi]
                    assert torch.equal(mine8[seen], p8[u].long()[seen]), \
                        (u, pi)
                    assert torch.equal(mine_ps[seen], ps[u].float()[seen])
                    checked += int(seen.sum())
                else:
                    assert not p8[u].long()[seen].any(), (u, pi)
        assert checked > 0
        excess = float(((out.float() - plain).abs()
                        - _paged.KERNEL_REL * plain.abs()).max())
        assert excess <= _paged.KERNEL_ABS, (kv_block, excess)


# ---------------------------------------------------------------------------
# (c) skipping is exact
# ---------------------------------------------------------------------------

def test_skipping_is_exact():
    """The rolling case over 512 slots at 16-slot p-tiles has rows whose
    arc starts past slot 0 (so p-tiles they cannot see come first, while
    they have seen nothing: the plain version's -1e30 masks give them p =
    1 there) and rows that pass p-tiles they cannot see after visible
    ones; the full-cache case has rows whose prefix ends before the query
    tile's longest.  Skipping those p-tiles and masking with -inf gives
    the output of the fold over every p-tile with -1e30 masks, bit for
    bit."""
    for name, layout, kv_block in (("long", "paged", 16),
                                   ("narrow", "rows", 16),
                                   ("full_long", "rows", 16),
                                   ("full", "paged", 16)):
        case = _torch(_case(43, name, 2, 16), torch.bfloat16)
        tile = P.kv_tile(kv_block, _width(case, layout))
        skip_events = {"unseen": 0, "seen": 0}
        every = {"unseen": 0, "seen": 0}
        fast = _fold(case, layout, tile, events=skip_events)
        slow = _fold(case, layout, tile, skip=False, events=every)
        assert torch.equal(fast, slow), name
        assert every["seen"] > 0, (name, every)
        if case["window"] and name == "long":
            assert every["unseen"] > 0, (name, every)


# ---------------------------------------------------------------------------
# (d) the CUDA wrappers' shape check
# ---------------------------------------------------------------------------

def test_int8_tiled_shape_check():
    """The int8 wrappers' CUDA shape check, ``check_tiled`` (run before the
    launch; it reads only shapes and pointers, so it runs here on CPU
    tensors): any integer g = H / Kv in 1..16 (g 16, 1, 3, 5, 6) and hd in
    {16, 32, 64, 128} pass with the int8 caches among the aligned inputs;
    g 17, H % Kv != 0 and hd 96 raise ValueError.  The p-tile is no shape
    of the body: it walks any tile of at least one slot, and kv_tile gives
    16, 64 and 512 at the widths chip_smoke.py runs (16-slot pages, W 64
    and 4096)."""
    q = torch.zeros((5, 16, 64), dtype=torch.bfloat16)
    k8 = torch.zeros((9, 16, 1, 64), dtype=torch.int8)
    _paged.check_tiled(q, 1, [q, k8, k8])                    # g 16
    _paged.check_tiled(q, 16, [q, k8, k8])                   # g 1
    for h, kv in ((12, 4), (40, 8), (12, 2)):                # g 3, 5, 6
        _paged.check_tiled(torch.zeros((5, h, 64)), kv, [])
    for h, kv in ((17, 1), (40, 3)):                         # g 17; 40 % 3
        with pytest.raises(ValueError, match="g = H / Kv"):
            _paged.check_tiled(torch.zeros((5, h, 64)), kv, [])
    with pytest.raises(ValueError, match="hd in"):
        _paged.check_tiled(torch.zeros((5, 4, 96)), 2, [])
    assert [P.kv_tile(kv_block, width) for kv_block, width in
            ((16, 512), (512, 64), (512, 4096))] == [16, 64, 512]
