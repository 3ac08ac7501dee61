"""The two bf16 rolling span kernels (PERF.md rows 6 and 11: paged, and
over contiguous rows) share one tiled body, csrc/span_attention_tiled.cuh,
which runs only on the card.  Here, on the CPU:

(a) their plain versions against the reference's jnp oracles and its
    Pallas kernels in interpret mode, on the layouts the tiled body must
    get right: mixed steps (1-token decode rows beside chunks), runs that
    straddle a query tile (64 / g tokens: 32 at g 2, 16 at g 4), a row
    with off = 0, bucket padding, rows interleaved in seq_idx, wrapped
    rows and a table narrower than W / bs; at g 2 with hd 16 and g 4
    with hd 32;
(b) the body's arithmetic, mirrored in fp32 torch (each token's visible
    old slots as one arc of the ring, tiles of 64 slots from slot 0, then
    the row's own fresh entries, probabilities as bf16 hi + lo) against the
    plain version, within the kernels' limit; and the precision argument
    at mixtral's widths: hi + lo stays within the limit of the fp32
    result, a single bf16 P does not.

Tolerances: fp32 1e-5 (the same operations summed in other orders); bf16
2e-2 (both packages round to bf16 after each operation, XLA in a few
other places); Pallas in interpret mode in fp32, 1e-5.  The limit of (b)
is ``kernels/_paged.py``'s, the one chip_smoke.py holds the kernels to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.span_attention import (
    paged_span_attention_rolling as pallas_paged_rolling,
    span_attention_rolling as pallas_rows_rolling)
from repro.models import attention as A
from repro_torch.kernels import _paged
from repro_torch.kernels import span_attention as ksa
from repro_torch.models import attention as P

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WIDTHS = [(2, 16), (4, 32)]          # (g, hd): mixtral-smoke's, and g 4
# the fold's mirror also at g 5 (llama4's 40 / 8): 12 tokens x 5 heads a
# query tile, 4 idle rows
FOLD_WIDTHS = WIDTHS + [(5, 16)]

# name: (window, spans, pad, order, nb).  spans[r] = (off, c): row r holds
# positions [0, off) and the span brings off..off+c-1.
CASES = {
    # decode rows beside chunks of 37 (from off = 0) and 19 tokens, padded
    "mixed": (32, [(0, 37), (40, 1), (70, 1), (13, 19), (5, 1)], 3,
              "packed", None),
    # the same step with the rows interleaved in seq_idx
    "interleaved": (32, [(0, 37), (40, 1), (70, 1), (13, 19), (5, 1)], 3,
                    "interleaved", None),
    # rows wrapped many times; a decode row at off = W; a run of 41
    "wrapped": (64, [(200, 23), (64, 1), (130, 41)], 0, "packed", None),
    # a table of 32 slots < W = 64: no row has wrapped
    "narrow": (64, [(3, 21), (9, 1), (0, 5)], 2, "interleaved", 8),
}


def _case(seed, name, g, hd, kv=2, bs=4):
    """Numpy inputs of both layouts: a shuffled paged cache [n_phys, bs,
    Kv, hd] with tables [B, nb] (unused blocks and the trash block, last,
    random), and rolling rows [R, W, Kv, hd] whose batch row b is cache row
    ``rows[b]`` (out of order, two spare rows)."""
    window, spans, pad, order, nb = CASES[name]
    rng = np.random.default_rng(seed)
    need = [min(-(-(o + c) // bs), window // bs) for o, c in spans]
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
    k_span = rng.standard_normal((t, kv, hd), np.float32)
    v_span = rng.standard_normal((t, kv, hd), np.float32)
    k_span[n_valid:], v_span[n_valid:] = k_span[n_valid - 1], v_span[n_valid - 1]
    n_rows = len(spans) + 2
    rows = rng.permutation(n_rows)[:len(spans)].astype(np.int32)
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(
        q=rng.standard_normal((t, h, hd), np.float32),
        k=rng.standard_normal((n_phys, bs, kv, hd), np.float32),
        v=rng.standard_normal((n_phys, bs, kv, hd), np.float32),
        k_rows=rng.standard_normal((n_rows, window, kv, hd), np.float32),
        v_rows=rng.standard_normal((n_rows, window, kv, hd), np.float32),
        k_span=k_span, v_span=v_span, tables=tables, pos=i32(pos),
        seq=i32(seq), cache_row=i32(rows[seq]), offs=i32(offs),
        n_valid=n_valid, window=window)


def _conv(case, make):
    return {n: (make(a) if isinstance(a, np.ndarray) else a)
            for n, a in case.items()}


def _jax(case, dt):
    return _conv(case, lambda a: jnp.asarray(a, dt) if a.dtype == np.float32
                 else jnp.asarray(a))


def _torch(case, dt):
    return _conv(case, lambda a: torch.tensor(a).to(dt)
                 if a.dtype == np.float32 else torch.tensor(a))


def _paged_args(c):
    return (c["q"], c["k"], c["v"], c["k_span"], c["v_span"], c["tables"],
            c["pos"], c["seq"], c["offs"], c["n_valid"])


def _rows_args(c):
    return (c["q"], c["k_rows"], c["v_rows"], c["k_span"], c["v_span"],
            c["pos"], c["cache_row"], c["offs"], c["n_valid"])


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("g,hd", WIDTHS)
def test_paged_rolling_plain_matches_oracles(g, hd, name, dtype):
    """Row 6's plain version against the reference's table-walking native
    and its gather-then-attend oracle."""
    case = _case(11 * g + hd, name, g, hd)
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    w = case["window"]
    out = ksa.paged_span_attention_rolling(*_paged_args(t), window=w)
    assert out.shape == (len(case["pos"]), t["q"].shape[1] * hd)
    for kv_block in (4, 512):        # one page; the engine's tile
        _close(out, A.paged_span_attention_rolling_native(
            *_paged_args(j), window=w, kv_block=kv_block), TOL[dtype])
        _close(out, A.paged_span_attention_rolling(
            *_paged_args(j), window=w, kv_block=kv_block), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("g,hd", WIDTHS)
def test_rows_rolling_plain_matches_oracle(g, hd, name, dtype):
    """Row 11's plain version against the reference's jnp oracle over
    rolling rows read out of order."""
    case = _case(13 * g + hd, name, g, hd)
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    w = case["window"]
    out = ksa.span_attention_rolling(*_rows_args(t), window=w)
    for kv_block in (16, 512):
        _close(out, A.packed_span_attention_rolling(
            *_rows_args(j), window=w, kv_block=kv_block), TOL[dtype])


@pytest.mark.parametrize("layout", ["paged", "rows"])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("g,hd", WIDTHS)
def test_rolling_plain_matches_pallas_interpret(g, hd, name, layout):
    """The Pallas kernels in interpret mode (fp32), as the reference's
    tests run them."""
    case = _case(17 * g + hd, name, g, hd)
    j, t = _jax(case, jnp.float32), _torch(case, torch.float32)
    w = case["window"]
    nv = jnp.asarray([case["n_valid"]], jnp.int32)
    if layout == "paged":
        ref = pallas_paged_rolling(
            j["q"], j["k"], j["v"], j["k_span"], j["v_span"], j["pos"],
            j["seq"], j["offs"], nv, j["tables"], window=w, interpret=True)
        out = ksa.paged_span_attention_rolling(*_paged_args(t), window=w)
    else:
        ref = pallas_rows_rolling(
            j["q"], j["k_rows"], j["v_rows"], j["k_span"], j["v_span"],
            j["pos"], j["cache_row"], j["offs"], nv, window=w, kv_block=16,
            interpret=True)
        out = ksa.span_attention_rolling(*_rows_args(t), window=w)
    _close(out, ref, TOL["float32"])


# ---------------------------------------------------------------------------
# (b) the tiled body's arithmetic
# ---------------------------------------------------------------------------

def _arc(pos, off, window, w_slots):
    """A token's visible old slots as the tiled body finds them: positions
    [max(pos - W + 1, off - w_slots, 0), off - 1], i.e. ``length`` slots
    from slot ``first`` around the ring."""
    lo = max(pos - window + 1, off - w_slots, 0)
    length = max(off - lo, 0)
    return (lo % w_slots if length else 0), length


def _arc_mask(pos, off, window, w_slots, slots):
    first, length = _arc(pos, off, window, w_slots)
    return (slots < w_slots) & ((slots - first) % w_slots < length)


def test_arc_is_the_plain_versions_old_cache_mask():
    """Every (off, pos) with pos >= off, around and past the ring's width:
    the arc picks exactly the slots the plain version's mask lets
    through."""
    for window, w_slots in ((8, 8), (32, 32), (64, 32), (32, 20)):
        slots = torch.arange(w_slots)
        for off in range(0, 3 * w_slots + 2):
            for pos in range(off, off + window + 3):
                plain = P._rolling_mask(slots, torch.tensor([off]),
                                        torch.tensor([pos]), w_slots,
                                        window)[0]
                arc = _arc_mask(pos, off, window, w_slots, slots)
                assert torch.equal(plain, arc), (window, w_slots, off, pos)


def _hi_lo(p):
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def _tiled(q, k_rows, v_rows, k_span, v_span, pos, seq, offs, n_valid,
           window, tq):
    """csrc/span_attention_tiled.cuh's fold, in fp32 torch on the bf16
    values: the tokens of each row in index order, cut into query tiles
    of ``tq``; per tile, the old cache in tiles of 64 slots from slot 0
    (each token's arc, slots past the tile's largest min(off, w_slots)
    zero), then the row's own fresh entries in tiles of 64; scores scaled
    by log2 e, exp2, P as bf16 hi + lo.  k_rows/v_rows [B, w_slots, Kv,
    hd] (a paged cache's gathered view)."""
    t, h, hd = q.shape
    kv = k_span.shape[1]
    g = h // kv
    w_slots = k_rows.shape[1]
    c2 = hd ** -0.5 * 1.4426950408889634
    qf = q.float().reshape(t, kv, g, hd)
    out = torch.zeros((t, kv, g, hd))
    for r in sorted(set(seq.tolist())):
        mine = [u for u in range(t) if seq[u] == r]
        for i in range(0, len(mine), tq):
            toks = mine[i:i + tq]
            n_old = max(min(int(offs[u]), w_slots) for u in toks)
            m = torch.full((len(toks), kv, g), -1e30)
            l = torch.zeros((len(toks), kv, g))
            acc = torch.zeros((len(toks), kv, g, hd))

            def fold(k, v, vis):                 # k, v [64, Kv, hd]
                nonlocal m, l, acc
                s = torch.einsum("tngd,snd->tngs", qf[toks], k.float()) * c2
                s = torch.where(vis[:, None, None, :], s,
                                torch.tensor(float("-inf")))
                mn = torch.maximum(m, s.amax(-1))
                p = torch.exp2(s - mn[..., None])
                corr = torch.exp2(m - mn)
                l = l * corr + p.sum(-1)
                hi, lo = _hi_lo(p)
                acc = acc * corr[..., None] \
                    + torch.einsum("tngs,snd->tngd", hi, v.float()) \
                    + torch.einsum("tngs,snd->tngd", lo, v.float())
                m = mn

            for s0 in range(0, n_old, 64):
                slots = torch.arange(s0, s0 + 64)
                live = (slots < n_old)[:, None, None]
                idx = slots.clamp(max=w_slots - 1)
                k = torch.where(live, k_rows[r, idx].float(), 0.)
                v = torch.where(live, v_rows[r, idx].float(), 0.)
                vis = torch.stack([_arc_mask(int(pos[u]), int(offs[u]),
                                             window, w_slots, slots)
                                   for u in toks])
                fold(k, v, vis)
            for e0 in range(0, len(mine), 64):
                ent = torch.tensor(mine[e0:e0 + 64])
                ok = ent < n_valid
                upos = torch.where(ok, pos[ent], torch.iinfo(torch.int32).max)
                tp = pos[toks][:, None]
                vis = (upos[None] <= tp) & (upos[None] > tp - window)
                k = torch.where(ok[:, None, None], k_span[ent].float(), 0.)
                v = torch.where(ok[:, None, None], v_span[ent].float(), 0.)
                fold(k, v, vis)
            out[toks] = acc / torch.clamp(l[..., None], min=1e-30)
    return out.bfloat16().reshape(t, h * hd)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("g,hd", FOLD_WIDTHS)
def test_tiled_fold_within_the_kernel_limit(g, hd, name):
    """The tiled body's fold (bf16 values, bf16 output) against the plain
    version run in fp32 on the same values, within the limit chip_smoke.py
    holds the kernel to."""
    case = _torch(_case(19 * g + hd, name, g, hd), torch.bfloat16)
    w = case["window"]
    view = [P.gather_paged_cache(case[n], case["tables"]) for n in "kv"]
    out = _tiled(case["q"], *view, case["k_span"], case["v_span"],
                 case["pos"], case["seq"], case["offs"], case["n_valid"], w,
                 _paged.QUERY_ROWS // g)
    f32 = [x.float() if torch.is_tensor(x) and x.is_floating_point() else x
           for x in _paged_args(case)]
    plain = ksa.paged_span_attention_rolling_plain(*f32, window=w)
    excess = float(((out.float() - plain).abs()
                    - _paged.KERNEL_REL * plain.abs()).max())
    assert excess <= _paged.KERNEL_ABS, excess


def test_hi_lo_probabilities_hold_the_limit_one_bf16_does_not():
    """The precision argument at mixtral's widths (64 tokens x 32 heads,
    Kv 8, hd 128, 4096 visible slots, standard normal bf16 q/k/v): P.V with
    P as bf16 hi + lo stays within the kernels' limit of the fp32 result;
    with P rounded once to bf16 (the textbook flash step) it does not."""
    rng = np.random.default_rng(22)
    t, h, kv, hd, s = 64, 32, 8, 128, 4096
    bf = lambda *shape: torch.tensor(
        rng.standard_normal(shape, np.float32)).bfloat16().float()
    q, k, v = bf(t, kv, h // kv, hd), bf(s, kv, hd), bf(s, kv, hd)
    sc = torch.einsum("tngd,snd->tngs", q, k) * hd ** -0.5
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pv = lambda x: torch.einsum("tngs,snd->tngd", x, v)
    ref = pv(p) / l
    hi, lo = _hi_lo(p)
    excess = {}
    for label, num in (("hi+lo", pv(hi) + pv(lo)), ("bf16", pv(hi))):
        out = (num / l).bfloat16().float()
        excess[label] = float(((out - ref).abs()
                               - _paged.KERNEL_REL * ref.abs()).max())
    assert excess["hi+lo"] <= _paged.KERNEL_ABS, excess
    assert excess["bf16"] > _paged.KERNEL_ABS, excess


def test_tiled_shapes_and_plan_size():
    """The CUDA wrappers' shape check (run on CUDA calls; no fallback) and
    the planning workspace's size."""
    q = torch.zeros((5, 12, 16), dtype=torch.bfloat16)
    _paged.check_tiled(q, 3, [q])                 # g 4, hd 16
    for h, kv in ((12, 4), (12, 12), (12, 2), (40, 8)):   # g 3, 1, 6, 5
        qq = torch.zeros((5, h, 16), dtype=torch.bfloat16)
        _paged.check_tiled(qq, kv, [qq])
    for h, kv in ((17, 1), (12, 5), (12, 0)):     # g 17; H % Kv != 0
        qq = torch.zeros((5, h, 16), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="g = H / Kv"):
            _paged.check_tiled(qq, kv, [qq])
    for width in (8, 48, 96, 256):
        qq = torch.zeros((5, 4, width), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="hd in"):
            _paged.check_tiled(qq, 2, [qq])
    # tiles: ceil(T / (64 / g)) + min(rows, T); order and rank T each;
    # three per row
    assert _paged.plan_ints(256, 4, 4) == 1 + 3 * (16 + 4) + 512 + 12
    assert _paged.plan_ints(3, 8, 1) == 1 + 3 * (1 + 3) + 6 + 24
    # g 5 (llama4's 40 / 8): query tiles of 64 // 5 = 12 tokens
    assert _paged.plan_ints(256, 4, 5) == 1 + 3 * (22 + 4) + 512 + 12


def _fast_div(d):
    """tiled::FastDiv's (multiplier, shift) for divisor d > 1."""
    lg = (d - 1).bit_length()                    # ceil(log2 d)
    p = 31 + lg
    return ((1 << p) + d - 1) // d, p - 32


@pytest.mark.parametrize("d", [2, 3, 7, 16, 24, 48, 1000, 4097, 65536])
def test_fast_division_of_slots_by_the_page_size(d):
    """The paged kernel finds a slot's page by a multiply and a shift
    (tiled::FastDiv); its quotient is n // d for every 0 <= n < 2^31."""
    mul, shr = _fast_div(d)
    assert mul < 2 ** 32
    rng = np.random.default_rng(d)
    ns = np.concatenate([np.arange(5 * d + 3), rng.integers(0, 2 ** 31, 4096),
                         [2 ** 31 - 1, 2 ** 31 - 2, 2 ** 31 - d]])
    for n in ns.tolist():
        assert ((n * mul) >> 32) >> shr == n // d, (d, n)
