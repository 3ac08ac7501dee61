"""The flash prefill kernel (PERF.md rows 3, 3n and 3w:
csrc/flash_attention.cu) and the full-cache mode of the bf16 span body
(rows 1 and 9: csrc/span_attention_tiled.cuh) run only on the card.  Here,
on the CPU:

(a) the flash body's arithmetic, mirrored in fp32 torch (64-key tiles
    from key 0 in order, scores pre-scaled by log2 e, exp2, probabilities
    as bf16 hi + lo), against ``flash_attention_plain`` run in fp32 on the
    same bf16 values, within the kernels' limit: causal over a ragged S,
    non-causal with Sq != Skv, a window, GQA at g 4 with hd 128 and at
    g 16; the same mirror with one bf16 P misses the limit;
(b) the flash body's tile rule (which kv tiles a block of 64 / g positions
    visits, and which of them it folds without a mask) against the plain
    version's own mask, probed through its output: a skipped tile holds
    no visible pair and an unmasked tile no masked one;
(c) the full-cache span fold mirrored the same way (each row's tokens in
    index order in query tiles of 64 / g, cache tiles of 64 slots from
    slot 0) against both plain versions, with seq_idx interleaved and at
    g 16;
(d) the plain versions of rows 1 and 9 (and of the flash kernel) at g 16
    against the reference's jnp oracles and its Pallas kernels in
    interpret mode;
(e) the tiled bodies' shape check, which reads only shapes and pointers.

Tolerances: the mirrors are held to ``kernels/_paged.py``'s KERNEL_REL /
KERNEL_ABS, the limit chip_smoke.py holds the kernels to; the plain
versions to the oracles at fp32 1e-5 (the same operations summed in
other orders) and bf16 2e-2 (both packages round to bf16 after each
operation, XLA in a few other places); Pallas in interpret mode (fp32) at
1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.span_attention import paged_span_attention as pallas_paged
from repro.kernels.span_attention import span_attention as pallas_rows
from repro.models import attention as A
from repro_torch.kernels import _paged
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import span_attention as ksa
from repro_torch.models import attention as P

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOG2E = 1.4426950408889634
KEYS = 64                       # keys (slots) of a kv tile


def _bf16(rng, *shape):
    """Standard normal values rounded to bf16, as bf16."""
    return torch.tensor(rng.standard_normal(shape, np.float32)).bfloat16()


def _hi_lo(p):
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def _excess(out, plain):
    """max(|kernel - plain| - KERNEL_REL * |plain|): within the limit iff
    <= KERNEL_ABS."""
    return float(((out.float() - plain).abs()
                  - _paged.KERNEL_REL * plain.abs()).max())


def _fold(state, s, vis, v, hi_lo):
    """One tile into the running softmax, as tiled::fold_tile: s [..., k]
    scores already times scale * log2 e, vis [..., k], v [..., k, hd]
    broadcast by the caller's einsum ``pv``."""
    m, l, acc, pv = state
    s = torch.where(vis, s, torch.tensor(float("-inf")))
    mn = torch.maximum(m, s.amax(-1))
    p = torch.exp2(s - mn[..., None])
    corr = torch.exp2(m - mn)
    l = l * corr + p.sum(-1)
    hi, lo = _hi_lo(p)
    acc = acc * corr[..., None] + pv(hi, v)
    if hi_lo:
        acc = acc + pv(lo, v)
    return mn, l, acc, pv


# ---------------------------------------------------------------------------
# (a) the flash body's arithmetic
# ---------------------------------------------------------------------------

def _flash_mirror(q, k, v, qpos, *, causal, window=0, hi_lo=True):
    """csrc/flash_attention.cu's fold in fp32 torch on the bf16 values:
    q [B, Sq, H, hd], k/v [B, Skv, Kv, hd], qpos [Sq] -> bf16 [B, Sq,
    H*hd].  Every 64-key tile from key 0 in order, masked per row (the
    kernel skips the tiles a block cannot see and folds the tiles every
    row sees whole without a mask: both leave the same values, see
    test_flash_tile_rule_matches_the_plain_mask)."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, sq, kv, g, hd)
    c2 = hd ** -0.5 * LOG2E
    qp = qpos.long()[:, None]
    state = (torch.full((b, sq, kv, g), -1e30), torch.zeros((b, sq, kv, g)),
             torch.zeros((b, sq, kv, g, hd)),
             lambda p, vt: torch.einsum("bqngk,bknd->bqngd", p, vt))
    for t0 in range(0, skv, KEYS):
        keys = torch.arange(t0, t0 + KEYS)
        live = keys < skv
        kt = torch.zeros((b, KEYS, kv, hd))
        vt = torch.zeros((b, KEYS, kv, hd))
        kt[:, live] = k[:, t0:t0 + KEYS].float()
        vt[:, live] = v[:, t0:t0 + KEYS].float()
        vis = live[None].expand(sq, -1)
        if causal:
            vis = vis & (keys[None] <= qp)
            if window:
                vis = vis & (keys[None] > qp - window)
        s = torch.einsum("bqngd,bknd->bqngk", qf, kt) * c2
        state = _fold(state, s, vis[None, :, None, None], vt, hi_lo)
    _, l, acc, _ = state
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.bfloat16().reshape(b, sq, h * hd)


# name: (B, Sq, Skv, Kv, g, hd, causal, window)
FLASH_CASES = {
    "causal ragged": (2, 97, 97, 2, 1, 32, True, 0),
    "cross 4 over 150": (2, 4, 150, 2, 2, 64, False, 0),
    "window 16": (1, 97, 97, 2, 2, 32, True, 16),
    "g 4 hd 128": (1, 384, 384, 2, 4, 128, True, 0),
    "g 16": (1, 70, 70, 1, 16, 64, True, 0),
    "g 5 hd 128": (1, 100, 100, 2, 5, 128, True, 0),    # llama4's group
}


def _flash_case(name):
    b, sq, skv, kv, g, hd, causal, window = FLASH_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = (_bf16(rng, b, n, m, hd)
               for n, m in ((sq, kv * g), (skv, kv), (skv, kv)))
    return q, k, v, torch.arange(sq, dtype=torch.int32), causal, window


def _flash_plain32(q, k, v, qpos, causal, window):
    return kfa.flash_attention_plain(
        q.float(), k.float(), v.float(), qpos if causal else None,
        causal=causal, window=window,
        kv_block=min(512, window) if window else 512)


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_fold_within_the_kernel_limit(name):
    """The flash body's fold (bf16 values, bf16 output, P as hi + lo)
    against the plain version run in fp32 on the same values."""
    q, k, v, qpos, causal, window = _flash_case(name)
    out = _flash_mirror(q, k, v, qpos, causal=causal, window=window)
    excess = _excess(out, _flash_plain32(q, k, v, qpos, causal, window))
    assert excess <= _paged.KERNEL_ABS, excess


def test_flash_one_bf16_probability_misses_the_limit():
    """Why P is hi + lo: with P rounded once to bf16 (the textbook flash
    step) the fold misses the limit in at least one case above, while hi
    + lo holds every one (test_flash_fold_within_the_kernel_limit)."""
    excess = {}
    for name in FLASH_CASES:
        q, k, v, qpos, causal, window = _flash_case(name)
        out = _flash_mirror(q, k, v, qpos, causal=causal, window=window,
                            hi_lo=False)
        excess[name] = _excess(out, _flash_plain32(q, k, v, qpos, causal,
                                                   window))
    assert max(excess.values()) > _paged.KERNEL_ABS, excess


# ---------------------------------------------------------------------------
# (b) the flash body's tile rule
# ---------------------------------------------------------------------------

def _flash_tiles(pos, skv, causal, window):
    """(tile, unmasked) for each kv tile a block visits, as
    flash_attention_kernel finds them from its positions ``pos``."""
    lo, hi = 0, skv
    if causal:
        hi = min(skv, max(pos) + 1)
        if window:
            lo = max(0, min(pos) - window + 1)
    t_lo = lo // KEYS
    n = (hi + KEYS - 1) // KEYS - t_lo if hi > lo else 0
    tiles = []
    for t in range(t_lo, t_lo + n):
        s0 = t * KEYS
        full = s0 + KEYS <= skv
        if causal:
            full = full and s0 + KEYS - 1 <= min(pos) and (
                not window or s0 > max(pos) - window)
        tiles.append((t, full))
    return tiles


def _plain_mask(sq, skv, qpos, causal, window):
    """[Sq, Skv]: which keys the plain version lets each query see, read
    from its output: with zero keys every visible score is equal, and a
    one-hot value per key marks the keys that reach the output."""
    q = torch.zeros((1, sq, 1, skv))
    k = torch.zeros((1, skv, 1, skv))
    v = torch.eye(skv)[None, :, None, :]
    out = kfa.flash_attention_plain(
        q, k, v, qpos if causal else None, causal=causal, window=window,
        kv_block=min(512, window) if window else 512)
    return out[0] > 0


# name: (Sq, Skv, causal, window, positions): positions None = arange
TILE_CASES = {
    "causal": (200, 200, True, 0, None),
    "causal, positions shuffled": (150, 200, True, 0, "perm"),
    "causal, positions past the keys": (130, 100, True, 0, "high"),
    "window": (300, 300, True, 50, None),
    "window of a tile": (300, 300, True, 64, None),
    "non-causal": (100, 257, False, 0, None),
}


@pytest.mark.parametrize("g", [1, 4, 5, 16])
@pytest.mark.parametrize("name", list(TILE_CASES))
def test_flash_tile_rule_matches_the_plain_mask(name, g):
    """Every block of 64 / g positions: each tile it skips holds no pair
    the plain version lets through, and each tile it folds without a mask
    holds only such pairs (64 keys, all inside Skv)."""
    sq, skv, causal, window, how = TILE_CASES[name]
    rng = np.random.default_rng(len(name) * 7 + g)
    qpos = np.arange(sq)
    if how == "perm":
        qpos = rng.permutation(skv)[:sq]
    elif how == "high":
        qpos = np.arange(sq) + 20
    qpos = torch.tensor(qpos, dtype=torch.int32)
    mask = _plain_mask(sq, skv, qpos, causal, window)
    np_ = _paged.QUERY_ROWS // g
    n_tiles = -(-skv // KEYS)
    for p0 in range(0, sq, np_):
        rows = slice(p0, min(p0 + np_, sq))
        visited = dict(_flash_tiles(qpos[rows].tolist(), skv, causal,
                                    window))
        for t in range(n_tiles):
            block = mask[rows, t * KEYS:(t + 1) * KEYS]
            if t not in visited:
                assert not block.any(), (p0, t)
            elif visited[t]:
                assert block.shape[1] == KEYS and block.all(), (p0, t)


# ---------------------------------------------------------------------------
# (c) the full-cache span fold
# ---------------------------------------------------------------------------

def _span_mirror(q, k_rows, v_rows, pos, seq, hi_lo=True):
    """The full-cache mode of csrc/span_attention_tiled.cuh in fp32 torch
    on the bf16 values: each row's tokens in index order, cut into query
    tiles of 64 / g; per tile, cache tiles of 64 slots from slot 0 up to
    the tile's longest prefix min(pos + 1, S) (slots past it zero), each
    token masked to its own prefix.  q [T, H, hd]; k_rows/v_rows [B, S,
    Kv, hd] (a paged cache's gathered view) -> bf16 [T, H*hd]."""
    t, h, hd = q.shape
    width, kv = k_rows.shape[1], k_rows.shape[2]
    g = h // kv
    tq = _paged.QUERY_ROWS // g
    c2 = hd ** -0.5 * LOG2E
    qf = q.float().reshape(t, kv, g, hd)
    out = torch.zeros((t, kv, g, hd))
    for r in sorted(set(seq.tolist())):
        mine = [u for u in range(t) if seq[u] == r]
        for i in range(0, len(mine), tq):
            toks = mine[i:i + tq]
            lens = torch.clamp(pos[toks].long() + 1, max=width)
            n_old = int(lens.max())
            state = (torch.full((len(toks), kv, g), -1e30),
                     torch.zeros((len(toks), kv, g)),
                     torch.zeros((len(toks), kv, g, hd)),
                     lambda p, vt: torch.einsum("tngs,snd->tngd", p, vt))
            for s0 in range(0, n_old, KEYS):
                slots = torch.arange(s0, s0 + KEYS)
                live = (slots < n_old)[:, None, None]
                idx = slots.clamp(max=width - 1)
                kt = torch.where(live, k_rows[r, idx].float(), 0.)
                vt = torch.where(live, v_rows[r, idx].float(), 0.)
                s = torch.einsum("tngd,snd->tngs", qf[toks], kt) * c2
                vis = slots[None] < lens[:, None]
                state = _fold(state, s, vis[:, None, None], vt, hi_lo)
            _, l, acc, _ = state
            out[toks] = acc / torch.clamp(l[..., None], min=1e-30)
    return out.bfloat16().reshape(t, h * hd)


def _span_case(seed, spans, kv, g, hd, *, bs=16, interleave=False):
    """A paged cache (shuffled blocks, trash block last, every block
    random) holding rows whose spans[r] = (off, c): the chunk brings
    positions off..off+c-1 of row r (already written, as the engine does
    before it attends); with ``interleave`` its tokens come round robin
    over the rows."""
    rng = np.random.default_rng(seed)
    seq = np.concatenate([np.full(c, r) for r, (_, c) in enumerate(spans)])
    pos = np.concatenate([o + np.arange(c) for o, c in spans])
    if interleave:
        rank = np.concatenate([np.arange(c) for _, c in spans])
        idx = np.lexsort((seq, rank))
        seq, pos = seq[idx], pos[idx]
    ctx = [o + c for o, c in spans]
    nb = -(-max(ctx) // bs)
    n_phys = len(spans) * nb + 2
    perm = rng.permutation(n_phys - 1)
    tables = np.full((len(spans), nb), n_phys - 1, np.int32)
    used = 0
    for r, n in enumerate(ctx):
        need = -(-n // bs)
        tables[r, :need] = perm[used:used + need]
        used += need
    return dict(q=rng.standard_normal((len(pos), kv * g, hd), np.float32),
                k=rng.standard_normal((n_phys, bs, kv, hd), np.float32),
                v=rng.standard_normal((n_phys, bs, kv, hd), np.float32),
                tables=tables, pos=pos.astype(np.int32),
                seq=seq.astype(np.int32))


def _to(case, make):
    return {n: make(a) for n, a in case.items()}


def _torch(case, dt):
    return _to(case, lambda a: torch.tensor(a).to(dt)
               if a.dtype == np.float32 else torch.tensor(a))


def _jax(case, dt):
    return _to(case, lambda a: jnp.asarray(a, dt) if a.dtype == np.float32
               else jnp.asarray(a))


# name: (spans, Kv, g, hd, interleave)
SPAN_CASES = {
    "interleaved": ([(0, 37), (50, 9), (3, 70), (120, 1)], 2, 2, 32, True),
    "g 16": ([(0, 11), (90, 6), (33, 40)], 1, 16, 16, False),
    "g 16 interleaved": ([(0, 11), (90, 6), (33, 40)], 2, 16, 32, True),
    # llama4's group: query tiles of 12 tokens x 5 heads, 4 idle rows
    "g 5 interleaved": ([(0, 11), (90, 6), (33, 40)], 2, 5, 16, True),
}


@pytest.mark.parametrize("name", list(SPAN_CASES))
def test_full_cache_span_fold_within_the_kernel_limit(name):
    """The full-cache fold (bf16 values, bf16 output) against both plain
    versions (rows 1 and 9 over one logical cache) run in fp32 on the same
    values."""
    spans, kv, g, hd, interleave = SPAN_CASES[name]
    c = _torch(_span_case(len(name), spans, kv, g, hd,
                          interleave=interleave), torch.bfloat16)
    rows = [P.gather_paged_cache(c[n], c["tables"]) for n in "kv"]
    out = _span_mirror(c["q"], *rows, c["pos"], c["seq"])
    f = lambda x: x.float()
    paged = ksa.paged_span_attention_plain(
        f(c["q"]), f(c["k"]), f(c["v"]), c["tables"], c["pos"], c["seq"])
    over_rows = ksa.span_attention_plain(f(c["q"]), *map(f, rows), c["pos"],
                                         c["seq"])
    assert _excess(out, paged) <= _paged.KERNEL_ABS
    assert _excess(out, over_rows) <= _paged.KERNEL_ABS


# ---------------------------------------------------------------------------
# (d) the plain versions at g 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["paged", "rows"])
def test_span_plain_matches_oracle_and_pallas_at_g16(layout, dtype):
    """Rows 1 and 9's plain versions at g 16 (H 16, Kv 1, hd 16), tokens
    interleaved over three rows, against the jnp oracle and (fp32) the
    Pallas kernel in interpret mode."""
    case = _span_case(5, [(0, 11), (40, 6), (17, 13)], 1, 16, 16,
                      interleave=True)
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    if layout == "paged":
        out = ksa.paged_span_attention(t["q"], t["k"], t["v"], t["tables"],
                                       t["pos"], t["seq"])
        oracle = A.paged_span_attention(j["q"], j["k"], j["v"], j["tables"],
                                        j["pos"], j["seq"])
    else:
        k, v = (P.gather_paged_cache(t[n], t["tables"]) for n in "kv")
        out = ksa.span_attention(t["q"], k, v, t["pos"], t["seq"])
        kj, vj = (A.gather_paged_cache(j[n], j["tables"]) for n in "kv")
        oracle = A.packed_span_attention(j["q"], kj, vj, j["pos"], j["seq"])
    assert out.shape == (len(case["pos"]), 16 * 16) and out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(oracle, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == "float32":
        jf = _jax(case, jnp.float32)
        if layout == "paged":
            pallas = pallas_paged(jf["q"], jf["k"], jf["v"], jf["pos"],
                                  jf["seq"], jf["tables"], interpret=True)
        else:
            kj, vj = (A.gather_paged_cache(jf[n], jf["tables"]) for n in "kv")
            pallas = pallas_rows(jf["q"], kj, vj, jf["pos"], jf["seq"],
                                 kv_block=16, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                                   rtol=1e-5, atol=1e-5)


def test_flash_plain_matches_pallas_at_g16():
    """The flash kernel's plain version at g 16 (H 16, Kv 1, hd 16),
    causal over S = 40, against the Pallas kernel in interpret mode
    (fp32; its [B, H, S, hd] layout)."""
    rng = np.random.default_rng(16)
    q, k, v = (rng.standard_normal((2, 40, n, 16), np.float32)
               for n in (16, 1, 1))
    out = kfa.flash_attention(*map(torch.tensor, (q, k, v)),
                              torch.arange(40, dtype=torch.int32),
                              kv_block=16)
    ref = pallas_flash(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                         for x in (q, k, v)), q_block=8, kv_block=8,
                       interpret=True)
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(2, 40, 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) the shape check
# ---------------------------------------------------------------------------

def test_tiled_check_takes_g16_and_refuses_other_shapes():
    """_paged.check_tiled (run before every launch of the tiled span and
    flash bodies; no fallback) reads shapes and pointers only: g 16 and
    the groups that are no power of two (3, 5, 6) are taken, g 17, H % Kv
    != 0 and hd 96 raise ValueError, in the span layout [T, H, hd] and the
    flash layout [B, S, H, hd]."""
    for shape in ((5, 32, 128), (2, 7, 32, 128)):
        q = torch.zeros(shape, dtype=torch.bfloat16)
        _paged.check_tiled(q, 2, [q])                     # g 16
        for h, kv in ((12, 4), (40, 8), (12, 2)):         # g 3, 5, 6
            _paged.check_tiled(torch.zeros(shape[:-2] + (h, 128)), kv, [q])
        for h, kv in ((17, 1), (32, 3)):                  # g 17; 32 % 3
            with pytest.raises(ValueError, match="g = H / Kv"):
                _paged.check_tiled(torch.zeros(shape[:-2] + (h, 128)), kv,
                                   [q])
        with pytest.raises(ValueError, match="hd in"):
            _paged.check_tiled(torch.zeros(shape[:-2] + (32, 96)), 2, [q])
    assert _paged.TILED_MAX_GROUP == 16
    # the planning workspace at g 16: query tiles of 4 tokens
    assert _paged.plan_ints(130, 3, 16) == 1 + 3 * (33 + 3) + 260 + 9
    # and at g 5: 12 tokens (ceil(130 / 12) = 11 tiles)
    assert _paged.plan_ints(130, 3, 5) == 1 + 3 * (11 + 3) + 260 + 9
