"""The two bf16 decode kernels (PERF.md rows 2, 2r: paged; 2c, 2cr: over
contiguous rows) share one split body, csrc/decode_attention_split.cuh,
which runs only on the card; the int8 decode kernels (rows 2b, 2bc, 2br,
2bcr) are held on the card to a limit with a term for probabilities on a
rounding boundary (kernels/_paged.py).  Here, on the CPU:

(a) the plain decode versions, paged and over rows, full cache and
    rolling, against the reference's jnp decode_attention and its Pallas
    kernel in interpret mode, at g 1, 4 and 16 with hd 16 and 32, on
    contexts of 1 slot, of one split (512 slots) and one more, and on
    wrapped rolling rows;
(b) the body's arithmetic, mirrored in fp32 torch (chunks of 512 slots
    from slot 0, 64-slot tiles, 16 slots a warp each under its own online
    softmax, P as bf16 hi + lo, the warps then the chunks merged in order)
    against the plain version within the kernels' limit, with the same bits
    over pages and over rows;
(c) the precision argument at mixtral's widths: with the split, P as hi +
    lo stays within the limit of the fp32 result, one bf16 P does not;
(d) the int8 decode limit's flip term at chip_smoke.py's shapes: summing
    the softmax denominator in another order than the plain version's (the
    first int8 decode kernel's: the whole row lane-strided, then a
    butterfly; the split body's order, chunk by chunk, is mirrored in
    tests/test_torch_int8_decode_split.py) moves one quantized probability
    by one step, which the limit without the term refuses and with it
    admits; the limit still refuses a dropped visible slot and a one-step
    error at a slot off the boundary.

Tolerances: fp32 1e-5 (the same operations summed in other orders); bf16
2e-2 (both packages round to bf16 after each operation, XLA in a few other
places); Pallas in interpret mode in fp32, 1e-5.  The limit of (b)-(d) is
``kernels/_paged.py``'s, the one chip_smoke.py holds the kernels to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.models import attention as A
from repro_torch.kernels import _paged
from repro_torch.kernels import decode_attention as kda
from repro_torch.models import attention as P

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WIDTHS = [(1, 16), (4, 32), (16, 16)]    # (g, hd)
L = _paged.DECODE_SPLIT
LOG2E = 1.4426950408889634

# positions of a batch: contexts of 1 slot, of one split and one more,
# short and long rows; the rolling batch wraps rows past W (not a multiple
# of the split) and has a row of exactly W slots
FULL_POS = [0, L - 1, L, 37, L + 43, 130]
ROLL_POS = [0, L - 1, L, 3 * L, L + 7, 5 * L]
WINDOW = L + 8
FULL_WIDTH = L + 48
BS = 8                                   # page size


def _case(seed, g, hd, mode, kv=2):
    """Numpy inputs of both layouts holding one logical cache: a shuffled
    paged cache [n_phys, BS, Kv, hd] with tables [B, nb] (the trash block,
    last, and the unused blocks random), and rows [R, S, Kv, hd] whose batch
    row b is cache row ``rows[b]`` (out of order, two spare rows) and equals
    the table's gathered view (S = nb * BS)."""
    rng = np.random.default_rng(seed)
    pos = np.array(FULL_POS if mode == "full" else ROLL_POS, np.int32)
    width = FULL_WIDTH if mode == "full" else WINDOW
    n = np.minimum(pos + 1, width)
    nb = width // BS
    b = len(pos)
    n_phys = b * nb + 3
    perm = rng.permutation(n_phys - 1)
    tables = np.full((b, nb), n_phys - 1, np.int32)
    used = 0
    for r in range(b):
        k = -(-int(n[r]) // BS)
        tables[r, :k] = perm[used:used + k]
        used += k
    h = kv * g
    k_pages = rng.standard_normal((n_phys, BS, kv, hd), np.float32)
    v_pages = rng.standard_normal((n_phys, BS, kv, hd), np.float32)
    rows = rng.permutation(b + 2)[:b].astype(np.int32)
    k_rows = rng.standard_normal((b + 2, nb * BS, kv, hd), np.float32)
    v_rows = rng.standard_normal((b + 2, nb * BS, kv, hd), np.float32)
    k_rows[rows] = k_pages[tables].reshape(b, nb * BS, kv, hd)
    v_rows[rows] = v_pages[tables].reshape(b, nb * BS, kv, hd)
    return dict(q=rng.standard_normal((b, h, hd), np.float32), k=k_pages,
                v=v_pages, tables=tables, k_rows=k_rows, v_rows=v_rows,
                rows=rows, pos=pos, window=WINDOW if mode == "rolling" else 0)


def _conv(case, make):
    return {n: (make(a) if isinstance(a, np.ndarray) else a)
            for n, a in case.items()}


def _jax(case, dt):
    return _conv(case, lambda a: jnp.asarray(a, dt) if a.dtype == np.float32
                 else jnp.asarray(a))


def _torch(case, dt):
    return _conv(case, lambda a: torch.tensor(a).to(dt)
                 if a.dtype == np.float32 else torch.tensor(a))


def _port(t, layout):
    """The port's wrapper on CPU tensors: its plain version."""
    w = t["window"]
    if layout == "paged":
        args = (t["q"], t["k"], t["v"], t["tables"], t["pos"])
        if w:
            return kda.paged_decode_attention_rolling(*args, window=w)
        return kda.paged_decode_attention(*args)
    args = (t["q"], t["k_rows"], t["v_rows"], t["rows"], t["pos"])
    if w:
        return kda.contiguous_decode_attention_rolling(*args, window=w)
    return kda.contiguous_decode_attention(*args)


def _views(j, layout):
    """The reference's inputs: each batch row's [B, S, Kv, hd] K and V."""
    if layout == "paged":
        return (A.gather_paged_cache(j["k"], j["tables"]),
                A.gather_paged_cache(j["v"], j["tables"]))
    return j["k_rows"][j["rows"]], j["v_rows"][j["rows"]]


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "rolling"])
@pytest.mark.parametrize("layout", ["paged", "rows"])
@pytest.mark.parametrize("g,hd", WIDTHS)
def test_decode_plain_matches_jnp_oracle(g, hd, layout, mode, dtype):
    """Rows 2, 2r, 2c and 2cr's plain versions against the reference's jnp
    decode_attention on the gathered view (or the cache rows)."""
    case = _case(7 * g + hd, g, hd, mode)
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    out = _port(t, layout)
    assert out.shape == (len(case["pos"]), t["q"].shape[1] * hd)
    kg, vg = _views(j, layout)
    _close(out, A.decode_attention(j["q"], kg, vg, j["pos"],
                                   rolling_window=case["window"]),
           TOL[dtype])


@pytest.mark.parametrize("mode", ["full", "rolling"])
@pytest.mark.parametrize("layout", ["paged", "rows"])
@pytest.mark.parametrize("g,hd", WIDTHS)
def test_decode_plain_matches_pallas_interpret(g, hd, layout, mode):
    """The Pallas decode kernel in interpret mode (fp32), as the reference's
    tests run it: its lengths are the visible counts, positions + 1, or
    min(positions + 1, W) over a rolling row."""
    case = _case(11 * g + hd, g, hd, mode)
    j, t = _jax(case, jnp.float32), _torch(case, torch.float32)
    kg, vg = _views(j, layout)
    w = case["window"]
    lengths = j["pos"] + 1
    if w:
        lengths = jnp.minimum(lengths, w)
        kg, vg = kg[:, :w], vg[:, :w]
    ref = pallas_decode(j["q"], kg, vg, lengths, kv_block=64, interpret=True)
    _close(_port(t, layout), ref, TOL["float32"])


# ---------------------------------------------------------------------------
# (b) the split body's arithmetic
# ---------------------------------------------------------------------------

def _hi_lo(p):
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def _slots(src, layout, b, s):
    """Slots 0..s-1 of batch row b's K or V [s, Kv, hd], through the table
    (pages) or from its cache row."""
    if layout == "paged":
        cache, tables = src
        idx = torch.arange(s)
        return cache[tables[b, idx // BS].long(), idx % BS]
    cache, rows = src
    return cache[int(rows[b]), :s]


def _split_fold(q, ksrc, vsrc, n, layout, hi_lo=True):
    """csrc/decode_attention_split.cuh's fold, in fp32 torch on the bf16
    values: row b's slots 0..n[b]-1 in chunks of L from slot 0, each in
    tiles of 64 whose 16-slot quarters belong to the 4 warps, every warp
    with its own online softmax (scores scaled by log2 e, exp2, P as bf16
    hi + lo, or one bf16 P); the warps merged in order, then the chunks;
    the output rounded to bf16.  ksrc/vsrc: (cache, tables) or (cache,
    rows), as ``layout``."""
    bsz, h, hd = q.shape
    kv = ksrc[0].shape[-2]
    g = h // kv
    c2 = hd ** -0.5 * LOG2E
    out = torch.zeros((bsz, kv, g, hd))
    for b in range(bsz):
        nb_ = int(n[b])
        nch = -(-nb_ // L)
        k = F.pad(_slots(ksrc, layout, b, nb_).float(),
                  (0, 0, 0, 0, 0, nch * L - nb_))
        v = F.pad(_slots(vsrc, layout, b, nb_).float(),
                  (0, 0, 0, 0, 0, nch * L - nb_))
        k = k.reshape(nch, L // 64, 4, 16, kv, hd)
        v = v.reshape(nch, L // 64, 4, 16, kv, hd)
        vis = (torch.arange(nch * L) < nb_).reshape(nch, L // 64, 4, 16)
        qf = q[b].float().reshape(kv, g, hd)
        m = torch.full((nch, 4, kv, g), -1e30)
        l = torch.zeros((nch, 4, kv, g))
        acc = torch.zeros((nch, 4, kv, g, hd))
        for t in range(L // 64):
            sc = torch.einsum("ngd,cwsnd->cwngs", qf, k[:, t]) * c2
            sc = torch.where(vis[:, t][:, :, None, None, :], sc,
                             torch.tensor(float("-inf")))
            mn = torch.maximum(m, sc.amax(-1))
            p = torch.exp2(sc - mn[..., None])
            corr = torch.exp2(m - mn)
            l = l * corr + p.sum(-1)
            hi, lo = _hi_lo(p) if hi_lo else (p.bfloat16().float(), 0 * p)
            acc = acc * corr[..., None] \
                + torch.einsum("cwngs,cwsnd->cwngd", hi, v[:, t]) \
                + torch.einsum("cwngs,cwsnd->cwngd", lo, v[:, t])
            m = mn
        cm = m.amax(1)                                  # the warps, in order
        cl, co = torch.zeros_like(cm), torch.zeros((nch, kv, g, hd))
        for w in range(4):
            f = torch.exp2(m[:, w] - cm)
            cl = cl + l[:, w] * f
            co = co + acc[:, w] * f[..., None]
        mx = cm.amax(0)                                 # the chunks, in order
        tl, to = torch.zeros_like(mx), torch.zeros((kv, g, hd))
        for c in range(nch):
            f = torch.exp2(cm[c] - mx)
            tl = tl + cl[c] * f
            to = to + co[c] * f[..., None]
        out[b] = to / torch.clamp(tl[..., None], min=1e-30)
    return out.bfloat16().reshape(bsz, h * hd)


def _excess(out, plain):
    return float(((out.float() - plain).abs()
                  - _paged.KERNEL_REL * plain.abs()).max())


@pytest.mark.parametrize("mode", ["full", "rolling"])
@pytest.mark.parametrize("g,hd", WIDTHS)
def test_split_fold_within_the_kernel_limit(g, hd, mode):
    """The split body's fold (bf16 values, bf16 output) against the plain
    version run in fp32 on the same values, within the limit chip_smoke.py
    holds the kernels to; over pages and over rows the fold gives the same
    bits."""
    case = _torch(_case(19 * g + hd, g, hd, mode), torch.bfloat16)
    w = case["window"]
    width = case["tables"].shape[1] * BS
    n = torch.clamp(case["pos"] + 1, max=w or width)
    paged = _split_fold(case["q"], (case["k"], case["tables"]),
                        (case["v"], case["tables"]), n, "paged")
    rows = _split_fold(case["q"], (case["k_rows"], case["rows"]),
                       (case["v_rows"], case["rows"]), n, "rows")
    assert torch.equal(paged, rows)
    f32 = lambda x: x.float()
    plain = kda.paged_decode_attention_plain(
        f32(case["q"]), f32(case["k"]), f32(case["v"]), case["tables"],
        case["pos"], rolling_window=w)
    assert _excess(paged, plain) <= _paged.KERNEL_ABS, _excess(paged, plain)


@pytest.mark.parametrize("n", [300, 4096])
def test_split_hi_lo_holds_the_limit_one_bf16_does_not(n):
    """The precision argument at mixtral's widths (Kv 8, g 4, hd 128;
    standard normal bf16 q, K, V; 4 rows of n visible slots): the split fold
    with P as bf16 hi + lo stays within the kernels' limit of the fp32
    result; with P rounded once to bf16 it does not."""
    rng = np.random.default_rng(n)
    b, kv, g, hd = 4, 8, 4, 128
    bf = lambda *shape: torch.tensor(
        rng.standard_normal(shape, np.float32)).bfloat16()
    q, k, v = bf(b, kv * g, hd), bf(b + 1, n, kv, hd), bf(b + 1, n, kv, hd)
    rows = torch.arange(b, dtype=torch.int32)
    pos = torch.full((b,), n - 1, dtype=torch.int32)
    plain = kda.contiguous_decode_attention_plain(q.float(), k.float(),
                                                  v.float(), rows, pos)
    excess = {label: _excess(_split_fold(q, (k, rows), (v, rows), pos + 1,
                                         "rows", hi_lo), plain)
              for label, hi_lo in (("hi+lo", True), ("bf16", False))}
    assert excess["hi+lo"] <= _paged.KERNEL_ABS, excess
    assert excess["bf16"] > _paged.KERNEL_ABS, excess


def test_split_shapes_and_workspace():
    """The CUDA wrappers' shape check (run on CUDA calls; no fallback) and
    the size of the partial states' workspace."""
    for h, kv in ((32, 32), (32, 8), (32, 2), (16, 1), (5, 1)):   # g 1..16
        q = torch.zeros((3, h, 64), dtype=torch.bfloat16)
        _paged.check_decode_split(q, kv, [q])
    for h, kv, hd in ((34, 2, 64), (32, 1, 64), (8, 2, 48), (8, 2, 256),
                      (8, 2, 8)):
        q = torch.zeros((3, h, hd), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="g = H / Kv"):
            _paged.check_decode_split(q, kv, [q])
    # (max, sum, o[hd]) per (row, query head, chunk of L slots)
    assert _paged.decode_workspace(8, 32, 8, 128, 4096) == \
        8 * 32 * (4096 // L) * 130
    assert _paged.decode_workspace(4, 12, 12, 64, 1500) == \
        4 * 12 * -(-1500 // L) * 66
    assert _paged.decode_workspace(2, 4, 2, 16, L) == 2 * 4 * 1 * 18
    assert _paged.decode_workspace(2, 4, 2, 16, L + 1) == 2 * 4 * 2 * 18


# ---------------------------------------------------------------------------
# (d) the int8 decode limit's flip term
# ---------------------------------------------------------------------------

QH, QKV, QHD, QW = 32, 8, 128, 4096       # chip_smoke.py's rolling case
QPOS = [99, 700, 2047, 4095, 4096, 4600, 7000, 8999]
QSEED = 14        # a draw whose kernel-order denominator flips one p8


def _kernel_order_sum(e, n):
    """The first int8 decode kernel's denominator (one warp a head over
    the whole row, before the split body): lane l of a warp sums slots l,
    l + 32, ... in order, then a butterfly over the 32 lanes.  e [..., S]
    fp32; the first n slots."""
    m = -(-n // 32)
    x = F.pad(e[..., :n], (0, m * 32 - n)).reshape(*e.shape[:-1], m, 32)
    acc = torch.zeros(*e.shape[:-1], 32)
    for i in range(m):
        acc = acc + x[..., i, :]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def _quant_case():
    rng = np.random.default_rng(QSEED)
    b = len(QPOS)
    bf = lambda *shape: torch.tensor(
        rng.standard_normal(shape, np.float32)).bfloat16()
    q, k, v = bf(b, QH, QHD), bf(b, QW, QKV, QHD), bf(b, QW, QKV, QHD)
    (k8, ks), (v8, vs) = P.quantize_kv(k), P.quantize_kv(v)
    return q, k8, ks, v8, vs, torch.tensor(QPOS, dtype=torch.int32)


def _quant_out(p8, ps, v8, shape):
    """out = (p8 . v8) * ps, the int8 decode's last step, in fp32."""
    return (torch.einsum("bgqs,bsgd->bgqd", p8.double(), v8.double()).float()
            * ps[..., None]).reshape(shape)


def test_int8_decode_flip_term():
    """At chip_smoke.py's rolling int8 decode case (H 32, Kv 8, hd 128,
    W 4096, B 8 at positions 99-8999), the plain version with its softmax
    denominator summed in the first int8 kernel's order quantizes one
    probability one step apart.  The limit without the flip term refuses
    that output; with the term it admits it.  It still refuses a dropped visible slot (the
    largest p of a row and head) and a one-step error at a slot off the
    boundary."""
    q, k8, ks, v8, vs, pos = _quant_case()
    w = QW
    plain = P.decode_attention_quant(q.float(), k8, ks, v8, vs, pos,
                                     rolling_window=w)
    term = _paged.quant_flip_term(q, k8, ks, v8, vs, pos, rolling_window=w)
    x, delta, ps = _paged.quant_decode_x(q, k8, ks, vs, pos,
                                         rolling_window=w)
    pv, valid = P.decode_quant_pv(q.float(), k8, ks, vs, pos,
                                  rolling_window=w)
    n = valid.sum(-1)
    p_plain = P.quantize_kv(pv)[0].float()
    assert torch.equal(p_plain, torch.round(x).clamp(-127, 127))
    # the same e = exp(score - max), its sum in the plain order (as the
    # plain version: the same bits) and in the kernel's
    e = torch.exp(_scores(q, k8, ks, pos, w))
    vs_t = vs.permute(0, 2, 1)[:, :, None, :].float()
    assert torch.equal(e / e.sum(-1, keepdim=True) * vs_t, pv)
    den = torch.stack([_kernel_order_sum(e[r], int(n[r]))
                       for r in range(q.shape[0])])
    p8k, psk = P.quantize_kv(e / den[..., None] * vs_t)
    flips = (p8k.float() != p_plain).nonzero().tolist()
    assert len(flips) == 1, flips
    bi, kh, j, s = flips[0]
    # the flip lies on a rounding boundary, inside its slot's delta
    ax = float(x[bi, kh, j, s].abs())
    assert abs(ax - np.floor(ax) - 0.5) <= float(delta[bi, kh, j, s])
    shape = plain.shape
    kern = _quant_out(p8k.float(), psk.float(), v8, shape).bfloat16()
    diff = (kern.float() - plain).abs()
    over = diff - _paged.KERNEL_REL * plain.abs()
    assert float(over.max()) > _paged.KERNEL_ABS           # without the term
    assert float((over - term).max()) <= _paged.KERNEL_ABS  # with it
    # a dropped visible slot: the largest p of the flipped row and head
    top = int(p_plain[bi, kh, j].argmax())
    dropped = p_plain.clone()
    dropped[bi, kh, j, top] = 0
    out = _quant_out(dropped, ps, v8, shape).bfloat16().float()
    assert _quant_excess(out, plain, term) > _paged.KERNEL_ABS
    # a one-step error at a slot off the boundary, in a (row, head) with
    # no boundary slot: the visible slot whose step shows most
    near = ((x.abs() - torch.floor(x.abs()) - 0.5).abs() <= delta)
    clean = (~near.any(-1)).nonzero().tolist()
    assert clean
    cb, ck, cj = clean[0]
    g = QH // QKV
    cols = slice((ck * g + cj) * QHD, (ck * g + cj + 1) * QHD)
    room = (_paged.KERNEL_REL * plain[cb, cols].abs() + _paged.KERNEL_ABS)
    step = ps[cb, ck, cj] * v8[cb, :, ck].float().abs()     # [S, hd]
    gain = (step - room[None]).amax(-1)
    gain[int(n[cb]):] = -1
    s_off = int(gain.argmax())
    assert float(delta[cb, ck, cj, s_off]) < abs(
        float(x[cb, ck, cj, s_off].abs()) % 1 - 0.5)
    stepped = p_plain.clone()
    stepped[cb, ck, cj, s_off] += 1
    out = _quant_out(stepped, ps, v8, shape).bfloat16().float()
    assert _quant_excess(out, plain, term) > _paged.KERNEL_ABS


def _scores(q, k8, ks, pos, w):
    """decode_attention_quant's masked fp32 scores less their row max
    [B, Kv, g, S]."""
    b, h, hd = q.shape
    s, kv = k8.shape[1], k8.shape[2]
    q8, qs = P.quantize_kv(q.float().reshape(b, kv, h // kv, hd))
    s32 = P._int_dot("bgqd,bsgd->bgqs", q8, k8)
    ks_t = ks.permute(0, 2, 1)[:, :, None, :].float()
    sc = s32 * qs[..., None].float() * ks_t * (hd ** -0.5)
    valid = P._decode_valid(s, pos, w)
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.full_like(sc, P.NEG_INF))
    return sc - sc.amax(-1, keepdim=True)


def _quant_excess(out, plain, term):
    return float(((out - plain).abs() - _paged.KERNEL_REL * plain.abs()
                  - term).max())
