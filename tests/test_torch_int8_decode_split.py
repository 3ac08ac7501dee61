"""The four int8 decode kernels (PERF.md rows 2b and 2br: paged, full cache
and rolling; 2bc and 2bcr: over contiguous rows) share one split body,
csrc/decode_attention_quant_split.cuh, which runs only on the card.  Here,
on the CPU, its passes mirrored in torch: the visible slots cut into
chunks of 512 from slot 0; per chunk the scores ((s32 * qs) * ks) * scale
(the dot exact) and their max; m the max of the chunk maxima; per chunk
the sum of e = exp(s - m) in the kernel's order (lane l of a warp sums
slots l, l + 32, ... in order, then a butterfly over the 32 lanes), the
chunk sums added in chunk order; pv = (e / l) * vs and its max per chunk,
amax the max of those; p8 = round(pv / sp) clipped, sp = amax / 127 +
1e-8; per chunk the exact int32 partials of p8 . v8, summed; out =
bf16(float(o) * bf16(sp)).  Against the plain version on the same values,
at g 1, 4 and 16 with hd 16 and 128, on contexts of 1, 512 and 513 slots
and wrapped rolling rows, paged and over rows:

- p8 and ps equal the plain version's wherever the plain x = pv / sp is
  not within ``_paged.quant_decode_x``'s delta of a rounding half-integer
  (only the denominator's order differs);
- the output is within the limit chip_smoke.py holds the kernels to,
  KERNEL_REL * |plain| + KERNEL_ABS plus ``_paged.quant_flip_term``;
- the merged int32 partials equal the whole row's integer dot, and pages
  and rows give the same bits.

Then the workspace's size and layout (``_paged.quant_decode_workspace``,
``_paged.quant_decode_p8``, read back as the kernel writes it) and the
CUDA wrappers' shape check.  Tolerance: none but the kernels' limit; the
mirror and the plain version make the same fp32 operations."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _paged
from repro_torch.kernels import decode_attention as kda
from repro_torch.models import attention as P

L = _paged.DECODE_SPLIT
WIDTHS = [(g, hd) for g in (1, 4, 16) for hd in (16, 128)]
KV = 2
BS = 8                                   # page size
# contexts of 1 slot, of one chunk and one more, short and long rows; the
# rolling batch wraps rows past W (not a multiple of the chunk) and has a
# row of exactly W slots
FULL_POS = [0, L - 1, L, 37, L + 43, 130]
ROLL_POS = [0, L - 1, L, 3 * L, L + 7, 5 * L]
WINDOW = L + 8
FULL_WIDTH = L + 48


def _case(seed, g, hd, mode):
    """One logical int8 cache in both layouts: a shuffled paged cache with
    tables [B, nb] (the trash block last, unused blocks random) and rows
    [R, S, Kv, hd] (S = nb * BS) whose batch row b is cache row rows[b] and
    equals the table's gathered view; K and V quantized from standard
    normal bf16 values as the engine stores them."""
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
    bf = lambda *shape: torch.tensor(
        rng.standard_normal(shape, np.float32)).bfloat16()
    (k8, ks), (v8, vs) = (P.quantize_kv(bf(n_phys, BS, KV, hd))
                          for _ in range(2))
    rows = torch.tensor(rng.permutation(b + 2)[:b], dtype=torch.int32)
    t = torch.tensor(tables)
    cache = [k8, ks, v8, vs]
    row_cache = []
    for c in cache:
        r = P.quantize_kv(bf(b + 2, nb * BS, KV, hd))[0] if c.dtype == \
            torch.int8 else bf(b + 2, nb * BS, KV)
        r[rows.long()] = P.gather_paged_cache(c, t)
        row_cache.append(r)
    return dict(q=bf(b, KV * g, hd), paged=cache, tables=t,
                rows_cache=row_cache, rows=rows, pos=torch.tensor(pos),
                window=WINDOW if mode == "rolling" else 0)


def _views(c, layout):
    """Each batch row's [B, S, Kv, hd] k8, ks, v8, vs."""
    if layout == "paged":
        return [P.gather_paged_cache(x, c["tables"]) for x in c["paged"]]
    return [x[c["rows"].long()] for x in c["rows_cache"]]


def _slots(c, layout, b, n):
    """Slots 0..n-1 of batch row b: k8, ks, v8, vs, read as the kernel reads
    them (through the table, or from the row)."""
    if layout == "paged":
        idx = torch.arange(n)
        page = c["tables"][b, idx // BS].long()
        return [x[page, idx % BS] for x in c["paged"]]
    return [x[int(c["rows"][b]), :n] for x in c["rows_cache"]]


def _chunk_sum(e):
    """The sums kernel's order over one chunk: e [..., len <= L]; lane l
    adds slots l, l + 32, ... in order from 0, then a butterfly."""
    x = torch.nn.functional.pad(e, (0, L - e.shape[-1]))
    x = x.reshape(*e.shape[:-1], L // 32, 32)
    acc = torch.zeros(*e.shape[:-1], 32)
    for i in range(L // 32):
        acc = acc + x[..., i, :]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def _mirror(c, layout):
    """The split body's passes in fp32 torch.  Returns out [B, H * hd]
    bf16, and per batch row its p8 [Kv, g, n] and ps [Kv, g], the merged
    int32 partials and the whole row's int dot [Kv, g, hd], and the
    workspace's first region as the kernel leaves it (p8 over each chunk's
    scores)."""
    q = c["q"]
    b, h, hd = q.shape
    g = h // KV
    width = c["tables"].shape[1] * BS
    if c["window"]:
        width = min(width, c["window"])
    n_split = -(-width // L)
    ws = torch.full((_paged.quant_decode_workspace(b, h, KV, hd, width),),
                    float("nan"))
    p_ws = ws[:b * h * n_split * L].view(b, KV, n_split, g, L)
    out, rows = torch.zeros(b, KV, g, hd), []
    for r in range(b):
        pos = int(c["pos"][r])
        n = min(min(pos + 1, c["window"]) if c["window"] else pos + 1, width)
        k8, ks, v8, vs = _slots(c, layout, r, n)
        q8, qs = P.quantize_kv(q[r].float().reshape(KV, g, hd))
        s32 = torch.einsum("ngd,snd->ngs", q8.long(), k8.long()).float()
        s = s32 * qs.float()[..., None] * ks.float().T[:, None, :] \
            * (hd ** -0.5)
        cuts = [(c0, min(c0 + L, n)) for c0 in range(0, n, L)]
        m = torch.stack([s[..., a:z].amax(-1) for a, z in cuts]).amax(0)
        e = torch.exp(s - m[..., None])
        l = torch.zeros(KV, g)
        for a, z in cuts:                              # in chunk order
            l = l + _chunk_sum(e[..., a:z])
        pv = e / l[..., None] * vs.float().T[:, None, :]
        amax = torch.stack([pv[..., a:z].abs().amax(-1)
                            for a, z in cuts]).amax(0)
        sp = amax / torch.full_like(amax, 127.0) + 1e-8
        p8 = torch.clamp(torch.round(pv / sp[..., None]), -127, 127)
        parts = [torch.einsum("ngs,snd->ngd", p8[..., a:z].long(),
                              v8[a:z].long()) for a, z in cuts]
        o = torch.stack(parts).sum(0)
        whole = torch.einsum("ngs,snd->ngd", p8.long(), v8.long())
        ps = sp.bfloat16().float()
        out[r] = o.float() * ps[..., None]
        for i, (a, z) in enumerate(cuts):
            p_ws[r, :, i, :, :z - a] = p8[..., a:z]
        rows.append(dict(p8=p8, ps=ps, o=o, whole=whole, n=n))
    return out.bfloat16().reshape(b, h * hd), rows, ws, width


def _plain(c, layout):
    f = lambda x: x.float() if x.is_floating_point() else x
    index = c["tables"] if layout == "paged" else c["rows"]
    call = (kda.paged_decode_attention_quant_plain if layout == "paged"
            else kda.contiguous_decode_attention_quant_plain)
    cache = c["paged"] if layout == "paged" else c["rows_cache"]
    return call(f(c["q"]), *cache, index, c["pos"],
                rolling_window=c["window"])


@pytest.mark.parametrize("mode", ["full", "rolling"])
@pytest.mark.parametrize("g,hd", WIDTHS)
def test_int8_split_mirror_against_the_plain_version(g, hd, mode):
    """The split body's passes against the plain version in fp32 on the same
    values: p8 and ps off the rounding boundaries, the output within the
    kernels' limit with the flip term, the merged partials, pages == rows."""
    c = _case(23 * g + hd + (mode == "rolling"), g, hd, mode)
    out, rows, _, _ = _mirror(c, "paged")
    out_rows, rows_r, _, _ = _mirror(c, "rows")
    assert torch.equal(out, out_rows)
    for a, z in zip(rows, rows_r):
        assert torch.equal(a["p8"], z["p8"]) and torch.equal(a["ps"], z["ps"])
    views = _views(c, "paged")
    plain = _plain(c, "paged")
    assert torch.equal(plain, _plain(c, "rows"))
    q, (k8, ks, v8, vs), pos, w = c["q"], views, c["pos"], c["window"]
    x, delta, ps = _paged.quant_decode_x(q, k8, ks, vs, pos,
                                         rolling_window=w)
    ax = x.double().abs()
    off = (ax - torch.floor(ax) - 0.5).abs() > delta
    plain_p8 = torch.round(x).clamp(-127, 127)
    for r, row in enumerate(rows):
        n = row["n"]
        assert torch.equal(row["ps"], ps[r])
        keep = off[r, ..., :n]
        assert torch.equal(row["p8"][keep], plain_p8[r, ..., :n][keep])
        assert torch.equal(row["o"], row["whole"])
    term = _paged.quant_flip_term(q, k8, ks, v8, vs, pos, rolling_window=w)
    excess = ((out.float() - plain).abs() - _paged.KERNEL_REL * plain.abs()
              - term).max()
    assert float(excess) <= _paged.KERNEL_ABS, float(excess)


def test_int8_split_workspace():
    """The workspace's size, and its first region read back by
    ``_paged.quant_decode_p8`` as the kernel writes it: chunk c of head j
    of (row b, kv head kh) at cell ((b Kv + kh) n_split + c) g + j."""
    # per (row, query head, chunk of L slots) L scores, their max, sum and
    # max |pv|; per (row, kv head, chunk) L V scales; per (row, query head)
    # hd int32 sums; per (row, kv head) a count
    assert _paged.quant_decode_workspace(8, 32, 8, 128, 4096) == \
        8 * 32 * 8 * (L + 3) + 8 * 8 * 8 * L + 8 * 32 * 128 + 8 * 8
    assert _paged.quant_decode_workspace(4, 32, 2, 128, 640) == \
        4 * 32 * 2 * (L + 3) + 4 * 2 * 2 * L + 4 * 32 * 128 + 4 * 2
    assert _paged.quant_decode_workspace(2, 4, 2, 16, L) == \
        2 * 4 * (L + 3) + 2 * 2 * L + 2 * 4 * 16 + 2 * 2
    assert _paged.quant_decode_workspace(2, 4, 2, 16, L + 1) == \
        2 * 4 * 2 * (L + 3) + 2 * 2 * 2 * L + 2 * 4 * 16 + 2 * 2
    c = _case(5, 4, 16, "rolling")
    _, rows, ws, width = _mirror(c, "paged")
    b, h = c["q"].shape[:2]
    p8 = _paged.quant_decode_p8(ws, b, h, KV, width)
    assert p8.shape == (b, h, -(-width // L) * L)
    for r, row in enumerate(rows):
        assert torch.equal(p8[r, :, :row["n"]], row["p8"].reshape(h, -1))


def test_int8_split_shape_check():
    """The CUDA wrappers' shape check (run on CUDA calls; no fallback): g =
    H / Kv in 1..16, hd in 16, 32, 64, 128, 16-byte aligned int8 caches."""
    for h, kv, hd in ((32, 32, 64), (32, 8, 128), (32, 2, 128), (16, 1, 16),
                      (5, 1, 32)):
        q = torch.zeros((3, h, hd), dtype=torch.bfloat16)
        k8 = torch.zeros((4, 16, kv, hd), dtype=torch.int8)
        _paged.check_decode_split(q, kv, (k8, k8))
    for h, kv, hd in ((34, 2, 64), (32, 1, 64), (8, 2, 48), (8, 2, 256),
                      (8, 2, 8)):
        q = torch.zeros((3, h, hd), dtype=torch.bfloat16)
        k8 = torch.zeros((4, 16, kv, hd), dtype=torch.int8)
        with pytest.raises(ValueError, match="g = H / Kv"):
            _paged.check_decode_split(q, kv, (k8, k8))
    q = torch.zeros((3, 8, 16), dtype=torch.bfloat16)
    k8 = torch.zeros(4 * 16 * 2 * 16 + 1, dtype=torch.int8)[1:]
    with pytest.raises(ValueError, match="aligned"):
        _paged.check_decode_split(q, 2, (k8.view(4, 16, 2, 16), k8))
