"""The port's attention kernels' plain PyTorch versions (which the
wrappers run for CPU tensors) against the reference's jnp oracles and its
interpret-mode Pallas kernels, on the same numpy inputs: paged span and
decode attention, prefill (flash) attention, and the int8-cache twins.

Tolerances: fp32 <= 1e-5 (the algorithm: the same running softmax with
sums taken in another order), bf16 <= 2e-2 (scores and probabilities are
rounded to bf16 at the same places, but the two frameworks round their
contractions differently).  Exceptions are stated at each test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.ref import flash_attention_ref
from repro.kernels.span_attention import paged_span_attention as pallas_span
from repro.kernels.span_attention import \
    paged_span_attention_quant as pallas_span_quant
from repro.models import attention as A
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import span_attention as ksa
from repro_torch.models import attention as P

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _paged_case(seed, n_rows, ctx_max, h, kv, hd, bs=16, n_tok=None):
    """Ragged rows with random prefix lengths; shuffled physical blocks;
    table entries past each prefix point at the trash block (last), which
    holds random values, as do the unused blocks."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(1, ctx_max + 1, n_rows)
    nb = -(-ctx_max // bs)
    n_phys = n_rows * nb + 3
    perm = rng.permutation(n_phys - 1)
    tables = np.full((n_rows, nb), n_phys - 1, np.int32)
    used = 0
    for r in range(n_rows):
        k = -(-ctx[r] // bs)
        tables[r, :k] = perm[used:used + k]
        used += k
    if n_tok is None:                       # decode: one token per row
        rows = np.arange(n_rows, dtype=np.int32)
        pos = (ctx - 1).astype(np.int32)
    else:                                   # span: ragged positions < ctx
        rows = np.sort(rng.integers(0, n_rows, n_tok)).astype(np.int32)
        pos = np.array([rng.integers(0, ctx[r]) for r in rows], np.int32)
    n = len(rows)
    return dict(q=rng.standard_normal((n, h, hd), np.float32),
                k=rng.standard_normal((n_phys, bs, kv, hd), np.float32),
                v=rng.standard_normal((n_phys, bs, kv, hd), np.float32),
                tables=tables, pos=pos, rows=rows)


def _jax(case, dt):
    return {k: (jnp.asarray(v, dt) if v.dtype == np.float32 else jnp.asarray(v))
            for k, v in case.items()}


def _torch(case, dt):
    return {k: (torch.tensor(v).to(dt) if v.dtype == np.float32
                else torch.tensor(v)) for k, v in case.items()}


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_span_plain_matches_oracle_and_pallas(dtype, hd, g):
    kv = 2
    case = _paged_case(hd + g, n_rows=3, ctx_max=64, h=kv * g, kv=kv, hd=hd,
                       n_tok=12)
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    out = ksa.paged_span_attention(t["q"], t["k"], t["v"], t["tables"],
                                   t["pos"], t["rows"])
    assert out.shape == (12, kv * g * hd) and out.dtype == tdt
    oracle = A.paged_span_attention(j["q"], j["k"], j["v"], j["tables"],
                                    j["pos"], j["rows"])
    pallas = pallas_span(j["q"], j["k"], j["v"], j["pos"], j["rows"],
                         j["tables"], interpret=True)
    _close(out, oracle, dtype)
    _close(out, pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_decode_plain_matches_oracle_and_pallas(dtype, hd, g):
    kv = 2
    case = _paged_case(10 * hd + g, n_rows=4, ctx_max=80, h=kv * g, kv=kv,
                       hd=hd)
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    out = kda.paged_decode_attention(t["q"], t["k"], t["v"], t["tables"],
                                     t["pos"])
    assert out.shape == (4, kv * g * hd) and out.dtype == tdt
    kg = A.gather_paged_cache(j["k"], j["tables"])
    vg = A.gather_paged_cache(j["v"], j["tables"])
    oracle = A.decode_attention(j["q"], kg, vg, j["pos"])
    pallas = pallas_decode(j["q"], kg, vg, j["pos"] + 1, kv_block=16,
                           interpret=True)
    _close(out, oracle, dtype)
    _close(out, pallas, dtype)


def _poison_unused_blocks(c):
    """Set every physical block no visible slot lives in to extremes."""
    used = {int(c["tables"][r, s // 16])
            for r, p in zip(c["rows"].tolist(), c["pos"].tolist())
            for s in range(p + 1)}
    dead = [b for b in range(c["k"].shape[0]) if b not in used]
    assert c["k"].shape[0] - 1 in dead          # the trash block
    c["k"][dead] = 1e4
    c["v"][dead] = -1e4


def test_plain_ignores_trash_and_pages_past_the_prefix():
    """Whatever the trash block and the unused pages hold, the result is
    the same: only slots 0..pos of a row are visible."""
    s = _torch(_paged_case(3, n_rows=3, ctx_max=64, h=4, kv=2, hd=16,
                           n_tok=9), torch.float32)
    d = _torch(_paged_case(4, n_rows=3, ctx_max=64, h=4, kv=2, hd=16),
               torch.float32)
    span = lambda: ksa.paged_span_attention(s["q"], s["k"], s["v"],
                                            s["tables"], s["pos"], s["rows"])
    dec = lambda: kda.paged_decode_attention(d["q"], d["k"], d["v"],
                                             d["tables"], d["pos"])
    before = span(), dec()
    _poison_unused_blocks(s)
    _poison_unused_blocks(d)
    torch.testing.assert_close(span(), before[0], rtol=0, atol=0)
    torch.testing.assert_close(dec(), before[1], rtol=0, atol=0)


def _span_args(dtype=torch.bfloat16):
    t = _torch(_paged_case(5, n_rows=2, ctx_max=32, h=4, kv=2, hd=16,
                           n_tok=6), dtype)
    return [t["q"], t["k"], t["v"], t["tables"], t["pos"], t["rows"]]


def _decode_args(dtype=torch.bfloat16):
    t = _torch(_paged_case(6, n_rows=2, ctx_max=32, h=4, kv=2, hd=16), dtype)
    return [t["q"], t["k"], t["v"], t["tables"], t["pos"]]


def _bad(args, i, value):
    args = list(args)
    args[i] = value(args[i])
    return args


WRAPPERS = [(ksa.paged_span_attention, _span_args),
            (kda.paged_decode_attention, _decode_args)]
BAD_INPUTS = [
    ("fp16", lambda a: _bad(_bad(_bad(a, 0, lambda x: x.half()), 1,
                                 lambda x: x.half()), 2, lambda x: x.half()),
     TypeError),
    ("mixed dtypes", lambda a: _bad(a, 0, lambda x: x.float()), TypeError),
    ("q rank", lambda a: _bad(a, 0, lambda x: x[0]), ValueError),
    ("head width", lambda a: _bad(_bad(a, 1, lambda x: x[..., :8]), 2,
                                  lambda x: x[..., :8]), ValueError),
    ("k/v shapes", lambda a: _bad(a, 2, lambda x: x[:-1]), ValueError),
    ("int64 table", lambda a: _bad(a, 3, lambda x: x.long()), TypeError),
    ("positions length", lambda a: _bad(a, 4, lambda x: x[:-1]), ValueError),
    ("devices", lambda a: _bad(a, 1, lambda x: x.to("meta")), ValueError),
]


@pytest.mark.parametrize("wrapper,make", WRAPPERS,
                         ids=["span", "decode"])
@pytest.mark.parametrize("what,spoil,exc", BAD_INPUTS,
                         ids=[b[0] for b in BAD_INPUTS])
def test_wrappers_reject_bad_inputs(wrapper, make, what, spoil, exc):
    with pytest.raises(exc):
        wrapper(*spoil(make()))


def test_wrappers_reject_windows_and_count_no_cpu_launches():
    """A window over a full cache is not a path (windowed models keep
    rolling caches, with wrappers of their own), and a rolling window
    must be positive; on the CPU no wrapper counts a launch."""
    with pytest.raises(NotImplementedError):
        ksa.paged_span_attention(*_span_args(), window=8)
    with pytest.raises(ValueError):
        kda.paged_decode_attention_rolling(*_decode_args(), window=0)
    wrappers = (ksa.paged_span_attention, kda.paged_decode_attention,
                kda.paged_decode_attention_rolling)
    before = [w.launches for w in wrappers]
    ksa.paged_span_attention(*_span_args())
    kda.paged_decode_attention(*_decode_args())
    kda.paged_decode_attention_rolling(*_decode_args(), window=8)
    assert [w.launches for w in wrappers] == before


# ---------------------------------------------------------------------------
# Prefill attention (flash kernel's plain version: chunked_attention)
# ---------------------------------------------------------------------------

# flash_attention_ref normalizes the probabilities before it rounds them
# to bf16, chunked_attention after (per kv tile): in bf16 the two differ
# by up to a few bf16 steps of the output (observed 0.016 at hd 64)
TOL_FLASH_REF = {"float32": 1e-5, "bfloat16": 4e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [0, 20])
def test_prefill_attention_plain_matches_oracles(dtype, hd, g, window):
    """A ragged S (37: no power of two, no tile multiple) with kv tiles of
    16, so the running softmax crosses tiles and a partial last tile."""
    b, s, kv = 2, 37, 2
    rng = np.random.default_rng(100 * hd + 10 * g + window)
    case = {n: rng.standard_normal((b, s, h, hd), np.float32)
            for n, h in (("q", kv * g), ("k", kv), ("v", kv))}
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    pos = torch.arange(s, dtype=torch.int32)
    out = kfa.flash_attention(t["q"], t["k"], t["v"], pos, window=window,
                              kv_block=16)
    assert out.shape == (b, s, kv * g * hd) and out.dtype == tdt
    oracle = A.chunked_attention(j["q"], j["k"], j["v"], causal=True,
                                 window=window, kv_block=16,
                                 q_positions=jnp.arange(s))
    _close(out, oracle, dtype)
    ref = flash_attention_ref(j["q"], j["k"], j["v"], causal=True,
                              window=window)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL_FLASH_REF[dtype],
                               atol=TOL_FLASH_REF[dtype])


def test_prefill_attention_positions_and_tile():
    """Query positions shift the causal mask as the reference's
    ``q_positions`` do, and the plain version's kv tile changes only the
    order of fp32 sums."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 24, 2, 16), np.float32)
               for _ in range(3))
    qpos = np.arange(24, dtype=np.int32)[::-1].copy()
    t = [torch.tensor(a) for a in (q, k, v)]
    out = kfa.flash_attention(*t, torch.tensor(qpos), kv_block=8)
    oracle = A.chunked_attention(*map(jnp.asarray, (q, k, v)), kv_block=8,
                                 q_positions=jnp.asarray(qpos))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)
    other = kfa.flash_attention(*t, torch.tensor(qpos), kv_block=24)
    torch.testing.assert_close(other, out, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

def test_quantize_kv_is_bit_exact_with_ties():
    """Values and bf16 scales equal the reference's bit for bit, in fp32
    and bf16, including ties at .5 (round half to even) and zero rows."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 5, 32), np.float32) * \
        rng.uniform(1e-3, 1e3, (64, 5, 1)).astype(np.float32)
    # max 127 gives a scale of exactly 1.0, so k + 0.5 is a tie
    ties = np.zeros((4, 5, 32), np.float32)
    ties[..., 0] = 127.0
    ties[..., 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    ties[3] = 0.0                                   # an all-zero row
    x = np.concatenate([x, ties])
    for jdt, tdt in DTYPES.values():
        jq, js = A.quantize_kv(jnp.asarray(x, jdt))
        tq, ts = P.quantize_kv(torch.tensor(x).to(tdt))
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js, np.float32))
    tq, _ = P.quantize_kv(torch.tensor(ties))
    assert tq[0, 0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


def _quant_case(seed, **kw):
    """``_paged_case`` with its K/V cache quantized by the reference."""
    c = _paged_case(seed, **kw)
    for n in ("k", "v"):
        x8, xs = A.quantize_kv(jnp.asarray(c[n]))
        c[n] = np.asarray(x8)
        c[n + "s"] = np.asarray(xs, np.float32)
    return c


def _quant_jax(c, jdt):
    j = {n: jnp.asarray(a) for n, a in c.items()}
    j["q"] = jnp.asarray(c["q"], jdt)
    j["ks"], j["vs"] = (jnp.asarray(c[n], jnp.bfloat16) for n in ("ks", "vs"))
    return j


def _quant_torch(c, tdt):
    t = {n: torch.tensor(a) for n, a in c.items()}
    t["q"] = t["q"].to(tdt)
    t["ks"], t["vs"] = t["ks"].bfloat16(), t["vs"].bfloat16()
    return t


def _quant_args(t, *names):
    return [t[n] for n in ("q", "k", "ks", "v", "vs", "tables", *names)]


# Against the reference's own oracles the int8 plain versions are exact in
# the integer dots and follow the same fp32 ops, so fp32 agrees to 1e-5.
# The Pallas kernel keeps its q and p scales in fp32 where quantize_kv
# (which the reference engine runs) rounds them to bf16: 2^-9 relative per
# scale, so there 2e-2 (tests/test_span_kernel.py's limit for the same
# comparison).
TOL_PALLAS_QUANT = 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_span_quant_plain_matches_oracles_and_pallas(dtype, hd, g):
    kv = 2
    c = _quant_case(20 * hd + g, n_rows=3, ctx_max=64, h=kv * g, kv=kv,
                    hd=hd, n_tok=12)
    jdt, tdt = DTYPES[dtype]
    j, t = _quant_jax(c, jdt), _quant_torch(c, tdt)
    for tile in (16, 32, 512):        # one page, two pages, the engine's
        out = ksa.paged_span_attention_quant(*_quant_args(t, "pos", "rows"),
                                             kv_block=tile)
        assert out.shape == (12, kv * g * hd) and out.dtype == tdt
        native = A.paged_span_attention_quant_native(
            *_quant_args(j, "pos", "rows"), kv_block=tile)
        gather = A.paged_span_attention_quant(
            *_quant_args(j, "pos", "rows"), kv_block=tile)
        _close(out, native, dtype)
        _close(out, gather, dtype)
        ported_gather = P.paged_span_attention_quant(
            *_quant_args(t, "pos", "rows"), kv_block=tile)
        torch.testing.assert_close(ported_gather, out, rtol=0, atol=0)
    out16 = ksa.paged_span_attention_quant(*_quant_args(t, "pos", "rows"),
                                           kv_block=16)
    pallas = pallas_span_quant(j["q"], j["k"], j["ks"], j["v"], j["vs"],
                               j["pos"], j["rows"], j["tables"],
                               interpret=True)
    np.testing.assert_allclose(out16.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=TOL_PALLAS_QUANT, atol=TOL_PALLAS_QUANT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_decode_quant_plain_matches_oracle(dtype, hd, g):
    kv = 2
    c = _quant_case(30 * hd + g, n_rows=4, ctx_max=80, h=kv * g, kv=kv,
                    hd=hd)
    jdt, tdt = DTYPES[dtype]
    j, t = _quant_jax(c, jdt), _quant_torch(c, tdt)
    out = kda.paged_decode_attention_quant(*_quant_args(t, "pos"))
    assert out.shape == (4, kv * g * hd) and out.dtype == tdt
    gv = lambda a: A.gather_paged_cache(a, j["tables"])
    oracle = A.decode_attention_quant(j["q"], gv(j["k"]), gv(j["ks"]),
                                      gv(j["v"]), gv(j["vs"]), j["pos"])
    _close(out, oracle, dtype)


def test_quant_plain_ignores_trash_and_pages_past_the_prefix():
    s = _quant_torch(_quant_case(9, n_rows=3, ctx_max=64, h=4, kv=2, hd=16,
                                 n_tok=9), torch.float32)
    d = _quant_torch(_quant_case(10, n_rows=3, ctx_max=64, h=4, kv=2, hd=16),
                     torch.float32)
    span = lambda: ksa.paged_span_attention_quant(
        *_quant_args(s, "pos", "rows"))
    dec = lambda: kda.paged_decode_attention_quant(*_quant_args(d, "pos"))
    before = span(), dec()
    for c in (s, d):
        used = {int(c["tables"][r, x // 16])
                for r, p in zip(c["rows"].tolist(), c["pos"].tolist())
                for x in range(p + 1)}
        dead = [b for b in range(c["k"].shape[0]) if b not in used]
        c["k"][dead], c["v"][dead] = 127, -127
        c["ks"][dead], c["vs"][dead] = 1e4, 1e4
    torch.testing.assert_close(span(), before[0], rtol=0, atol=0)
    torch.testing.assert_close(dec(), before[1], rtol=0, atol=0)


def _quant_span_args():
    t = _quant_torch(_quant_case(11, n_rows=2, ctx_max=32, h=4, kv=2, hd=16,
                                 n_tok=6), torch.bfloat16)
    return _quant_args(t, "pos", "rows")


def _quant_decode_args():
    t = _quant_torch(_quant_case(12, n_rows=2, ctx_max=32, h=4, kv=2, hd=16),
                     torch.bfloat16)
    return _quant_args(t, "pos")


QUANT_WRAPPERS = [(ksa.paged_span_attention_quant, _quant_span_args),
                  (kda.paged_decode_attention_quant, _quant_decode_args)]
# argument order: q, k8, ks, v8, vs, tables, positions[, seq_idx]
QUANT_BAD_INPUTS = [
    ("fp16 q", lambda a: _bad(a, 0, lambda x: x.half()), TypeError),
    ("int16 cache", lambda a: _bad(a, 1, lambda x: x.short()), TypeError),
    ("fp32 scales", lambda a: _bad(a, 2, lambda x: x.float()), TypeError),
    ("scale shape", lambda a: _bad(a, 4, lambda x: x[:-1]), ValueError),
    ("k/v shapes", lambda a: _bad(a, 3, lambda x: x[:-1]), ValueError),
    ("head width", lambda a: _bad(_bad(a, 1, lambda x: x[..., :8]), 3,
                                  lambda x: x[..., :8]), ValueError),
    ("int64 table", lambda a: _bad(a, 5, lambda x: x.long()), TypeError),
    ("positions length", lambda a: _bad(a, 6, lambda x: x[:-1]), ValueError),
    ("devices", lambda a: _bad(a, 1, lambda x: x.to("meta")), ValueError),
]


@pytest.mark.parametrize("wrapper,make", QUANT_WRAPPERS,
                         ids=["span_quant", "decode_quant"])
@pytest.mark.parametrize("what,spoil,exc", QUANT_BAD_INPUTS,
                         ids=[b[0] for b in QUANT_BAD_INPUTS])
def test_quant_wrappers_reject_bad_inputs(wrapper, make, what, spoil, exc):
    with pytest.raises(exc):
        wrapper(*spoil(make()))


def _flash_args(dtype=torch.bfloat16):
    rng = np.random.default_rng(13)
    q, k, v = (torch.tensor(rng.standard_normal((2, 9, h, 16), np.float32))
               .to(dtype) for h in (4, 2, 2))
    return [q, k, v, torch.arange(9, dtype=torch.int32)]


FLASH_BAD_INPUTS = [
    ("q rank", lambda a: _bad(a, 0, lambda x: x[0]), ValueError),
    ("k/v shapes", lambda a: _bad(a, 2, lambda x: x[:, :-1]), ValueError),
    ("heads", lambda a: _bad(_bad(a, 1, lambda x: x[:, :, :1].repeat(
        1, 1, 3, 1)), 2, lambda x: x[:, :, :1].repeat(1, 1, 3, 1)),
     ValueError),
    ("int64 positions", lambda a: _bad(a, 3, lambda x: x.long()), ValueError),
    ("mixed dtypes", lambda a: _bad(a, 0, lambda x: x.float()), TypeError),
    ("fp16", lambda a: [x.half() if x.is_floating_point() else x for x in a],
     TypeError),
    ("devices", lambda a: _bad(a, 1, lambda x: x.to("meta")), ValueError),
]


@pytest.mark.parametrize("what,spoil,exc", FLASH_BAD_INPUTS,
                         ids=[b[0] for b in FLASH_BAD_INPUTS])
def test_flash_wrapper_rejects_bad_inputs(what, spoil, exc):
    with pytest.raises(exc):
        kfa.flash_attention(*spoil(_flash_args()))


def test_new_wrappers_count_no_cpu_launches():
    wrappers = (kfa.flash_attention, ksa.paged_span_attention_quant,
                kda.paged_decode_attention_quant)
    before = [w.launches for w in wrappers]
    kfa.flash_attention(*_flash_args())
    ksa.paged_span_attention_quant(*_quant_span_args())
    kda.paged_decode_attention_quant(*_quant_decode_args())
    assert [w.launches for w in wrappers] == before
