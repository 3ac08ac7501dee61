"""The port's sliding-window attention (rolling caches: position p at
slot p % W) against the reference on the same inputs: the plain versions
of the rolling kernels (windowed prefill, rolling decode, two-source
rolling span attention, bf16 and int8) against the reference's jnp
oracles and paged natives, and against its Pallas rolling kernels in
interpret mode; the rolling-cache fills; and the wrappers' input checks.

Cases: W = 8 or 32, hd 16, GQA g = 2; rows that have wrapped and rows
that have not, positions straddling W, a table narrower than W / bs, and
bucket padding (n_valid < T).  Physical blocks are shuffled, and unused
blocks and the trash block hold random values that no mask may let
through.

Tolerances: fp32 1e-5 (the same operations, summed in other orders);
bf16 2e-2 (both packages round to bf16 after each operation, XLA in a
few other places).  The Pallas kernels keep the int8 q and p scales in
fp32 where ``quantize_kv`` (which the reference engine runs) rounds them
to bf16: 2e-2 there, tests/test_span_kernel.py's limit for the same
comparison."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.span_attention import (
    paged_span_attention_rolling as pallas_rolling,
    paged_span_attention_rolling_quant as pallas_rolling_quant)
from repro.models import attention as A
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import span_attention as ksa
from repro_torch.models import attention as P

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PALLAS = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _rolling_case(seed, window, spans, *, kv=2, g=2, hd=16, bs=4, nb=None,
                  pad=0):
    """Rows r = 0.. with ``spans[r] = (off, c)``: the row's rolling cache
    holds positions [0, off) and the packed span brings positions
    off..off+c-1; ``pad`` bucket-padding tokens duplicate the last one.
    Each row's table has min(ceil((off + c) / bs), W / bs) shuffled blocks,
    padded to ``nb`` (default: the widest row) with the trash block."""
    rng = np.random.default_rng(seed)
    cap = window // bs
    need = [min(-(-(o + c) // bs), cap) for o, c in spans]
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
    offs = np.array([spans[r][0] for r in seq])
    n_valid = len(seq)
    seq, pos, offs = (np.concatenate([a, np.repeat(a[-1:], pad)])
                      for a in (seq, pos, offs))
    t, h = len(seq), kv * g
    ks = rng.standard_normal((t, kv, hd), np.float32)
    vs = rng.standard_normal((t, kv, hd), np.float32)
    ks[n_valid:], vs[n_valid:] = ks[n_valid - 1], vs[n_valid - 1]
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(q=rng.standard_normal((t, h, hd), np.float32),
                k=rng.standard_normal((n_phys, bs, kv, hd), np.float32),
                v=rng.standard_normal((n_phys, bs, kv, hd), np.float32),
                k_span=ks, v_span=vs, tables=i32(tables), pos=i32(pos),
                seq=i32(seq), offs=i32(offs), n_valid=n_valid)


def _as(case, fn, dt):
    return {n: (fn(a, dt) if isinstance(a, np.ndarray) and
                a.dtype == np.float32 else
                (fn(a, None) if isinstance(a, np.ndarray) else a))
            for n, a in case.items()}


def _jax(case, dt):
    return _as(case, lambda a, d: jnp.asarray(a, d) if d else jnp.asarray(a),
               dt)


def _torch(case, dt):
    return _as(case, lambda a, d: torch.tensor(a).to(d) if d
               else torch.tensor(a), dt)


def _quantize(case):
    """The case's physical K/V cache in the int8 form the engine stores
    (the reference's quantize_kv)."""
    c = dict(case)
    for n in ("k", "v"):
        x8, xs = A.quantize_kv(jnp.asarray(c[n]))
        c[n], c[n + "s"] = np.asarray(x8), np.asarray(xs, np.float32)
    return c


def _qjax(c, jdt):
    j = _jax(c, jdt)
    j["ks"], j["vs"] = (jnp.asarray(c[n], jnp.bfloat16) for n in ("ks", "vs"))
    return j


def _qtorch(c, tdt):
    t = _torch(c, tdt)
    t["ks"], t["vs"] = (torch.tensor(c[n]).bfloat16() for n in ("ks", "vs"))
    return t


# (window, spans, nb): rows that wrapped (off + c > W) beside rows that
# did not; positions straddling W; a table narrower than W / bs (nb *
# bs < W, no row wrapped); several rows in one span
CASES = [
    (8, [(13, 3), (2, 4)], None),      # wrapped row, short row
    (8, [(6, 5), (0, 3)], None),       # a span straddling W; empty cache
    (32, [(3, 5), (9, 6)], 4),         # table 16 slots < W = 32
    (32, [(40, 6), (70, 2), (29, 5)], None),
]


def _span_args(t, quant=False):
    cache = (t["k"], t["ks"], t["v"], t["vs"]) if quant else (t["k"], t["v"])
    return (t["q"], *cache, t["k_span"], t["v_span"], t["tables"], t["pos"],
            t["seq"], t["offs"], t["n_valid"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,spans,nb", CASES)
@pytest.mark.parametrize("pad", [0, 3])
def test_rolling_span_plain_matches_oracles(dtype, window, spans, nb, pad):
    case = _rolling_case(len(spans) * window + pad, window, spans, nb=nb,
                         pad=pad)
    jdt, tdt = DTYPES[dtype]
    j, t = _jax(case, jdt), _torch(case, tdt)
    out = ksa.paged_span_attention_rolling(*_span_args(t), window=window)
    assert out.shape == (len(t["pos"]), t["q"].shape[1] * 16)
    assert out.dtype == tdt
    for kv_block in (4, 512):        # one page; the engine's tile
        native = A.paged_span_attention_rolling_native(
            *_span_args(j), window=window, kv_block=kv_block)
        oracle = A.paged_span_attention_rolling(
            *_span_args(j), window=window, kv_block=kv_block)
        _close(out, native, TOL[dtype])
        _close(out, oracle, TOL[dtype])
        # the port's gather-then-attend oracle computes the same numbers
        torch.testing.assert_close(
            P.paged_span_attention_rolling(*_span_args(t), window=window,
                                           kv_block=kv_block),
            ksa.paged_span_attention_rolling_plain(
                *_span_args(t), window=window, kv_block=kv_block),
            rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,spans,nb", CASES)
def test_rolling_span_quant_plain_matches_oracles(dtype, window, spans, nb):
    c = _quantize(_rolling_case(7 * window + len(spans), window, spans,
                                nb=nb, pad=2))
    jdt, tdt = DTYPES[dtype]
    j, t = _qjax(c, jdt), _qtorch(c, tdt)
    for kv_block in (4, 512):       # the p-quantization tile is the function's
        out = ksa.paged_span_attention_rolling_quant(
            *_span_args(t, True), window=window, kv_block=kv_block)
        native = A.paged_span_attention_rolling_quant_native(
            *_span_args(j, True), window=window, kv_block=kv_block)
        oracle = A.paged_span_attention_rolling_quant(
            *_span_args(j, True), window=window, kv_block=kv_block)
        _close(out, native, TOL[dtype])
        _close(out, oracle, TOL[dtype])
        torch.testing.assert_close(
            P.paged_span_attention_rolling_quant(
                *_span_args(t, True), window=window, kv_block=kv_block),
            out, rtol=TOL[dtype], atol=TOL[dtype])


def test_rolling_span_plain_matches_pallas_interpret():
    """The Pallas rolling kernels in interpret mode (full-window tables,
    wrapped and unwrapped rows, one-page tiles), as
    tests/test_span_kernel.py runs them."""
    w = 32
    case = _rolling_case(13, w, [(40, 3), (7, 3)], kv=2, g=2, hd=32, bs=8)
    j, t = _jax(case, jnp.bfloat16), _torch(case, torch.bfloat16)
    nv = jnp.asarray([case["n_valid"]], jnp.int32)
    ref = pallas_rolling(j["q"], j["k"], j["v"], j["k_span"], j["v_span"],
                         j["pos"], j["seq"], j["offs"], nv, j["tables"],
                         window=w, interpret=True)
    out = ksa.paged_span_attention_rolling(*_span_args(t), window=w)
    _close(out, ref, TOL_PALLAS)
    c = _quantize(_rolling_case(14, 16, [(20, 2), (5, 2)], kv=1, g=2,
                                hd=16, bs=8))
    j, t = _qjax(c, jnp.bfloat16), _qtorch(c, torch.bfloat16)
    ref = pallas_rolling_quant(
        j["q"], j["k"], j["ks"], j["v"], j["vs"], j["k_span"], j["v_span"],
        j["pos"], j["seq"], j["offs"], jnp.asarray([c["n_valid"]], jnp.int32),
        j["tables"], window=16, interpret=True)
    out = ksa.paged_span_attention_rolling_quant(*_span_args(t, True),
                                                 window=16, kv_block=8)
    _close(out, ref, TOL_PALLAS)


def _decode_case(seed, window, positions, *, kv=2, g=2, hd=16, bs=4):
    """One decode token per row at ``positions``; each row's table covers
    min(pos + 1, W) slots (blocks past it -> trash)."""
    spans = [(p, 1) for p in positions]
    c = _rolling_case(seed, window, spans, kv=kv, g=g, hd=hd, bs=bs)
    c["rows"] = np.arange(len(positions), dtype=np.int32)
    return c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,positions", [
    (8, [0, 5, 7, 8, 19]),           # shorter than, equal to, past W
    (32, [31, 32, 33, 100]),
])
def test_rolling_decode_plain_matches_oracles(dtype, window, positions):
    jdt, tdt = DTYPES[dtype]
    c = _decode_case(window + len(positions), window, positions)
    j, t = _jax(c, jdt), _torch(c, tdt)
    args = (t["q"], t["k"], t["v"], t["tables"], t["pos"])
    out = kda.paged_decode_attention_rolling(*args, window=window)
    gv = lambda a: A.gather_paged_cache(a, j["tables"])
    oracle = A.decode_attention(j["q"], gv(j["k"]), gv(j["v"]), j["pos"],
                                rolling_window=window)
    _close(out, oracle, TOL[dtype])

    q = _quantize(c)
    j, t = _qjax(q, jdt), _qtorch(q, tdt)
    out = kda.paged_decode_attention_quant_rolling(
        t["q"], t["k"], t["ks"], t["v"], t["vs"], t["tables"], t["pos"],
        window=window)
    oracle = A.decode_attention_quant(
        j["q"], gv(j["k"]), gv(j["ks"]), gv(j["v"]), gv(j["vs"]), j["pos"],
        rolling_window=window)
    _close(out, oracle, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,s,q_block", [(8, 21, 8), (32, 37, 16),
                                              (32, 64, 32)])
def test_windowed_prefill_plain_matches_local_attention(dtype, window, s,
                                                        q_block):
    """The flash kernel's plain version with a window is the reference's
    ``local_attention`` (bf16 scores and probabilities), at a ragged S and
    GQA g = 2."""
    rng = np.random.default_rng(window + s)
    jdt, tdt = DTYPES[dtype]
    q, k, v = (rng.standard_normal((2, s, h, 16), np.float32)
               for h in (4, 2, 2))
    out = kfa.flash_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                              torch.arange(s, dtype=torch.int32),
                              window=window, kv_block=q_block)
    ref = A.local_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            window=window, q_block=q_block)
    _close(out, ref, TOL[dtype])
    if dtype == "bfloat16":
        # bf16 scores: not the full-precision chunked softmax bit for bit
        chunked = P.chunked_attention(
            *(torch.tensor(a).bfloat16() for a in (q, k, v)), window=window,
            kv_block=q_block)
        assert not torch.equal(out, chunked)
    with pytest.raises(ValueError, match="position 0"):
        kfa.flash_attention_plain(
            *(torch.tensor(a) for a in (q, k, v)),
            torch.arange(1, s + 1, dtype=torch.int32), window=window)


def test_fill_rolling_cache_matches_reference():
    rng = np.random.default_rng(0)
    w, s = 8, 21
    k = rng.standard_normal((3, s, 2, 4), np.float32)
    lens = np.array([21, 5, 13], np.int32)
    for width in (s, 5):
        got = P.fill_rolling_cache(torch.tensor(k[:, :width]), w)
        want = A.fill_rolling_cache(jnp.asarray(k[:, :width]), w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = P.fill_rolling_cache_ragged(torch.tensor(k), w, torch.tensor(lens))
    want = A.fill_rolling_cache_ragged(jnp.asarray(k), w, jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a row shorter than the window keeps zeros past its length
    assert not got[1, 5:].any()


def _bad_rolling(what):
    t = _torch(_rolling_case(3, 8, [(9, 3), (2, 2)]), torch.bfloat16)
    args, kw = list(_span_args(t)), {"window": 8}
    if what == "window":
        kw["window"] = 0
    elif what == "span width":
        args[3] = args[3][..., :8]
    elif what == "span dtype":
        args[3] = args[3].float()
    elif what == "offsets dtype":
        args[8] = args[8].long()
    elif what == "n_valid":
        args[9] = len(t["pos"]) + 1
    return args, kw


@pytest.mark.parametrize("what,exc", [
    ("window", ValueError), ("span width", ValueError),
    ("span dtype", TypeError), ("offsets dtype", ValueError),
    ("n_valid", ValueError)])
def test_rolling_wrappers_reject_bad_inputs(what, exc):
    args, kw = _bad_rolling(what)
    with pytest.raises(exc):
        ksa.paged_span_attention_rolling(*args, **kw)


def test_rolling_wrappers_count_no_cpu_launches():
    wrappers = (ksa.paged_span_attention_rolling,
                ksa.paged_span_attention_rolling_quant,
                kda.paged_decode_attention_rolling,
                kda.paged_decode_attention_quant_rolling)
    before = [w.launches for w in wrappers]
    c = _rolling_case(4, 8, [(9, 3), (2, 2)])
    t, qt = _torch(c, torch.bfloat16), _qtorch(_quantize(c), torch.bfloat16)
    ksa.paged_span_attention_rolling(*_span_args(t), window=8)
    ksa.paged_span_attention_rolling_quant(*_span_args(qt, True), window=8)
    d = _decode_case(5, 8, [3, 12])
    t, qt = _torch(d, torch.bfloat16), _qtorch(_quantize(d), torch.bfloat16)
    kda.paged_decode_attention_rolling(t["q"], t["k"], t["v"], t["tables"],
                                       t["pos"], window=8)
    kda.paged_decode_attention_quant_rolling(
        qt["q"], qt["k"], qt["ks"], qt["v"], qt["vs"], qt["tables"],
        qt["pos"], window=8)
    assert [w.launches for w in wrappers] == before
