"""The port's paged attention (its kernels' plain PyTorch versions, which
the wrappers run for CPU tensors) against the reference's jnp oracles and
its interpret-mode Pallas kernels, on the same numpy inputs.

Tolerances: fp32 <= 1e-5 (the algorithm: the same running softmax with
sums taken in another order), bf16 <= 2e-2 (scores and probabilities are
rounded to bf16 at the same places, but the two frameworks round their
contractions differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.span_attention import paged_span_attention as pallas_span
from repro.models import attention as A
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import span_attention as ksa

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
    with pytest.raises(NotImplementedError):
        ksa.paged_span_attention(*_span_args(), window=8)
    with pytest.raises(NotImplementedError):
        kda.paged_decode_attention(*_decode_args(), rolling_window=8)
    before = (ksa.paged_span_attention.launches,
              kda.paged_decode_attention.launches)
    ksa.paged_span_attention(*_span_args())
    kda.paged_decode_attention(*_decode_args())
    assert (ksa.paged_span_attention.launches,
            kda.paged_decode_attention.launches) == before
