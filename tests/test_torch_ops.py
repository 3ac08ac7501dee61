"""The port's kernel entry point (``repro_torch.kernels.ops``) and its two
fused-product kernels' plain versions (``swiglu``, ``rmsnorm_matmul``),
which the wrappers run for CPU tensors, against the reference's
interpret-mode Pallas kernels, its jnp oracles and its ``repro.kernels.
ops`` adapters, on the same numpy inputs.

Tolerances, stated at each test:
  fp32  rtol 1e-5, atol 1e-6 * max|ref| — the algorithm: the same casts,
        sums in another order; an output that cancels to near zero keeps
        the order noise of its largest terms (observed 7.9e-6 at max|y|
        ~15), which no relative tolerance covers.
  bf16  2^-7 * max|ref| absolute against Pallas — one bf16 step of the
        largest output: the two frameworks round the same values, but an
        fp32 sum that lands near a rounding boundary of h or y rounds to
        the other side (observed <= 0.0156 at max|y| 18.6).
  bf16  rtol 5e-2, atol 0.03 * max|ref| against the oracles and the
        model's unfused path — tests/test_kernels.py's: the oracle (like
        the model) rounds ``x @ w1`` and ``x @ w3`` to bf16 before the
        gate, the Pallas kernel and the port keep them in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.rmsnorm_matmul import rmsnorm_matmul as pallas_rmsnorm_mm
from repro.kernels.swiglu import swiglu as pallas_swiglu
from repro.models import ShardCtx
from repro.models import build_model as ref_build_model
from repro.models.transformer import mlp_block as ref_mlp_block
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import _gemm, ops
from repro_torch.kernels import rmsnorm_matmul as krm
from repro_torch.kernels import swiglu as ksw
from repro_torch.models.common import rmsnorm
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import mlp_block

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_STEP = 2.0 ** -7


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as a jax and a torch tensor of ``dtype`` (the same
    rounded values)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _swiglu_inputs(seed, t, d, f, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((t, d), np.float32),
              rng.standard_normal((d, f), np.float32) * 0.1,
              rng.standard_normal((d, f), np.float32) * 0.1,
              rng.standard_normal((f, d), np.float32) * 0.1]
    pairs = [_pair(a, dtype) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _rmsnorm_inputs(seed, t, d, f, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((t, d), np.float32),
              np.abs(rng.standard_normal(d).astype(np.float32)) + 0.5,
              rng.standard_normal((d, f), np.float32) * 0.1]
    pairs = [_pair(a, dtype) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _assert_close(got, want, dtype):
    """fp32: rtol 1e-5 and 1e-6 of the largest output; bf16: one bf16 step
    of the largest output."""
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=BF16_STEP * float(np.abs(want).max()))


def _assert_oracle_close(got, want):
    """tests/test_kernels.py's oracle tolerance."""
    got, want = _np(got), _np(want)
    atol = 0.03 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=atol)


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------

SWIGLU_SHAPES = [(64, 128, 256), (32, 64, 96), (128, 256, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,f", SWIGLU_SHAPES)
def test_swiglu_plain_matches_pallas(t, d, f, dtype):
    (jx, j1, j3, j2), (x, w1, w3, w2) = _swiglu_inputs(4, t, d, f, dtype)
    want = pallas_swiglu(jx, j1, j3, j2, t_block=16, f_block=32,
                         interpret=True)
    got = ksw.swiglu_plain(x, w1, w3, w2)
    assert got.dtype == x.dtype and got.shape == (t, d)
    _assert_close(got.float(), want, dtype)
    torch.testing.assert_close(ksw.swiglu(x, w1, w3, w2), got, rtol=0, atol=0)


@pytest.mark.parametrize("t,d,f", SWIGLU_SHAPES)
def test_swiglu_plain_matches_oracle(t, d, f):
    """The oracle rounds the two products to bf16 before the gate
    (observed <= 0.125 at max|y| 21.9)."""
    (jx, j1, j3, j2), (x, w1, w3, w2) = _swiglu_inputs(4, t, d, f, "bfloat16")
    _assert_oracle_close(ksw.swiglu_plain(x, w1, w3, w2).float(),
                         ref.swiglu_ref(jx, j1, j3, j2))


def test_swiglu_plain_accumulates_many_f_blocks():
    """tests/test_kernels.py's fp32 case: 16 ff blocks of 32 in Pallas, one
    sum here (rtol 1e-5)."""
    t, d, f = 16, 32, 512
    x = np.full((t, d), 0.01, np.float32)
    ws = [np.full(s, v, np.float32) for s, v in
          (((d, f), 0.02), ((d, f), 0.03), ((f, d), 0.04))]
    j = [jnp.asarray(a) for a in (x, *ws)]
    got = _np(ksw.swiglu_plain(*[torch.tensor(a) for a in (x, *ws)]))
    np.testing.assert_allclose(
        got, _np(pallas_swiglu(*j, t_block=16, f_block=32, interpret=True)),
        rtol=1e-5)
    np.testing.assert_allclose(got, _np(ref.swiglu_ref(*j)), rtol=1e-5)


# ---------------------------------------------------------------------------
# RMSNorm + projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,f", [(64, 128, 256), (32, 256, 128)])
def test_rmsnorm_matmul_plain_matches_pallas_and_oracle(t, d, f, dtype):
    """Against Pallas (t_block 16, f_block 64) and the oracle, which round
    at the same places (observed <= 0.00195 and 0 in bf16)."""
    (jx, jn, jp), (x, wn, wp) = _rmsnorm_inputs(7, t, d, f, dtype)
    got = krm.rmsnorm_matmul_plain(x, wn, wp)
    assert got.dtype == x.dtype and got.shape == (t, f)
    want = pallas_rmsnorm_mm(jx, jn, jp, t_block=16, f_block=64,
                             interpret=True)
    _assert_close(got.float(), want, dtype)
    _assert_close(got.float(), ref.rmsnorm_matmul_ref(jx, jn, jp), dtype)
    torch.testing.assert_close(krm.rmsnorm_matmul(x, wn, wp), got, rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# The five adapters against the reference's repro.kernels.ops
# ---------------------------------------------------------------------------

# attention: fp32 within 1e-5 (the same online softmax, other sum orders);
# bf16 within 4e-2 (tests/test_torch_kernels.py's TOL_FLASH_REF: the two
# round their probabilities to bf16 at other points of the softmax)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 4e-2}


def _attn_close(got, want, dtype):
    np.testing.assert_allclose(_np(got.float()), _np(want),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12),
                                           (False, 0)],
                         ids=["causal", "window", "noncausal"])
def test_flash_attention_bshd_matches_reference(causal, window, dtype):
    rng = np.random.default_rng(11)
    b, s, h, kv, hd = 2, 32, 4, 2, 16
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.standard_normal((b, s, n, hd), np.float32), dtype)
        for n in (h, kv, kv))
    want = ref_ops.flash_attention_bshd(jq, jk, jv, causal=causal,
                                        window=window, q_block=16,
                                        kv_block=16)
    got = ops.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                   q_block=16, kv_block=16)
    assert got.shape == (b, s, h * hd)
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_cached_matches_reference(dtype):
    """Lengths from one slot to the whole row."""
    rng = np.random.default_rng(12)
    b, s, h, kv, hd = 4, 32, 4, 2, 16
    (jq, q), = [_pair(rng.standard_normal((b, h, hd), np.float32), dtype)]
    (jk, k), (jv, v) = (
        _pair(rng.standard_normal((b, s, kv, hd), np.float32), dtype)
        for _ in range(2))
    lengths = np.array([1, 7, 32, 17], np.int32)
    want = ref_ops.decode_attention_cached(jq, jk, jv, jnp.asarray(lengths),
                                           kv_block=16)
    got = ops.decode_attention_cached(q, k, v, torch.tensor(lengths),
                                      kv_block=16)
    assert got.shape == (b, h * hd)
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_attention_packed_matches_reference(dtype):
    """A packed chunk of 12 tokens over 3 rows, window 0."""
    rng = np.random.default_rng(13)
    r, s, h, kv, hd = 3, 32, 4, 2, 16
    seq_idx = np.array([0] * 5 + [1] * 3 + [2] * 4, np.int32)
    positions = np.array([0, 1, 2, 3, 4, 20, 21, 22, 28, 29, 30, 31],
                         np.int32)
    t = len(seq_idx)
    (jq, q), = [_pair(rng.standard_normal((t, h, hd), np.float32), dtype)]
    (jk, k), (jv, v) = (
        _pair(rng.standard_normal((r, s, kv, hd), np.float32), dtype)
        for _ in range(2))
    want = ref_ops.span_attention_packed(jq, jk, jv, jnp.asarray(positions),
                                         jnp.asarray(seq_idx), kv_block=16)
    got = ops.span_attention_packed(q, k, v, torch.tensor(positions),
                                    torch.tensor(seq_idx), kv_block=16)
    assert got.shape == (t, h * hd)
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_fused_matches_reference(dtype):
    """Leading dimensions [2, 8, d] through the adapters' flatten."""
    (jx, j1, j3, j2), (x, w1, w3, w2) = _swiglu_inputs(5, 16, 64, 96, dtype)
    jx, x = jx.reshape(2, 8, 64), x.reshape(2, 8, 64)
    want = ref_ops.swiglu_fused(jx, j1, j3, j2, t_block=16, f_block=32)
    got = ops.swiglu_fused(x, w1, w3, w2, t_block=16, f_block=32)
    assert got.shape == (2, 8, 64) and got.dtype == x.dtype
    _assert_close(got.float(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matmul_fused_matches_reference(dtype):
    (jx, jn, jp), (x, wn, wp) = _rmsnorm_inputs(6, 16, 64, 96, dtype)
    jx, x = jx.reshape(2, 8, 64), x.reshape(2, 8, 64)
    want = ref_ops.rmsnorm_matmul_fused(jx, jn, jp, t_block=16, f_block=32)
    got = ops.rmsnorm_matmul_fused(x, wn, wp, t_block=16, f_block=32)
    assert got.shape == (2, 8, 96) and got.dtype == x.dtype
    _assert_close(got.float(), want, dtype)


def test_adapters_refuse_what_is_not_ported():
    """A window over a full span cache (the Pallas kernel has one, no path
    uses it), a non-causal window, and decode lengths outside 1..S."""
    rng = np.random.default_rng(14)
    t = lambda *s: torch.tensor(rng.standard_normal(s, np.float32))
    q, k = t(3, 4, 16), t(2, 32, 2, 16)
    pos = torch.tensor([0, 1, 5], dtype=torch.int32)
    rows = torch.tensor([0, 0, 1], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.span_attention_packed(q, k, k, pos, rows, window=8)
    qb = t(1, 8, 4, 16)
    kb = t(1, 8, 2, 16)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_bshd(qb, kb, kb, causal=False, window=4)
    for lengths in ([0, 3], [3, 33]):
        with pytest.raises(ValueError, match="length"):
            ops.decode_attention_cached(t(2, 4, 16), k, k,
                                        torch.tensor(lengths))


# ---------------------------------------------------------------------------
# The fused ops on the model's weights
# ---------------------------------------------------------------------------

ARCH = "stablelm-1.6b-smoke"


@pytest.fixture(scope="module")
def smoke_weights():
    ref_model = ref_build_model(ref_get_config(ARCH))
    ref_params = ref_model.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_model, ref_params, params


def test_fused_ops_match_the_models_mlp_and_lm_head(smoke_weights):
    """Layer 0's ``x + swiglu_fused(rmsnorm(x, ln), ...)`` against the
    reference's (and the port's) unfused ``mlp_block``, and
    ``rmsnorm_matmul_fused(x, lnf, head)`` against ``lm_head``, on a
    decode batch [4, d] and a chunk [1, 16, d], at the oracle tolerance."""
    ref_model, ref_params, params = smoke_weights
    cfg = get_config(ARCH)
    ref_cfg = ref_get_config(ARCH)
    rp = {k: v[0] for k, v in ref_params["stacks"]["blocks"]["l0"]["ffn"]
          .items()}
    p = {k: v[0] for k, v in params["stacks"]["blocks"]["l0"]["ffn"].items()}
    model = build_model(cfg)
    rng = np.random.default_rng(15)
    for shape in ((4, cfg.d_model), (1, 16, cfg.d_model)):
        jx, x = _pair(rng.standard_normal(shape, np.float32), "bfloat16")
        fused = x + ops.swiglu_fused(rmsnorm(x, p["ln"], cfg.norm_eps),
                                     p["w1"], p["w3"], p["w2"])
        want = ref_mlp_block(rp, jx, ref_cfg, ShardCtx.single())
        _assert_oracle_close(fused.float(), want)
        _assert_oracle_close(fused.float(), mlp_block(p, x, cfg).float())
        logits = ops.rmsnorm_matmul_fused(x, params["lnf"], params["head"],
                                          eps=cfg.norm_eps).float()
        assert logits.shape == (*shape[:-1], cfg.vocab_size)
        _assert_oracle_close(logits, ref_model.lm_head(ref_params, jx))
        _assert_oracle_close(logits, model.lm_head(params, x))


# ---------------------------------------------------------------------------
# The wrappers' checks, and the card's limit
# ---------------------------------------------------------------------------

def _swiglu_args():
    return list(_swiglu_inputs(1, 5, 32, 48, "bfloat16")[1])


def _rmsnorm_args():
    return list(_rmsnorm_inputs(1, 5, 32, 48, "bfloat16")[1])


def _bad(args, i, fn):
    args = list(args)
    args[i] = fn(args[i])
    return args


GEMM_WRAPPERS = [(ksw.swiglu, _swiglu_args), (krm.rmsnorm_matmul,
                                              _rmsnorm_args)]
GEMM_BAD_INPUTS = [
    ("x rank", lambda a: _bad(a, 0, lambda x: x[None]), ValueError),
    ("weight rank", lambda a: _bad(a, 2, lambda w: w[None]), ValueError),
    ("width", lambda a: _bad(a, 1, lambda w: w[1:]), ValueError),
    ("dtypes differ", lambda a: _bad(a, 1, lambda w: w.float()), TypeError),
    ("dtype", lambda a: [t.half() for t in a], TypeError),
    ("devices", lambda a: _bad(a, 1, lambda w: w.to("meta")), ValueError),
]


@pytest.mark.parametrize("wrapper,make", GEMM_WRAPPERS,
                         ids=["swiglu", "rmsnorm_matmul"])
@pytest.mark.parametrize("what,spoil,exc", GEMM_BAD_INPUTS,
                         ids=[b[0] for b in GEMM_BAD_INPUTS])
def test_gemm_wrappers_reject_bad_inputs(wrapper, make, what, spoil, exc):
    with pytest.raises(exc):
        wrapper(*spoil(make()))


def test_gemm_wrappers_count_no_cpu_launches():
    wrappers = (ksw.swiglu, krm.rmsnorm_matmul)
    before = [w.launches for w in wrappers]
    ksw.swiglu(*_swiglu_args())
    krm.rmsnorm_matmul(*_rmsnorm_args())
    ops.swiglu_fused(*_swiglu_args())
    ops.rmsnorm_matmul_fused(*_rmsnorm_args())
    assert [w.launches for w in wrappers] == before


@pytest.fixture(scope="module")
def wide_swiglu():
    """stablelm-1.6b's MLP widths (d 2048, ff 5632) at T = 16, weights at
    the init's scale, and the plain version's h and output."""
    rng = np.random.default_rng(16)
    x = torch.tensor(rng.standard_normal((16, 2048), np.float32)).bfloat16()
    w1, w3, w2 = (
        torch.tensor(rng.standard_normal(s, np.float32) * s[0] ** -0.5)
        .bfloat16() for s in ((2048, 5632), (2048, 5632), (5632, 2048)))
    h = ksw.swiglu_hidden(x, w1, w3)
    return h, w2, ksw.swiglu_plain(x, w1, w3, w2)


@pytest.mark.parametrize("tile,within", [(64, True), (512, True),
                                         ("drop", False)])
def test_gemm_limit_takes_reordered_sums_and_fails_a_dropped_tile(
        wide_swiglu, tile, within):
    """The card's limit (``_gemm.gemm_limit``, which chip_smoke.py holds
    the kernels to) accepts the down projection summed over ff in tiles of
    64 or 512 and rounded, and rejects it with one 64-wide ff tile
    dropped (a negative control)."""
    h, w2, plain = wide_swiglu
    hf, wf = h.float(), w2.float()
    if tile == "drop":
        keep = torch.ones(hf.shape[1], dtype=torch.bool)
        keep[1024:1088] = False
        y = hf[:, keep] @ wf[keep]
    else:
        y = sum(hf[:, i:i + tile] @ wf[i:i + tile]
                for i in range(0, hf.shape[1], tile))
    _, ratio = _gemm.gemm_excess(y.to(plain.dtype), plain, h, w2)
    assert (ratio <= 1) == within, ratio
