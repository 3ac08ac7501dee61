"""The fused products' wgmma body (csrc/gemm_wgmma.cuh, PERF.md kernel
table rows 4 and 5) runs only on the card; what decides its work runs in
Python and is held here, on the CPU:

(a) the plan (kernels/_gemm.py: token tile, column tile, split-K slices,
    workspace bytes) at every shape chip_smoke.py holds the kernels at and
    at T in {0, 1, 8, 16, 17, 64, 80, 256, 257}: the slices cover K's
    k-steps once, in order, none empty; the tiles cover T and the output
    columns; the workspace is what its parts make;
(b) the body's sum order, mirrored in fp32 torch: each slice's k-steps of
    64 summed in order, the slices' fp32 partials summed in slice order,
    then rounded, SwiGLU's gate applied to whole sums; its rounded output
    held against the plain versions within the card's limit
    (``_gemm.gemm_limit``, the one chip_smoke.py holds the kernels to), at
    stablelm-1.6b's MLP widths and at a sum over ff 14336 (mixtral's).
    Any order of the same terms lies well within the limit, so what can
    fail here is a term dropped or counted twice (the dropped-k-step
    control) and the plans of (a);
(c) every shape the wrappers took before the wgmma body still passes
    their checks and plans, T 0 and the ragged widths 96 / 160 included.

The plain versions themselves are held against the reference's Pallas
kernels in tests/test_torch_ops.py."""
import ast
import functools
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import _gemm
from repro_torch.kernels import rmsnorm_matmul as krm
from repro_torch.kernels import swiglu as ksw
from repro_torch.models.common import rmsnorm

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke_cases(name):
    """A tuple of (T, d, ff or F, what) from chip_smoke.py, read without
    importing it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == name for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{name} not in chip_smoke.py")


SWIGLU_CASES = _smoke_cases("SWIGLU_CASES")
RMSNORM_MM_CASES = _smoke_cases("RMSNORM_MM_CASES")
TOKENS = [0, 1, 8, 16, 17, 64, 80, 256, 257]
WIDTHS = sorted({(d, f) for _, d, f, _ in SWIGLU_CASES + RMSNORM_MM_CASES})


def _plans(kind, d, f):
    """Every plan of product ``kind`` over widths (d, f): at the smoke
    cases' T for these widths and at TOKENS."""
    cases = SWIGLU_CASES if kind.startswith("swiglu") else RMSNORM_MM_CASES
    ts = sorted({t for t, dd, ff, _ in cases if (dd, ff) == (d, f)}
                | set(TOKENS))
    if kind == "rmsnorm":
        return [_gemm.plan(t, d, f) for t in ts]
    return [_gemm.swiglu_plans(t, d, f)[kind == "swiglu-down"] for t in ts]


PRODUCTS = [(kind, d, f) for kind in ("swiglu-up", "swiglu-down", "rmsnorm")
            for d, f in WIDTHS]
IDS = [f"{kind}-d{d}-f{f}" for kind, d, f in PRODUCTS]


def test_plans_cover_every_shape_and_both_routes():
    assert len(SWIGLU_CASES) >= 11 and len(RMSNORM_MM_CASES) >= 11
    splits = {p.splits for kind, d, f in PRODUCTS for p in _plans(kind, d, f)
              if p.t > 0}
    assert splits == {1, 2}, "both routes, with and without a split"


@pytest.mark.parametrize("kind,d,f", PRODUCTS, ids=IDS)
def test_plan_slices_cover_k_once(kind, d, f):
    for p in _plans(kind, d, f):
        s = p.slices()
        assert len(s) == p.splits >= 1
        assert s[0][0] == 0 and s[-1][1] == p.nk == -(-p.k // _gemm.BK)
        for (_, a1), (b0, _) in zip(s, s[1:]):
            assert a1 == b0, "slices are contiguous, in order"
        assert all(b > a for a, b in s), "no slice is empty"
        assert all(b - a <= p.q for a, b in s)
        # every element of K lies in exactly one slice's k-steps
        owner = np.zeros(p.k, np.int64)
        for a, b in s:
            owner[a * _gemm.BK:min(b * _gemm.BK, p.k)] += 1
        assert (owner == 1).all(), p


@pytest.mark.parametrize("kind,d,f", PRODUCTS, ids=IDS)
def test_plan_tiles_and_route(kind, d, f):
    for p in _plans(kind, d, f):
        assert p.bn in (8, 16, 32, 64, 128) and p.bm in (64, 128)
        # the smallest token tile that holds T, up to BN_MAX
        assert p.bn >= min(max(p.t, 1), _gemm.BN_MAX)
        assert p.bn == 8 or p.bn // 2 < min(p.t, _gemm.BN_MAX)
        token_tiles, col_tiles = -(-p.t // p.bn), -(-p.n // p.bm)
        assert p.tiles == token_tiles * col_tiles
        assert token_tiles * p.bn >= p.t and col_tiles * p.bm >= p.n
        assert p.splits <= _gemm.MAX_SPLITS
        if p.splits > 1:
            assert p.tiles < _gemm.SMS
            assert p.splits * p.bn <= p.k // 12
            assert all(b - a >= _gemm.MIN_STEPS for a, b in p.slices()[:-1])
        if kind == "swiglu-up":
            assert p.nb == 2 and p.splits == 1 and p.bm == 128
        if kind == "swiglu-down":
            assert p.nb == 1 and p.bm == 64


@pytest.mark.parametrize("kind,d,f", PRODUCTS, ids=IDS)
def test_workspace_matches_the_slices(kind, d, f):
    def up(n):
        return -(-n // 256) * 256
    for p in _plans(kind, d, f):
        nslices = len(p.slices())
        # a block's accumulators, each slice's: bn / 2 a thread, 128
        # threads for each 64 columns, for each weight
        block = (p.bn // 2) * (2 * p.bm) * p.nb
        partials = p.tiles * nslices * block if nslices > 1 else 0
        assert p.partial_floats() == partials
        for inv_rows in (0, p.t):
            got = _gemm.workspace_bytes(p, inv_rows=inv_rows)
            assert got == up(4 * p.tiles) + up(4 * inv_rows) \
                + up(4 * partials)
            assert got % 256 == 0


# ---------------------------------------------------------------------------
# (b) the body's sum order
# ---------------------------------------------------------------------------

def _split_sum(lhs, rhs, p, skip=None):
    """lhs @ rhs as the body sums it: for each slice its k-steps of BK in
    order into fp32, then the slices' partials in slice order (k-step
    ``skip`` left out: a negative control)."""
    total = None
    for a, b in p.slices():
        part = torch.zeros(lhs.shape[0], rhs.shape[1])
        for k in range(a, b):
            if k != skip:
                ks = slice(k * _gemm.BK, (k + 1) * _gemm.BK)
                part += lhs[:, ks].float() @ rhs[ks].float()
        total = part if total is None else total + part
    return total


def _mirror_swiglu(x, w1, w3, w2):
    t, d = x.shape
    up, down = _gemm.swiglu_plans(t, d, w1.shape[1])
    a, b = _split_sum(x, w1, up), _split_sum(x, w3, up)
    h = (F.silu(a) * b).to(x.dtype)  # the gate on whole sums, then rounded
    return h, _split_sum(h, w2, down).to(x.dtype), down


def _weights(rng, *shapes):
    return [torch.tensor(rng.standard_normal(s, np.float32) * s[0] ** -0.5)
            .bfloat16() for s in shapes]


@functools.cache
def _mlp(t, d, ff):
    """x [t, d] and the SwiGLU weights at the init's scale, from seed 16."""
    rng = np.random.default_rng(16)
    x = torch.tensor(rng.standard_normal((t, d), np.float32)).bfloat16()
    return (x, *_weights(rng, (d, ff), (d, ff), (ff, d)))


# (T, d, ff): stablelm-1.6b's MLP at the wide_swiglu fixture's T
# (tests/test_torch_ops.py) and at decode; a sum over mixtral's ff 14336
# at a narrow d
MIRROR_SWIGLU = [(16, 2048, 5632), (4, 2048, 5632), (4, 512, 14336)]


@pytest.mark.parametrize("t,d,ff", MIRROR_SWIGLU,
                         ids=[f"T{t}-d{d}-ff{f}" for t, d, f in MIRROR_SWIGLU])
def test_split_order_mirror_holds_swiglu_within_the_limit(t, d, ff):
    """The mirror's rounded output (its h from gate-up's mirror) within
    the limit, as chip_smoke.py holds the kernel.  (A rounded output one
    bf16 step from the plain version's, where their fp32 sums straddle a
    rounding boundary, alone takes 0.5-1 of the limit, whatever the
    order.)"""
    x, w1, w3, w2 = _mlp(t, d, ff)
    _, y, down = _mirror_swiglu(x, w1, w3, w2)
    assert down.splits == 2, "the mirror takes the split route"
    h = ksw.swiglu_hidden(x, w1, w3)
    plain = (h.float() @ w2.float()).to(h.dtype)  # swiglu_plain's output
    _, held = _gemm.gemm_excess(y, plain, h, w2)
    assert held <= 1, held


MIRROR_RMSNORM = [(16, 2048, 5632), (64, 2048, 5632)]


@pytest.mark.parametrize("t,d,f", MIRROR_RMSNORM,
                         ids=[f"T{t}-d{d}-F{f}" for t, d, f in MIRROR_RMSNORM])
def test_split_order_mirror_holds_rmsnorm_matmul_within_the_limit(t, d, f):
    """As for SwiGLU: the rounded output within the limit (hn, the
    normaliser's, is the plain version's: the same two roundings)."""
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.standard_normal((t, d), np.float32)).bfloat16()
    wn = torch.tensor(1.0 + 0.1 * rng.standard_normal(d, np.float32)) \
        .bfloat16()
    (wp,) = _weights(rng, (d, f))
    p = _gemm.plan(t, d, f)
    assert p.splits == 2
    hn = rmsnorm(x, wn)
    _, held = _gemm.gemm_excess(_split_sum(hn, wp, p).to(x.dtype),
                                krm.rmsnorm_matmul_plain(x, wn, wp), hn, wp)
    assert held <= 1, held


def test_split_order_mirror_fails_a_dropped_k_step():
    """A negative control: the limit refuses the split sum with one k-step
    of 64 (the first slice's last) left out."""
    t, d, ff = 4, 2048, 5632
    x, w1, w3, w2 = _mlp(t, d, ff)
    h = ksw.swiglu_hidden(x, w1, w3)
    _, down = _gemm.swiglu_plans(t, d, ff)
    assert down.splits == 2
    y = _split_sum(h, w2, down, skip=down.slices()[0][1] - 1).to(x.dtype)
    _, ratio = _gemm.gemm_excess(y, ksw.swiglu_plain(x, w1, w3, w2), h, w2)
    assert ratio > 1, ratio


# ---------------------------------------------------------------------------
# (c) the shapes the wrappers take
# ---------------------------------------------------------------------------

SHAPES = [(t, d, f) for t in (0, 1, 5, 37) for d, f in ((96, 160), (160, 96),
                                                        (16, 16), (2048, 5632))]


@pytest.mark.parametrize("t,d,f", SHAPES,
                         ids=[f"T{t}-d{d}-f{f}" for t, d, f in SHAPES])
def test_every_accepted_shape_still_passes_checks_and_plans(t, d, f):
    x = torch.zeros((t, d), dtype=torch.bfloat16)
    w1 = torch.zeros((d, f), dtype=torch.bfloat16)
    w2 = torch.zeros((f, d), dtype=torch.bfloat16)
    wn = torch.ones(d, dtype=torch.bfloat16)
    _gemm.check("swiglu", x, {"w1": (w1, (d, f)), "w3": (w1, (d, f)),
                              "w2": (w2, (f, d))})
    _gemm.check("rmsnorm_matmul", x, {"w_norm": (wn, (d,)),
                                      "w_proj": (w1, (d, f))})
    plans = (*_gemm.swiglu_plans(t, d, f), _gemm.plan(t, d, f))
    for p in plans:
        assert p.q >= 1 and p.bn in (8, 16, 32, 64, 128)
        assert _gemm.workspace_bytes(p, inv_rows=t) >= 0
    assert ksw.swiglu(x, w1, w1, w2).shape == (t, d)
    assert krm.rmsnorm_matmul(x, wn, w1).shape == (t, f)
