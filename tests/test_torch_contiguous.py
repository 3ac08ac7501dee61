"""The port's contiguous KV layout against the reference on the same
inputs, on the CPU: the plain versions of the contiguous kernels (rows
9-12 of PERF.md's kernel table: packed span attention over cache rows,
bf16 and int8, full and rolling; the contiguous modes of both decode
kernels) against the reference's jnp oracles and its Pallas kernels in
interpret mode; the model's in-place row path against gathering the
batch's rows, running the reference's branch on them and scattering them
back; and the engine's layout resolution and refusals.

Cases: R = 5 cache rows read out of order (the batch's rows are not
0..B-1), GQA g = 2, hd 16; rolling rows of W = 8 and 16 slots that have
and have not wrapped, and bucket padding (n_valid < T); every slot a
token must not see holds random values.

Tolerances: fp32 1e-5 (the same operations, summed in other orders).
bf16: |port - reference| <= 2^-7 * |reference| + 2^-7 (one bf16 step of
an output of magnitude ~1, relative, plus the same absolute for outputs
near zero, where the frameworks' roundings of bf16 contractions differ
by a step).  The Pallas kernels contract in fp32 where the jnp oracles
and the port contract in the input dtype, and keep the int8 q and p
scales in fp32 where quantize_kv rounds them to bf16: against them 2e-2,
tests/test_torch_kernels.py's limit for the same comparison.  The
in-place row path is held bit for bit against gather -> branch ->
scatter."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.span_attention import (
    span_attention as pallas_span,
    span_attention_quant as pallas_span_quant,
    span_attention_rolling as pallas_rolling,
    span_attention_rolling_quant as pallas_rolling_quant)
from repro.models import attention as A
from repro.models import build_model as ref_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core.engine import split_for_pp
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import span_attention as ksa
from repro_torch.launch import serve
from repro_torch.models.registry import ModelOptions, build_model
from repro_torch.models.stacked import tree_map

TOL_FP32 = 1e-5
BF16_STEP = 2.0 ** -7
TOL_PALLAS = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(port, ref, dtype):
    got = port.float().numpy()
    want = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL_FP32, atol=TOL_FP32)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=BF16_STEP)


def _pallas_close(port, ref):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=TOL_PALLAS,
                               atol=TOL_PALLAS)


def _row_case(seed, spans, *, r=5, s=24, kv=2, g=2, hd=16, pad=0):
    """Tokens of rows ``spans = [(row, off, c), ...]`` of an [R, S, Kv,
    hd] cache: row ``row`` holds positions [0, off) and the packed span
    brings off..off+c-1 (``pad`` bucket-padding tokens repeat the last
    one).  Every cache slot, used or not, holds random values."""
    rng = np.random.default_rng(seed)
    seq = np.concatenate([np.full(c, row) for row, _, c in spans])
    pos = np.concatenate([off + np.arange(c) for _, off, c in spans])
    offs = np.concatenate([np.full(c, off) for _, off, c in spans])
    n_valid = len(seq)
    seq, pos, offs = (np.concatenate([a, np.repeat(a[-1:], pad)])
                      for a in (seq, pos, offs))
    t, h = len(seq), kv * g
    ks = rng.standard_normal((t, kv, hd), np.float32)
    vs = rng.standard_normal((t, kv, hd), np.float32)
    ks[n_valid:], vs[n_valid:] = ks[n_valid - 1], vs[n_valid - 1]
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(q=rng.standard_normal((t, h, hd), np.float32),
                k=rng.standard_normal((r, s, kv, hd), np.float32),
                v=rng.standard_normal((r, s, kv, hd), np.float32),
                k_span=ks, v_span=vs, pos=i32(pos), seq=i32(seq),
                offs=i32(offs), n_valid=n_valid)


def _quantize(case):
    """The case's K/V rows in the int8 form the engine stores (the
    reference's quantize_kv)."""
    c = dict(case)
    for n in ("k", "v"):
        x8, xs = A.quantize_kv(jnp.asarray(c[n]))
        c[n], c[n + "s"] = np.asarray(x8), np.asarray(xs, np.float32)
    return c


def _both(case, dtype):
    """(jax, torch) copies of a case: float arrays in ``dtype``, int8 as
    they are, the int8 scales in bf16."""
    jdt, tdt = DTYPES[dtype]
    j, t = {}, {}
    for n, a in case.items():
        if not isinstance(a, np.ndarray):
            j[n] = t[n] = a
        elif n in ("ks", "vs"):
            j[n], t[n] = jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()
        elif a.dtype == np.float32:
            j[n], t[n] = jnp.asarray(a, jdt), torch.tensor(a).to(tdt)
        else:
            j[n], t[n] = jnp.asarray(a), torch.tensor(a)
    return j, t


def _cache(c, quant):
    return (c["k"], c["ks"], c["v"], c["vs"]) if quant else (c["k"], c["v"])


# rows out of order; several tokens per row; a row with no earlier tokens;
# positions up to S - 1
FULL_SPANS = [(3, 5, 4), (0, 0, 3), (4, 17, 7), (1, 9, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kv_block", [8, 512])
def test_span_attention_matches_oracle_and_pallas(dtype, quant, kv_block):
    """Rows 9 and 10: ``span_attention`` / ``span_attention_quant``
    (token t over slots 0..positions[t] of cache row seq_idx[t]) against
    the jnp ``packed_span_attention{,_quant}`` and the Pallas
    ``span_attention{,_quant}``.  ``kv_block`` 8 (p-tiles of 8 of the
    24 slots) and 512 (halved to 24's divisor 8: the same tile), plus
    S = 24's tile of 512 -> 8 again; the int8 tile is part of the
    function, so each case passes the same tile to both sides."""
    c = _row_case(7, FULL_SPANS)
    if quant:
        c = _quantize(c)
    j, t = _both(c, dtype)
    args = lambda d: (d["q"], *_cache(d, quant), d["pos"], d["seq"])
    if quant:
        out = ksa.span_attention_quant(*args(t), kv_block=kv_block)
        oracle = A.packed_span_attention_quant(*args(j), kv_block=kv_block)
        pallas = pallas_span_quant(*args(j), kv_block=kv_block,
                                         interpret=True)
    else:
        out = ksa.span_attention(*args(t))
        oracle = A.packed_span_attention(*args(j), kv_block=kv_block)
        pallas = pallas_span(*args(j), kv_block=kv_block,
                                   interpret=True)
    assert out.shape == (len(c["pos"]), 4 * 16) and out.dtype == t["q"].dtype
    _close(out, oracle, dtype)
    _pallas_close(out, pallas)


def test_span_attention_reads_the_tokens_rows():
    """The row index is the token's cache row: the same span over rows
    permuted (and the cache permuted alike) gives the same output, and
    indexing by batch position instead would read other rows."""
    c = _row_case(8, FULL_SPANS)
    _, t = _both(c, "float32")
    out = ksa.span_attention(t["q"], t["k"], t["v"], t["pos"], t["seq"])
    perm = torch.tensor([2, 4, 0, 1, 3])
    inv = torch.argsort(perm)
    moved = ksa.span_attention(t["q"], t["k"][perm], t["v"][perm], t["pos"],
                               inv[t["seq"].long()].int())
    torch.testing.assert_close(moved, out, rtol=0, atol=0)
    wrong = ksa.span_attention(t["q"], t["k"], t["v"], t["pos"],
                               torch.sort(t["seq"]).values)
    assert not torch.allclose(wrong, out)


# (W, spans): wrapped rows beside rows that did not wrap; a span that
# straddles W; an empty row; rows out of order
ROLLING_CASES = [
    (8, [(2, 13, 3), (0, 2, 4)]),
    (8, [(4, 6, 5), (1, 0, 3)]),
    (16, [(3, 40, 6), (0, 70, 2), (2, 29, 5)]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window,spans", ROLLING_CASES)
@pytest.mark.parametrize("pad", [0, 3])
def test_span_attention_rolling_matches_oracle_and_pallas(dtype, quant,
                                                          window, spans,
                                                          pad):
    """Rows 11 and 12: two-source windowed span attention over rolling
    rows [R, W, Kv, hd] (old contents by each row's span start) plus the
    span's fresh K/V, before the scatter, against the jnp
    ``packed_span_attention_rolling{,_quant}`` and the Pallas
    ``span_attention_rolling{,_quant}``; with bucket padding the padded
    copies must not count."""
    c = _row_case(11 * window + pad, spans, s=window, pad=pad)
    if quant:
        c = _quantize(c)
    j, t = _both(c, dtype)

    def args(d):
        return (d["q"], *_cache(d, quant), d["k_span"], d["v_span"],
                d["pos"], d["seq"], d["offs"])

    fn = ksa.span_attention_rolling_quant if quant else \
        ksa.span_attention_rolling
    out = fn(*args(t), c["n_valid"], window=window)
    oracle_fn = A.packed_span_attention_rolling_quant if quant else \
        A.packed_span_attention_rolling
    oracle = oracle_fn(*args(j), c["n_valid"], window=window)
    pallas_fn = pallas_rolling_quant if quant else pallas_rolling
    pallas = pallas_fn(*args(j), jnp.asarray([c["n_valid"]], jnp.int32),
                       window=window, interpret=True)
    _close(out, oracle, dtype)
    _pallas_close(out, pallas)
    if pad:
        # the valid tokens' outputs do not depend on the padding
        nv = c["n_valid"]
        unpadded = fn(*(a[:nv] if torch.is_tensor(a) and a.shape[0] ==
                        len(c["pos"]) else a for a in args(t)), nv,
                      window=window)
        _close(out[:nv], unpadded.float().numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 8])
def test_contiguous_decode_matches_oracle_and_pallas(dtype, quant, window):
    """The contiguous decode modes: decode row b over cache row rows[b]
    (out of order), slots 0..positions[b] (rolling: the first
    min(positions[b] + 1, W)), against jnp ``decode_attention{,_quant}
    (rolling_window=W)`` on the gathered rows and, in bf16, the Pallas
    ``decode_attention`` with lengths = positions + 1 (rolling:
    min(positions + 1, W))."""
    rng = np.random.default_rng(40 + window + quant)
    s = window or 24
    rows = np.array([3, 0, 4], np.int32)
    pos = np.array([0, s - 1, 30 if window else 11], np.int32)
    c = dict(q=rng.standard_normal((3, 4, 16), np.float32),
             k=rng.standard_normal((5, s, 2, 16), np.float32),
             v=rng.standard_normal((5, s, 2, 16), np.float32),
             rows=rows, pos=pos)
    if quant:
        c = _quantize(c)
    j, t = _both(c, dtype)
    g = lambda a: a[j["rows"]]
    if quant:
        fn = (kda.contiguous_decode_attention_quant_rolling if window
              else kda.contiguous_decode_attention_quant)
        out = fn(t["q"], t["k"], t["ks"], t["v"], t["vs"], t["rows"],
                 t["pos"], **({"window": window} if window else {}))
        oracle = A.decode_attention_quant(j["q"], g(j["k"]), g(j["ks"]),
                                          g(j["v"]), g(j["vs"]), j["pos"],
                                          rolling_window=window)
    else:
        fn = (kda.contiguous_decode_attention_rolling if window
              else kda.contiguous_decode_attention)
        out = fn(t["q"], t["k"], t["v"], t["rows"], t["pos"],
                 **({"window": window} if window else {}))
        oracle = A.decode_attention(j["q"], g(j["k"]), g(j["v"]), j["pos"],
                                    rolling_window=window)
        lengths = np.minimum(pos + 1, window) if window else pos + 1
        pallas = pallas_decode(j["q"], g(j["k"]), g(j["v"]),
                               jnp.asarray(lengths, jnp.int32),
                               interpret=True)
        _pallas_close(out, pallas)
    assert out.shape == (3, 64) and out.dtype == t["q"].dtype
    _close(out, oracle, dtype)


def test_contiguous_wrappers_check_their_inputs():
    c = _row_case(3, FULL_SPANS)
    _, t = _both(c, "float32")
    with pytest.raises(TypeError, match="int32"):
        ksa.span_attention(t["q"], t["k"], t["v"], t["pos"],
                           t["seq"].long())
    with pytest.raises(ValueError, match=r"\[R, S, Kv, hd\]"):
        ksa.span_attention(t["q"], t["k"][0], t["v"][0], t["pos"], t["seq"])
    with pytest.raises(ValueError, match="rows"):
        kda.contiguous_decode_attention(t["q"][:3], t["k"], t["v"],
                                        t["seq"][:2], t["pos"][:3])
    with pytest.raises(ValueError, match="window"):
        kda.contiguous_decode_attention_rolling(
            t["q"][:2], t["k"], t["v"], t["seq"][:2], t["pos"][:2], window=0)
    q8 = _quantize(c)
    _, tq = _both(q8, "float32")
    with pytest.raises(TypeError, match="ks"):
        ksa.span_attention_quant(tq["q"], tq["k"], tq["ks"].float(), tq["v"],
                                 tq["vs"], tq["pos"], tq["seq"])


# ---------------------------------------------------------------------------
# The model: in-place rows against gather -> branch -> scatter
# ---------------------------------------------------------------------------

ROWS = [3, 0]            # the batch's cache rows, out of order, of R = 4


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ("stablelm-1.6b-smoke", "mixtral-8x7b-smoke"):
        ref = ref_build_model(ref_get_config(arch)).init(jax.random.key(1))
        out[arch] = params_from_jax(jax.tree.map(np.asarray, ref),
                                    device="cpu")
    return out


def _steps(stage, cache, rows, spans):
    """Two chunk steps then a decode step of the two batch rows; ``rows``
    the cache row of each (None: the cache holds exactly the batch's rows,
    in order).  Returns every step's output."""
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))
    toks = np.random.default_rng(5).integers(2, 200, 64)
    done, outs = [0, 0], []
    r = None if rows is None else i32(rows)
    for n0, n1, pad in spans:
        pos = np.concatenate([done[0] + np.arange(n0), done[1] + np.arange(n1)])
        seq = np.repeat([0, 1], [n0, n1])
        tok = toks[:n0 + n1]
        if pad:            # bucket padding repeats the last valid token
            pos, seq, tok = (np.concatenate([a, np.repeat(a[-1:], pad)])
                             for a in (pos, seq, tok))
        outs.append(stage.chunk_fn(
            stage.params, cache, i32(tok), i32(pos), i32(seq),
            i32([n0 - 1, n0 + n1 - 1]), span_starts=i32(done),
            n_valid=n0 + n1, rows=r))
        done = [done[0] + n0, done[1] + n1]
    outs.append(stage.decode_fn(stage.params, cache, i32([5, 7]), i32(done),
                                rows=r))
    return outs


@pytest.mark.parametrize("arch", ["stablelm-1.6b-smoke",
                                  "mixtral-8x7b-smoke"])
@pytest.mark.parametrize("quant", [False, True])
def test_in_place_rows_match_gather_branch_scatter(weights, arch, quant):
    """The engine's contiguous path reads and writes the batch's rows of
    the whole [R, S] cache in place; the reference gathers the rows, runs
    the stage and scatters them back (repro/core/engine.py:387-402).
    Both must give the same logits and the same cache, bit for bit, with
    the rows out of order; rows outside the batch stay as they were.
    mixtral's W = 32 rows wrap (36 tokens), the second chunk step is
    bucket-padded."""
    cfg = get_config(arch)
    model = build_model(cfg, ModelOptions(kv_quant=quant))
    stage = split_for_pp(model, weights[arch], 1)[0]
    spans = [(20, 12, 0), (16, 9, 3)]
    full = model.row_cache(cfg.num_layers, 4, 48, device="cpu",
                           dtype=weights[arch]["embed"].dtype)
    gen = torch.Generator().manual_seed(0)
    for layer in full.values():      # rows outside the batch hold data
        for leaf in layer.values():
            leaf.copy_((torch.randn(leaf.shape, generator=gen) * 3).to(
                leaf.dtype))
    before = tree_map(lambda c: c.clone(), full)
    gathered = tree_map(lambda c: c[:, ROWS].clone(), full)
    got = _steps(stage, full, ROWS, spans)
    want = _steps(stage, gathered, None, spans)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    scattered = tree_map(lambda c: c.clone(), before)
    for lk, layer in gathered.items():
        for kk, leaf in layer.items():
            scattered[lk][kk][:, ROWS] = leaf
    for lk, layer in full.items():
        for kk, leaf in layer.items():
            torch.testing.assert_close(leaf, scattered[lk][kk], rtol=0,
                                       atol=0)
            untouched = [1, 2]
            torch.testing.assert_close(leaf[:, untouched],
                                       before[lk][kk][:, untouched],
                                       rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The engine: layout resolution and the reference's refusals
# ---------------------------------------------------------------------------

def test_auto_resolves_to_contiguous_exactly_where_the_reference_does(
        weights):
    """``auto`` takes contiguous rows for a window that is not a block
    multiple (mixtral-8x7b-smoke, W = 32, block 12; repro/core/engine.py:
    472-481) and paged ones otherwise; the rows are exactly W wide."""
    params = weights["mixtral-8x7b-smoke"]
    model = build_model(get_config("mixtral-8x7b-smoke"))
    for bs, layout in ((12, "contiguous"), (8, "paged"), (16, "paged")):
        eng = engine.NaivePPEngine(model, params, engine.EngineConfig(
            pp_degree=2, max_batch=2, max_seq_len=64, kv_block_size=bs))
        assert eng.cfg.kv_layout == layout and eng.paged == (
            layout == "paged")
        if layout == "contiguous":
            assert eng.kv_manager is None
            assert eng.stages[0].cache["l0"]["k"].shape[1:3] == (4, 32)
        eng.shutdown()
    dense = build_model(get_config("stablelm-1.6b-smoke"))
    eng = engine.NaivePPEngine(dense, weights["stablelm-1.6b-smoke"],
                               engine.EngineConfig(kv_block_size=12))
    assert eng.cfg.kv_layout == "paged"
    eng.shutdown()


def test_contiguous_rows_refuse_what_needs_paged_blocks(weights):
    """The reference's ValueErrors for contiguous rows (repro/core/
    engine.py:522-530, 725-737): decode enlargement, parallel sampling
    and the offline tier need preemption or copy-on-write."""
    model = build_model(get_config("stablelm-1.6b-smoke"))
    params = weights["stablelm-1.6b-smoke"]
    with pytest.raises(ValueError, match="decode_enlarge_factor"):
        engine.SiPipeEngine(model, params, engine.EngineConfig(
            kv_layout="contiguous", prefill_chunk_tokens=8,
            scheduling_policy="disaggregated", decode_enlarge_factor=2))
    eng = engine.NaivePPEngine(model, params, engine.EngineConfig(
        kv_layout="contiguous", max_seq_len=32))
    with pytest.raises(ValueError, match="parallel sampling"):
        eng.add_request([3, 4, 5], SamplingParams(n=2, max_new_tokens=2))
    with pytest.raises(ValueError, match="offline"):
        eng.add_request([3, 4, 5], SamplingParams(tier="offline",
                                                  max_new_tokens=2))
    rid = eng.add_request([3, 4, 5], SamplingParams(greedy=True,
                                                    max_new_tokens=3))
    assert [len(s.output_ids) for s in eng.run()] == [3] and rid == 0
    m = eng.metrics()
    assert m["kv_layout"] == "contiguous"
    assert not any(k.startswith("kv_block") for k in m)
    eng.shutdown()


@pytest.mark.parametrize("argv,layout", [
    (["--arch", "stablelm-1.6b-smoke", "--kv-layout", "contiguous",
      "--chunk-tokens", "16"], "contiguous"),
    (["--arch", "stablelm-1.6b-smoke", "--kv-layout", "contiguous"],
     "contiguous"),
    # auto: W = 32 is no multiple of 12-slot blocks
    (["--arch", "mixtral-8x7b-smoke", "--block-size", "12",
      "--chunk-tokens", "16"], "contiguous"),
    (["--arch", "mixtral-8x7b-smoke", "--chunk-tokens", "16"], "paged"),
])
def test_serve_cli_takes_the_kv_layout(monkeypatch, capsys, argv, layout):
    """``launch/serve.py --kv-layout`` (the reference's serve.py:440) on
    the CPU: every request finishes, over the layout asked for or
    resolved."""
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu",
                                      "--requests", "3", "--max-batch", "2",
                                      "--max-new-tokens", "4", *argv])
    serve.main()
    out = capsys.readouterr().out
    m = json.loads(out[:out.index("\n  stage0")])
    assert m["kv_layout"] == layout and m["finished"] == 3
    assert ("kv_blocks_total" in m) == (layout == "paged")
