"""The port's MoE family with sliding-window attention against the
reference, on mixtral-8x7b-smoke (2 layers, d 64, 4 heads over 2 KV
heads, hd 16, 4 experts top-2, window W = 32) with the reference's
weights (``params_from_jax``), on the CPU:

* the MoE FFN (``moe_local``) against the reference's ``_moe_local``:
  both branches of the capacity rule, a case that drops tokens, and router
  logits tied on purpose;
* the pipeline stages' prefill, chunk and decode modes over the paged
  rolling cache (rows that wrap the window, bucket padding), logits,
  rolling caches and greedy tokens;
* the engines under every scheduling policy, in bf16 and fp32 and with
  the int8 cache, and the reference's own windowed pins mirrored on the
  port.

Tolerances as in tests/test_torch_model.py: logits 1e-4 in fp32 (the
same operations summed in other orders) and 0.1 in bf16 (the packages
round to bf16 at a few different places); greedy tokens must agree
wherever the reference's top-2 gap exceeds twice that.  In bf16 a
near-tie can flip a greedy token, and a flipped token changes what
follows, so there the engines' schedules are compared and the streams
only by length; in fp32 the streams must be equal token for token.
The int8 cache is compared in fp32 (tests/test_torch_engine.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.core import engine as ref_engine
from repro.core.engine import split_for_pp as ref_split_for_pp
from repro.core.sampling_params import SamplingParams as RefSamplingParams
from repro.models import ModelOptions as RefModelOptions
from repro.models import ShardCtx
from repro.models import build_model as ref_build_model
from repro.models.moe import _moe_local as ref_moe_local
from repro_torch.bridge import params_from_jax
from repro_torch.configs import MoEConfig, get_config
from repro_torch.core import engine
from repro_torch.core.engine import split_for_pp
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.models.moe import capacity, moe_local
from repro_torch.models.registry import ModelOptions, build_model
from repro_torch.models.stacked import tree_map
from test_torch_engine import _run

ARCH = "mixtral-8x7b-smoke"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
# the int8 cache in fp32: a value within noise of a rounding boundary
# quantizes one int8 step apart in the two packages
LOGIT_TOL_INT8 = {"float32": 1e-3, "bfloat16": 0.1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(ref_get_config(ARCH))
    ref_params = ref_model.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return (ref_model, ref_params), (build_model(get_config(ARCH)), params)


def _prompts(lens, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, vocab, size=n))) for n in lens]


def _top2_gap(logits):
    s = np.sort(logits, -1)
    return s[:, -1] - s[:, -2]


# ---------------------------------------------------------------------------
# The MoE FFN
# ---------------------------------------------------------------------------

def _moe_case(seed, t, d=32, ff=48, e=4, tie=False, skew=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d), np.float32) + 0.5
    router = rng.standard_normal((d, e), np.float32) * 0.5
    if tie:
        # every token: expert 0 first, then experts 1 and 2 tied for the
        # second place (equal columns), expert 3 last
        x = np.abs(x) + 0.1
        router[:, 2] = router[:, 1]
        router[:, 0] = router[:, 1] + 0.02
        router[:, 3] = router[:, 1] - 0.02
    router[:, 0] += skew     # route most tokens to expert 0
    return dict(x=x,
                router=router,
                w1=rng.standard_normal((e, d, ff), np.float32) / d ** 0.5,
                w3=rng.standard_normal((e, d, ff), np.float32) / d ** 0.5,
                w2=rng.standard_normal((e, ff, d), np.float32) / ff ** 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,cf,tie,skew", [
    (20, 2.0, False, 0.0),     # T < 64: capacity max(c, 4)
    (100, 1.25, False, 0.0),   # T >= 64: c rounded up to 8
    (40, 0.5, False, 1.0),     # capacity 10 of 20 tokens' pairs: drops
    (24, 2.0, True, 0.0),      # tied router logits: lower index first
])
def test_moe_local_matches_reference(dtype, t, cf, tie, skew):
    jdt, tdt = DTYPES[dtype]
    c = _moe_case(t + int(10 * cf), t, tie=tie, skew=skew)
    kw = dict(num_experts=4, top_k=2, capacity_factor=cf, expert_d_ff=48)
    ref_cfg, cfg = RefMoEConfig(**kw), MoEConfig(**kw)
    jp = {n: jnp.asarray(a, jdt) for n, a in c.items()}
    tp = {n: torch.tensor(a).to(tdt) for n, a in c.items()}
    want = np.asarray(ref_moe_local(jp["x"], jp, ref_cfg, axis_name=None,
                                    n_local=4), np.float32)
    got = moe_local(tp["x"], tp, cfg)
    assert got.dtype == tdt and got.shape == (t, 32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    from repro.models.moe import _capacity as ref_capacity
    assert capacity(t, cfg) == ref_capacity(t, ref_cfg)
    if skew:                 # some tokens lost both their experts
        dropped = np.abs(want).sum(-1) == 0
        assert dropped.any()
        assert not got.float().abs().sum(-1)[torch.tensor(~dropped)].eq(0).any()
    if tie:
        # the tie is real, and choosing the higher index would show
        logits = np.asarray(jp["x"] @ jp["router"], np.float32)
        assert np.array_equal(logits[:, 1], logits[:, 2])
        swapped = {**tp, "w1": tp["w1"][[0, 2, 1, 3]],
                   "w3": tp["w3"][[0, 2, 1, 3]], "w2": tp["w2"][[0, 2, 1, 3]]}
        assert (moe_local(tp["x"], swapped, cfg) - got).abs().max() > 10 * tol


# ---------------------------------------------------------------------------
# The model's stage functions over the paged rolling cache
# ---------------------------------------------------------------------------

def _cast(models, dtype, kv_quant=False):
    (ref_model, ref_params), (model, params) = models
    if kv_quant:
        ref_model = ref_build_model(ref_get_config(ARCH), ShardCtx.single(),
                                    RefModelOptions(kv_quant=True))
        model = build_model(get_config(ARCH), ModelOptions(kv_quant=True))
    jdt, tdt = DTYPES[dtype]
    return (ref_model, jax.tree.map(lambda a: a.astype(jdt), ref_params),
            model, tree_map(lambda t: t.to(tdt), params))


def _assert_cache_close(got, want, tol):
    """float K/V within ``tol``; an int8 cache dequantized, within ``tol``
    plus one quantization step."""
    assert got.keys() == want.keys()
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    if "ks" not in got:
        for kk in got:
            np.testing.assert_allclose(got[kk].float().numpy(), f(want[kk]),
                                       atol=tol, rtol=tol)
        return
    for kk in ("k", "v"):
        deq = (got[kk].float() * got[kk + "s"].float()[..., None]).numpy()
        step = f(want[kk + "s"])[..., None]
        excess = np.abs(deq - f(want[kk]) * step) - step
        assert excess.max() <= tol, (kk, excess.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_logits_and_rolling_cache_match_reference(models, dtype,
                                                          kv_quant):
    """A right-padded batch (37 > W, 9 and 20 < W) through both packages'
    stage ``prefill_fn`` over two stages: logits at each row's last real
    token, and each stage's rolling cache [groups, B, W, ...] filled by
    the real lengths."""
    ref_model, ref_params, model, params = _cast(models, dtype, kv_quant)
    tol = LOGIT_TOL[dtype]
    lens = (37, 9, 20)
    toks = np.zeros((3, 37), np.int32)
    for i, p in enumerate(_prompts(lens, seed=3)):
        toks[i, :len(p)] = p
    last = np.array(lens, np.int32) - 1
    x_ref, x = jnp.asarray(toks), torch.tensor(toks)
    for ref_stage, stage in zip(ref_split_for_pp(ref_model, ref_params, 2),
                                split_for_pp(model, params, 2)):
        x_ref, rcache = ref_stage.prefill_fn(ref_stage.params, x_ref, 0,
                                             jnp.asarray(last))
        x, cache = stage.prefill_fn(stage.params, x, 0, torch.tensor(last))
        assert tuple(cache["l0"]["k"].shape) == rcache["l0"]["k"].shape
        assert cache["l0"]["k"].shape[2] == 32          # W slots
        _assert_cache_close(cache["l0"], rcache["l0"], tol)
        x = x.detach().clone()
        x_ref = jnp.asarray(x.float().numpy()).astype(x_ref.dtype)
    ref_logits = np.asarray(x_ref, np.float32)
    np.testing.assert_allclose(x.numpy(), ref_logits, atol=tol, rtol=0)
    clear = _top2_gap(ref_logits) > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(np.argmax(x.numpy(), -1)[clear],
                                  np.argmax(ref_logits, -1)[clear])


BS, NB = 8, 4            # W / bs = 4 blocks per rolling table
N_BLOCKS = 2 * NB        # + the trash block


def _ref_cache(cfg, dtype, quant):
    shape = (cfg.num_layers, N_BLOCKS + 1, BS, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    if quant:
        return {"l0": {"k": jnp.zeros(shape, jnp.int8),
                       "v": jnp.zeros(shape, jnp.int8),
                       "ks": jnp.zeros(shape[:-1], jnp.bfloat16),
                       "vs": jnp.zeros(shape[:-1], jnp.bfloat16)}}
    return {"l0": {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_chunks_then_decode_over_the_rolling_cache(models, dtype, kv_quant):
    """Two packed chunk steps (row 0: 20 then 18 tokens, wrapping W = 32
    in the second; row 1: 6 then 4), each padded to a power-of-two bucket
    by duplicating its last token (n_valid < T), then ten greedy decode
    steps fed the reference's own tokens, so both caches hold the same
    contents throughout; the second chunk attends a cache that is partly
    its own window's history and partly stale."""
    ref_model, ref_params, model, params = _cast(models, dtype, kv_quant)
    jdt, tdt = DTYPES[dtype]
    tol = (LOGIT_TOL_INT8 if kv_quant else LOGIT_TOL)[dtype]
    cfg = model.cfg
    ref_stage = ref_split_for_pp(ref_model, ref_params, 1, paged=True)[0]
    stage = split_for_pp(model, params, 1)[0]
    rcache = _ref_cache(cfg, jdt, kv_quant)
    cache = model.paged_cache(cfg.num_layers, N_BLOCKS + 1, BS, device="cpu",
                              dtype=tdt)
    tables = np.array([[5, 2, 7, 0], [3, 6, 1, 4]], np.int32)
    rng = np.random.default_rng(1)
    i32 = lambda a: np.asarray(a, np.int32)
    steps = []
    for (n0, n1), starts in (((20, 6), (0, 0)), ((18, 4), (20, 6))):
        n = n0 + n1
        width = 1 << (n - 1).bit_length()
        toks = rng.integers(2, cfg.vocab_size, n)
        pos = np.concatenate([starts[0] + np.arange(n0),
                              starts[1] + np.arange(n1)])
        seq = np.repeat([0, 1], [n0, n1])
        toks, pos, seq = (i32(np.concatenate([a, np.repeat(a[-1:], width - n)]))
                          for a in (toks, pos, seq))
        last = i32([n0 - 1, n - 1])
        ref_logits, rcache = ref_stage.chunk_fn(
            ref_stage.params, rcache, *map(jnp.asarray, (
                toks, pos, seq, i32(starts), last)), jnp.int32(n),
            jnp.asarray(tables))
        t = lambda a: torch.tensor(a)
        logits = stage.chunk_fn(stage.params, cache, t(toks), t(pos), t(seq),
                                t(last), t(tables),
                                span_starts=t(i32(starts)), n_valid=n)
        steps.append((np.asarray(ref_logits), logits.numpy()))
    positions = i32([38, 10])
    for _ in range(10):                   # row 0 runs to 48 > W + 16
        nxt = i32(np.argmax(steps[-1][0], -1))
        ref_logits, rcache = ref_stage.decode_fn(
            ref_stage.params, rcache, jnp.asarray(nxt),
            jnp.asarray(positions), jnp.asarray(tables))
        logits, _ = model.decode(params, cache, {
            "token": torch.tensor(nxt), "positions": torch.tensor(positions),
            "block_tables": torch.tensor(tables)})
        steps.append((np.asarray(ref_logits), logits.numpy()))
        positions = positions + 1
    decided = 0
    for ref_l, port_l in steps:
        np.testing.assert_allclose(port_l, ref_l, atol=tol, rtol=0)
        clear = _top2_gap(ref_l) > 2 * tol
        decided += int(clear.sum())
        np.testing.assert_array_equal(np.argmax(port_l, -1)[clear],
                                      np.argmax(ref_l, -1)[clear])
    assert decided >= len(steps)
    _assert_cache_close({k: c[:, :N_BLOCKS] for k, c in cache["l0"].items()},
                        {k: c[:, :N_BLOCKS] for k, c in rcache["l0"].items()},
                        tol)


def test_padding_dropped_by_capacity_is_the_one_difference(models):
    """A chunk of 2 tokens padded to 8 at capacity factor 0.5 (4 slots an
    expert; the smoke config's 2.0 gives every token a slot): the 6 copies
    of token 1 route like it, so the first MoE layer drops some of them
    and their K/V differ in the second layer.  The reference writes every
    row and its CPU scatter keeps the last copy's K/V in token 1's slot;
    the port writes the real token's, which is what the reference writes
    for the unpadded chunk (ROADMAP §3c).  Every other slot and the logits
    agree (fp32, 1e-4)."""
    (_, ref_params), (_, params) = models
    drop = lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=0.5))
    ref_model = ref_build_model(drop(ref_get_config(ARCH)))
    model = build_model(drop(get_config(ARCH)))
    ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), ref_params)
    params = tree_map(lambda t: t.float(), params)
    cfg = model.cfg
    assert capacity(8, cfg.moe) == 4
    ref_stage = ref_split_for_pp(ref_model, ref_params, 1, paged=True)[0]
    stage = split_for_pp(model, params, 1)[0]
    tables = np.array([[5, 2, 7, 0]], np.int32)
    i32 = lambda a: np.asarray(a, np.int32)
    toks = i32(_prompts([2], seed=5)[0])

    def step(width, port):
        tk, pos = (i32(np.concatenate([a, np.repeat(a[-1:], width - 2)]))
                   for a in (toks, np.arange(2)))
        args = (tk, pos, i32([0] * width), i32([0]), i32([1]))
        if port:
            cache = model.paged_cache(cfg.num_layers, N_BLOCKS + 1, BS,
                                      device="cpu", dtype=torch.float32)
            t = torch.tensor
            out = stage.chunk_fn(stage.params, cache, *map(t, args[:3]),
                                 t(args[4]), t(tables),
                                 span_starts=t(args[3]), n_valid=2)
            return out.numpy(), {k: c.numpy() for k, c in cache["l0"].items()}
        out, cache = ref_stage.chunk_fn(
            ref_stage.params, _ref_cache(cfg, jnp.float32, False),
            *map(jnp.asarray, (*args[:3], args[3], args[4])), jnp.int32(2),
            jnp.asarray(tables))
        return np.asarray(out), {k: np.array(c)
                                 for k, c in cache["l0"].items()}
    (ref_out, ref_c), (out, c) = step(8, False), step(8, True)
    _, ref_unpadded = step(2, False)
    np.testing.assert_allclose(out, ref_out, atol=1e-4, rtol=0)
    slot = (1, 5, 1)                       # layer 1, block 5, offset 1
    for kk in ("k", "v"):
        assert np.abs(ref_c[kk][slot] - ref_unpadded[kk][slot]).max() > 1e-2
        np.testing.assert_allclose(c[kk][slot], ref_unpadded[kk][slot],
                                   atol=1e-4, rtol=0)
        ref_c[kk][slot] = ref_unpadded[kk][slot]
        np.testing.assert_allclose(c[kk][:, :N_BLOCKS],
                                   ref_c[kk][:, :N_BLOCKS], atol=1e-4, rtol=0)


def test_bridge_carries_the_moe_subtree(models):
    """Router [d, E] and experts [E, d, ff] / [E, ff, d] per layer group,
    bit for bit, in the port's layout (its own init's shapes)."""
    (_, ref_params), (model, params) = models
    leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    moe = [(p, a) for p, a in leaves if "moe" in jax.tree_util.keystr(p)]
    assert len(moe) == 4
    for path, leaf in moe:
        t = params
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf.astype(jnp.float32)))
    ffn = params["stacks"]["blocks"]["l0"]["ffn"]["moe"]
    assert tuple(ffn["router"].shape) == (2, 64, 4)
    assert tuple(ffn["w1"].shape) == (2, 4, 64, 128)
    assert tuple(ffn["w2"].shape) == (2, 4, 128, 64)
    own = model.init(1, device="cpu")
    assert tree_map(lambda x: tuple(x.shape), own) == \
        tree_map(lambda x: tuple(x.shape), params)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

LENS, N_NEW = [13, 5, 37, 9], 6      # 37 > W: the prefill wraps


def _both(models, engine_cls, dtype, policy, kv_quant=False):
    ref_model, ref_params, model, params = _cast(models, dtype, kv_quant)
    prompts = _prompts(LENS)
    kw = dict(n_new=N_NEW, policy=policy)
    ref = _run(ref_engine, engine_cls, RefSamplingParams, ref_model,
               ref_params, prompts, **kw)
    port = _run(engine, engine_cls, SamplingParams, model, params, prompts,
                **kw)
    for streams, trace, m in (ref, port):
        assert len(trace) > len(prompts)
        assert [len(s) for _, s in streams] == [N_NEW] * len(prompts)
        assert m["kv_blocks_free"] == m["kv_blocks_total"]
        assert m["kv_layout"] == "paged"
    if dtype == "float32":
        assert port[0] == ref[0]
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["monolithic", "chunked", "disaggregated",
                                    "adaptive"])
def test_naive_engine_matches_reference(models, dtype, policy):
    """Iteration for iteration the same members, spans, sampling points,
    block tables and CoW copies; in fp32 the same tokens."""
    (_, ref_trace, ref_m), (_, trace, m) = _both(models, "NaivePPEngine",
                                                 dtype, policy)
    assert trace == ref_trace
    for key in ("tokens", "requests_finished", "kv_preemptions",
                "kv_table_widths", "incremental_hits", "meta_rebuilds",
                "policy"):
        assert m[key] == ref_m[key], key


@pytest.mark.parametrize("policy", ["monolithic", "chunked"])
def test_int8_cache_engine_matches_reference(models, policy):
    (_, ref_trace, _), (_, trace, _) = _both(models, "NaivePPEngine",
                                             "float32", policy, True)
    assert trace == ref_trace


@pytest.mark.parametrize("policy", ["monolithic", "chunked"])
def test_sipipe_engine_matches_reference(models, policy):
    (_, ref_trace, _), (_, trace, _) = _both(models, "SiPipeEngine",
                                             "float32", policy)
    assert [t[:4] for t in trace] == [t[:4] for t in ref_trace]


def _serve(model, params, prompts, *, chunk, pp=2, max_batch=2, n_new=5,
           **kw):
    eng = engine.SiPipeEngine(model, params, engine.EngineConfig(
        pp_degree=pp, max_batch=max_batch, max_seq_len=64,
        prefill_chunk_tokens=chunk, **kw))
    for p in prompts:
        eng.add_request(p, SamplingParams(greedy=True, max_new_tokens=n_new))
    done = sorted(eng.run(), key=lambda s: s.seq_id)
    m = eng.metrics()
    assert m["kv_blocks_free"] == m["kv_blocks_total"]
    return [list(s.output_ids) for s in done]


@pytest.fixture(scope="module")
def pin_weights():
    """The reference pins' weights (``init(key(3))``, bf16)."""
    ref_params = ref_build_model(ref_get_config(ARCH)).init(jax.random.key(3))
    return params_from_jax(jax.tree.map(np.asarray, ref_params),
                           device="cpu")


def test_chunked_sliding_window_token_identical_to_monolithic(pin_weights):
    """The reference's pin (tests/test_chunked_prefill.py:162) on the
    port, with its weights and prompts: two-source rolling span attention
    reproduces monolithic prefill's greedy tokens."""
    model = build_model(get_config(ARCH))
    prompts = _prompts((13, 13), seed=3)
    mono = _serve(model, pin_weights, prompts, chunk=None)
    assert _serve(model, pin_weights, prompts, chunk=6) == mono


def test_ragged_windowed_monolithic_matches_per_seq_prefill(pin_weights):
    """The reference's pin (tests/test_chunked_prefill.py:195): a ragged
    batch (37 > W > 9) prefilled together equals each sequence prefilled
    alone, and the chunked path; pad-tail K/V never reaches a rolling
    slot."""
    model = build_model(get_config(ARCH))
    prompts = _prompts((37, 9), seed=3)
    ragged = _serve(model, pin_weights, prompts, chunk=None)
    per_seq = [_serve(model, pin_weights, [p], chunk=None, max_batch=1)[0]
               for p in prompts]
    assert ragged == per_seq
    assert _serve(model, pin_weights, prompts, chunk=6) == per_seq


def test_windowed_engine_configuration_is_checked(pin_weights):
    """The reference's pins on the windowed layout: a chunk budget wider
    than W raises (tests/test_chunked_prefill.py:218), as does an explicit
    paged layout whose block size does not divide W
    (tests/test_paged_engine.py:73); prefix caching is off and a sequence
    holds at most W / bs blocks."""
    model = build_model(get_config(ARCH))
    with pytest.raises(ValueError, match="window"):
        engine.SiPipeEngine(model, pin_weights, engine.EngineConfig(
            pp_degree=1, max_batch=2, max_seq_len=64,
            prefill_chunk_tokens=model.cfg.window + 1))
    with pytest.raises(ValueError, match="divide the sliding window"):
        engine.SiPipeEngine(model, pin_weights, engine.EngineConfig(
            kv_layout="paged", kv_block_size=7, max_seq_len=64))
    eng = engine.SiPipeEngine(model, pin_weights, engine.EngineConfig(
        pp_degree=2, max_batch=2, max_seq_len=64, kv_block_size=8))
    kv = eng.kv_manager
    assert kv.slot_cap == 32 and not kv.prefix_enabled
    assert kv.blocks_for(64) == 4 and kv.n_blocks == 2 * 2 * 4
    assert kv.table_widths[-1] == 4
    eng.shutdown()


def test_moe_every_other_layer_matches_reference():
    """``moe.every = 2`` (a dense layer, then an MoE layer, per group, as
    llama4 maverick alternates them): two layers per group in the
    parameters and the cache tree (``l0``, ``l1``); the engine's streams
    and trace equal the reference's in fp32, monolithic and chunked."""
    base = ref_get_config(ARCH)
    ref_cfg = dataclasses.replace(base, num_layers=4, moe=dataclasses.replace(
        base.moe, every=2))
    cfg = dataclasses.replace(get_config(ARCH), num_layers=4,
                              moe=dataclasses.replace(get_config(ARCH).moe,
                                                      every=2))
    ref_model = ref_build_model(ref_cfg)
    ref_params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              ref_model.init(jax.random.key(1)))
    params = tree_map(lambda t: t.float(), params_from_jax(
        jax.tree.map(np.asarray, ref_params), device="cpu"))
    model = build_model(cfg)
    assert set(params["stacks"]["blocks"]) == {"l0", "l1"}
    assert "moe" in params["stacks"]["blocks"]["l1"]["ffn"]
    assert "w1" in params["stacks"]["blocks"]["l0"]["ffn"]
    assert set(model.paged_cache(2, 3, 8, device="cpu")) == {"l0", "l1"}
    prompts = _prompts((13, 37, 9), seed=5)
    for policy in ("monolithic", "chunked"):
        ref = _run(ref_engine, "NaivePPEngine", RefSamplingParams, ref_model,
                   ref_params, prompts, n_new=4, policy=policy)
        port = _run(engine, "NaivePPEngine", SamplingParams, model, params,
                    prompts, n_new=4, policy=policy)
        assert port[0] == ref[0] and port[1] == ref[1]


def test_bucket_padding_writes_only_the_valid_tokens(models):
    """Bucket padding repeats the last valid token's slot; after an MoE
    layer the repeats can carry other hidden states (capacity drops them
    first).  Only the valid tokens are written: the slot holds the real
    token's K/V, the same as the unpadded span writes, whatever the
    padding rows hold (the reference writes every row, and its CPU
    scatter keeps the last padding row's: ROADMAP §3c)."""
    from repro_torch.models.transformer import self_attn_block
    _, (model, params) = models
    cfg = model.cfg
    p = tree_map(lambda w: w[0].float(),
                 params["stacks"]["blocks"]["l0"]["attn"])
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((8, cfg.d_model), np.float32))

    def cache_after(rows, n=8):
        ctx = model.make_ctx("chunk", i32([0, 1, 2, 3, 4, 4, 4, 4][:n]),
                             seq_idx=i32([0] * n), span_starts=i32([0]),
                             n_valid=5 if n > 5 else None,
                             block_tables=i32([[2, 0, 1, 3]]))
        c = model.paged_cache(1, 5, 8, device="cpu", dtype=torch.float32)
        xx = x.clone()
        for r, seed in rows.items():
            xx[r] = torch.tensor(np.random.default_rng(seed).standard_normal(
                cfg.d_model).astype(np.float32))
        self_attn_block(p, xx[:n], ctx,
                        {k: v[0] for k, v in c["l0"].items()}, cfg)
        return {k: v[0] for k, v in c["l0"].items()}
    base = cache_after({5: 1, 6: 2, 7: 3})
    for kk, val in cache_after({}, n=5).items():      # the unpadded span
        torch.testing.assert_close(base[kk], val, rtol=0, atol=0)
    for kk, val in cache_after({5: 4, 6: 5, 7: 6}).items():
        torch.testing.assert_close(base[kk], val, rtol=0, atol=0)
    assert not torch.equal(cache_after({4: 7})["k"][2, 4], base["k"][2, 4])
