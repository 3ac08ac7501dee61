"""The port's dense model against the reference on stablelm-1.6b-smoke:
the same weights (``params_from_jax``), the same paged cache contents and
the same inputs through both packages' pipeline-stage functions, in the
prefill, chunk and decode modes, with a bf16/fp32 or an int8 KV cache.

Tolerances on the logits (and the cache contents), by dtype:
  fp32  1e-4 — the algorithm: the same operations, summed in other orders.
  bf16  0.1  — both packages round to bf16 after each operation, but XLA
               fuses some of them (it keeps ``silu(h @ w1) * (h @ w3)`` and
               the logits' cast in fp32, for example) where PyTorch rounds
               each one; over four layers that moves logits of magnitude
               ~3 by up to 0.0625 on this input (mean 0.01).
Greedy tokens must agree wherever the reference's top-2 logit gap exceeds
twice the tolerance.  int8 caches are compared dequantized, within the
tolerance plus one quantization step (``_assert_cache_close``), and the
logits of steps that attend one within ``LOGIT_TOL_INT8``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import engine as ref_engine
from repro.core.engine import split_for_pp as ref_split_for_pp
from repro.models import ModelOptions as RefModelOptions
from repro.models import ShardCtx
from repro.models import build_model as ref_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core.engine import split_for_pp
from repro_torch.models.registry import ModelOptions, build_model
from repro_torch.models.stacked import tree_map

ARCH = "stablelm-1.6b-smoke"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
# chunk and decode over an int8 cache: in fp32 a K/V or probability value
# within noise of a rounding boundary quantizes one int8 step apart in the
# two packages, which moved the logits by up to 4.3e-4 on this input
LOGIT_TOL_INT8 = {"float32": 1e-3, "bfloat16": 0.1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BS, N_BLOCKS = 16, 12         # + the trash block


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(ref_get_config(ARCH))
    ref_params = ref_model.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, ref_params)
    model = build_model(get_config(ARCH))
    return ref_model, ref_params, model, params_from_jax(np_params, device="cpu")


def _with_options(models, kv_quant):
    """The fixture's models, rebuilt with the int8 KV cache if asked (the
    weights are the same)."""
    ref_model, ref_params, model, params = models
    if kv_quant:
        ref_model = ref_build_model(ref_get_config(ARCH), ShardCtx.single(),
                                    RefModelOptions(kv_quant=True))
        model = build_model(get_config(ARCH), ModelOptions(kv_quant=True))
    return ref_model, ref_params, model, params


def _cast(models, dtype):
    ref_model, ref_params, model, params = models
    jdt, tdt = DTYPES[dtype]
    return (ref_model, jax.tree.map(lambda a: a.astype(jdt), ref_params),
            model, tree_map(lambda t: t.to(tdt), params))


def _assert_cache_close(got, want, dtype, tol):
    """One cache, ``got`` (torch leaves) against ``want`` (jax leaves):
    float K/V within ``tol``.  An int8 cache is compared dequantized
    (``k * ks``): within ``tol`` plus one quantization step, since a value
    within noise of a rounding boundary quantizes one step apart in the
    two packages."""
    assert got.keys() == want.keys()
    np_ = lambda a: np.asarray(a.astype(jnp.float32))
    if "ks" not in got:
        for kk in got:
            np.testing.assert_allclose(got[kk].float().numpy(),
                                       np_(want[kk]), atol=tol, rtol=tol)
        return
    for kk in ("k", "v"):
        deq = (got[kk].float() * got[kk + "s"].float()[..., None]).numpy()
        step = np_(want[kk + "s"])[..., None]
        deq_ref = np_(want[kk]) * step
        excess = np.abs(deq - deq_ref) - step
        assert excess.max() <= tol, (kk, excess.max())


def test_config_copy_matches_reference():
    for arch in ("stablelm-1.6b", ARCH):
        assert get_config(arch).__dict__ == ref_get_config(arch).__dict__


def test_bridge_keeps_layout_and_bits(models):
    ref_model, ref_params, model, params = models
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    assert len(ref_leaves) == 12
    for path, leaf in ref_leaves:
        t = params
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(leaf.astype(jnp.float32)))


def test_port_init_follows_the_spec_shapes(models):
    _, ref_params, model, _ = models
    own = model.init(seed=1, device="cpu")
    ref_shapes = jax.tree.map(lambda a: a.shape, ref_params)

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
        else:
            assert tuple(a.shape) == b and a.dtype == torch.bfloat16
    walk(own, ref_shapes)
    assert bool((own["stacks"]["blocks"]["l0"]["attn"]["ln"] == 1).all())


@pytest.mark.parametrize("limit", [40, 5])
def test_init_draws_a_leaf_above_the_limit_slice_by_slice(monkeypatch, limit):
    """A leaf of more than ``_DRAW_LIMIT`` elements is drawn one leading
    slice at a time (limit 5: slices of slices), each from the generator's
    next state at the whole leaf's fan-in; a leaf within the limit is one
    draw.  Exact: the scale 1/sqrt(4) is a power of two."""
    from repro_torch.models import common
    shape = (3, 4, 8)
    gen = lambda: torch.Generator().manual_seed(0)
    draw = lambda: common.init_tensor(shape, "normal", gen(), device="cpu",
                                      dtype=torch.float32)
    g = gen()
    torch.testing.assert_close(draw(), torch.randn(shape, generator=g) / 2,
                               rtol=0, atol=0)
    monkeypatch.setattr(common, "_DRAW_LIMIT", limit)
    g = gen()
    piece = (4, 8) if limit >= 32 else (8,)
    want = torch.cat([torch.randn(piece, generator=g).reshape(-1)
                      for _ in range(96 // math.prod(piece))]) / 2
    torch.testing.assert_close(draw(), want.reshape(shape), rtol=0, atol=0)


def test_model_defaults_to_cuda_and_refuses_the_cpu_silently(
        models, monkeypatch):
    """``init`` and ``paged_cache`` run on ``cuda`` unless asked for the
    CPU, and raise without a card rather than carry on on the CPU."""
    _, _, model, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.paged_cache(1, 2, BS)
    assert model.paged_cache(1, 2, BS, device="cpu")["l0"]["k"].is_cpu


def _tables():
    """Two rows over shuffled blocks; entries past a prefix -> trash."""
    return np.array([[3, 7, 1, 12], [0, 9, 12, 12]], np.int32)


def _ref_cache(cfg, dtype, kv_quant=False):
    shape = (cfg.num_layers, N_BLOCKS + 1, BS, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    if kv_quant:
        return {"l0": {"k": jnp.zeros(shape, jnp.int8),
                       "v": jnp.zeros(shape, jnp.int8),
                       "ks": jnp.zeros(shape[:-1], jnp.bfloat16),
                       "vs": jnp.zeros(shape[:-1], jnp.bfloat16)}}
    return {"l0": {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}}


def _top2_gap(logits):
    s = np.sort(logits, -1)
    return s[:, -1] - s[:, -2]


def _chunk_then_decode(models, dtype, kv_quant):
    """One packed chunk step (row 0: 40 prompt tokens, row 1: 20), then
    eight greedy decode steps fed the reference's own tokens, so both
    caches hold the same contents throughout."""
    ref_model, ref_params, model, params = _cast(
        _with_options(models, kv_quant), dtype)
    jdt, tdt = DTYPES[dtype]
    tol = (LOGIT_TOL_INT8 if kv_quant else LOGIT_TOL)[dtype]
    cfg = model.cfg
    ref_stage = ref_split_for_pp(ref_model, ref_params, 1, paged=True)[0]
    stage = split_for_pp(model, params, 1)[0]
    rcache = _ref_cache(cfg, jdt, kv_quant)
    cache = model.paged_cache(cfg.num_layers, N_BLOCKS + 1, BS, device="cpu",
                             dtype=tdt)
    tables = _tables()
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, 60).astype(np.int32)
    pos = np.concatenate([np.arange(40), np.arange(20)]).astype(np.int32)
    seq = np.repeat([0, 1], [40, 20]).astype(np.int32)
    last = np.array([39, 59], np.int32)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))

    ref_logits, rcache = ref_stage.chunk_fn(
        ref_stage.params, rcache, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(seq), jnp.zeros(2, jnp.int32), jnp.asarray(last),
        jnp.int32(60), jnp.asarray(tables))
    logits = stage.chunk_fn(stage.params, cache, i32(toks), i32(pos),
                            i32(seq), i32(last), i32(tables))
    steps = [(np.asarray(ref_logits), logits.numpy())]
    positions = np.array([40, 20], np.int32)
    for _ in range(8):
        nxt = np.argmax(steps[-1][0], -1).astype(np.int32)
        ref_logits, rcache = ref_stage.decode_fn(
            ref_stage.params, rcache, jnp.asarray(nxt),
            jnp.asarray(positions), jnp.asarray(tables))
        logits, _ = model.decode(params, cache, {
            "token": i32(nxt), "positions": i32(positions),
            "block_tables": i32(tables)})
        steps.append((np.asarray(ref_logits), logits.numpy()))
        positions = positions + 1

    decided = 0
    for ref_l, port_l in steps:
        assert port_l.shape == ref_l.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(port_l, ref_l, atol=tol, rtol=0)
        clear = _top2_gap(ref_l) > 2 * tol
        decided += int(clear.sum())
        np.testing.assert_array_equal(np.argmax(port_l, -1)[clear],
                                      np.argmax(ref_l, -1)[clear])
    assert decided >= len(steps)       # the greedy check is not vacuous
    # the caches hold the same K/V in every written slot
    _assert_cache_close({k: c[:, :N_BLOCKS] for k, c in cache["l0"].items()},
                        {k: c[:, :N_BLOCKS] for k, c in rcache["l0"].items()},
                        dtype, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_then_decode_logits_and_greedy_tokens(models, dtype):
    _chunk_then_decode(models, dtype, kv_quant=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_cache_chunk_then_decode_logits_and_greedy_tokens(models,
                                                                dtype):
    """The int8 cache's chunk and decode modes (the int8 kernels' plain
    versions) against the reference's."""
    _chunk_then_decode(models, dtype, kv_quant=True)


def _ragged_prompts(cfg, lens=(23, 9, 16)):
    rng = np.random.default_rng(3)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(2, cfg.vocab_size, n)
    return toks, np.array(lens, np.int32) - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_logits_and_cache_match_reference(models, dtype, kv_quant):
    """A right-padded batch of three prompts through both packages' stage
    ``prefill_fn``, split over two stages: logits at each row's last real
    token, and the prompt K/V each stage returns (int8 with scales under
    ``kv_quant``)."""
    ref_model, ref_params, model, params = _cast(
        _with_options(models, kv_quant), dtype)
    tol = LOGIT_TOL[dtype]
    toks, last = _ragged_prompts(model.cfg)
    ref_stages = ref_split_for_pp(ref_model, ref_params, 2, paged=True)
    stages = split_for_pp(model, params, 2)
    x_ref, x = jnp.asarray(toks), torch.tensor(toks)
    for ref_stage, stage in zip(ref_stages, stages):
        x_ref, rcache = ref_stage.prefill_fn(ref_stage.params, x_ref, 0,
                                             jnp.asarray(last))
        x, cache = stage.prefill_fn(stage.params, x, 0, torch.tensor(last))
        for kk in cache["l0"]:
            assert tuple(cache["l0"][kk].shape) == rcache["l0"][kk].shape
        _assert_cache_close(cache["l0"], rcache["l0"], dtype, tol)
        # the next stage takes the same hidden states in both packages
        x = x.detach().clone()
        x_ref = jnp.asarray(x.float().numpy()).astype(x_ref.dtype)
    assert x.shape == (3, model.cfg.vocab_size)
    ref_logits = np.asarray(x_ref, np.float32)
    np.testing.assert_allclose(x.numpy(), ref_logits, atol=tol, rtol=0)
    clear = _top2_gap(ref_logits) > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(np.argmax(x.numpy(), -1)[clear],
                                  np.argmax(ref_logits, -1)[clear])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_model_prefill_matches_reference(models, kv_quant):
    """``Model.prefill`` (all layers, logits of the last column) and its
    returned cache, in fp32."""
    ref_model, ref_params, model, params = _cast(
        _with_options(models, kv_quant), "float32")
    toks, _ = _ragged_prompts(model.cfg, (12, 12))
    ref_logits, ref_cache = ref_model.prefill(ref_params,
                                              {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill(params, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGIT_TOL["float32"], rtol=0)
    rc = ref_cache["blocks"]["l0"]
    for kk, leaf in cache["blocks"]["l0"].items():
        assert tuple(leaf.shape) == rc[kk].shape
    _assert_cache_close(cache["blocks"]["l0"], rc, "float32",
                        LOGIT_TOL["float32"])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_run_prefill_writes_the_paged_cache_like_reference(models, kv_quant):
    """The prefill pass's block scatter (``_StageWorker.run_prefill``) in
    both engines, fp32, from the same stage input and a block table whose
    masked entries (a prefix-shared block, the ragged tail) point at the
    trash block: every physical block but the trash block ends equal, and
    the masked blocks keep their content."""
    ref_model, ref_params, model, params = _cast(
        _with_options(models, kv_quant), "float32")
    toks, last = _ragged_prompts(model.cfg, (23, 9))
    kw = dict(pp_degree=1, max_batch=2, max_seq_len=64, kv_block_size=8,
              kv_blocks=12, prefill_chunk_tokens=None)
    ref_eng = ref_engine.NaivePPEngine(ref_model, ref_params,
                                       ref_engine.EngineConfig(**kw))
    eng = engine.NaivePPEngine(model, params, engine.EngineConfig(**kw))
    trash = eng.kv_manager.pad_block
    assert trash == ref_eng.kv_manager.pad_block == 12
    # row 0: logical block 1 shared (masked); row 1: one block, then trash
    tables = np.array([[4, trash, 7], [2, trash, trash]], np.int32)
    ref_w, w = ref_eng.stages[0], eng.stages[0]
    ref_w.cache = jax.tree.map(
        lambda c: c.astype(jnp.float32) if c.dtype == jnp.bfloat16
        and c.ndim == 5 else c, ref_w.cache)
    ref_w.run_prefill(None, jnp.asarray(toks), 0, None, last, tables)
    w.run_prefill(torch.tensor(toks), 0, last, tables)
    _assert_cache_close({k: c[:, :trash] for k, c in w.cache["l0"].items()},
                        {k: c[:, :trash] for k, c in ref_w.cache["l0"].items()},
                        "float32", LOGIT_TOL["float32"])
    for leaf in w.cache["l0"].values():
        written = {4, 7, 2}
        for blk in range(trash):
            if blk not in written:
                assert not bool(leaf[:, blk].float().abs().sum()), blk
        assert bool(leaf[:, 4].float().abs().sum())
    ref_eng.shutdown()
    eng.shutdown()


def test_model_decode_equals_the_stage_decode(models):
    """``Model.decode`` (all layers) and the single pipeline stage's
    ``decode_fn`` compute the same thing, bit for bit."""
    _, _, model, params = models
    cfg = model.cfg
    stage = split_for_pp(model, params, 1)[0]
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))
    batch = {"token": i32([5, 9]), "positions": i32([3, 17]),
             "block_tables": i32(_tables())}
    c1 = model.paged_cache(cfg.num_layers, N_BLOCKS + 1, BS, device="cpu")
    c2 = model.paged_cache(cfg.num_layers, N_BLOCKS + 1, BS, device="cpu")
    a, _ = model.decode(params, c1, batch)
    b = stage.decode_fn(stage.params, c2, batch["token"],
                        batch["positions"], batch["block_tables"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c1["l0"]["k"], c2["l0"]["k"], rtol=0, atol=0)


def test_bridge_serves_the_int8_cache_model(models):
    """``kv_quant`` changes only the cache: the reference's int8-cache
    model has the same parameter tree, and the bridge's output fits the
    port's int8-cache model leaf for leaf."""
    ref_model, _, _, params = models
    ref_q = ref_build_model(ref_get_config(ARCH), ShardCtx.single(),
                            RefModelOptions(kv_quant=True))
    model_q = build_model(get_config(ARCH), ModelOptions(kv_quant=True))
    shapes = lambda m: jax.tree.map(lambda a: a.shape, m.abstract_params())
    assert shapes(ref_q) == shapes(ref_model)
    specs = tree_map(lambda sp: tuple(sp.shape), model_q.specs)
    got = tree_map(lambda t: tuple(t.shape), params)
    assert got == specs
    cache = model_q.paged_cache(2, 3, BS, device="cpu")
    assert {k: v.dtype for k, v in cache["l0"].items()} == {
        "k": torch.int8, "v": torch.int8, "ks": torch.bfloat16,
        "vs": torch.bfloat16}
    assert cache["l0"]["ks"].shape == cache["l0"]["k"].shape[:-1]


def test_unported_paths_raise(models):
    """What stays unported raises: the reference's other model options;
    a family the reference does not know raises as in the reference.
    (The audio family runs: tests/test_torch_whisper.py; the hybrid, ssm
    and vlm families: tests/test_torch_families.py.  The MoE family and windowed attention
    run: tests/test_torch_moe.py; a shared expert and its fused form
    (``fuse_shared_expert``) run: tests/test_torch_configs.py; the
    contiguous cache layout runs, checked here and in
    tests/test_torch_contiguous.py.)"""
    _, _, model, params = models
    cfg = get_config(ARCH)
    for opt in ("triangular", "seq_shard"):
        with pytest.raises(NotImplementedError, match=opt):
            build_model(cfg, ModelOptions(**{opt: True}))
    build_model(cfg, ModelOptions(fuse_shared_expert=True))
    with pytest.raises(NotImplementedError, match="remat"):
        build_model(cfg, ModelOptions(remat=False))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg.__class__(**{**cfg.__dict__, "family": "rnn"}))
    with pytest.raises(ValueError, match="MoEConfig"):
        build_model(cfg.__class__(**{**cfg.__dict__, "family": "moe"}))
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))
    cache = model.paged_cache(cfg.num_layers, N_BLOCKS + 1, BS, device="cpu")
    # a decode step over contiguous rows (no block table) writes the new
    # token's K/V into slot 3 of its row and leaves every other slot zero
    rows = model.row_cache(cfg.num_layers, 1, 8, device="cpu",
                           dtype=params["embed"].dtype)
    logits, _ = model.decode(params, rows, {"token": i32([5]),
                                            "positions": i32([3]),
                                            "block_tables": None})
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    k = rows["l0"]["k"]
    assert k[:, 0, 3].abs().sum() > 0
    assert k[:, 0, :3].abs().sum() == 0 and k[:, 0, 4:].abs().sum() == 0
    # a windowed model's chunk step needs its rows' span starts
    windowed = build_model(cfg.__class__(**{**cfg.__dict__, "window": 16}))
    stage = split_for_pp(windowed, params, 1)[0]
    with pytest.raises(ValueError, match="span_starts"):
        stage.chunk_fn(stage.params, cache, i32([5, 6]), i32([0, 1]),
                       i32([0, 0]), i32([1]), i32(_tables()[:1]))
