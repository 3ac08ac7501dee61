"""The port's dense model against the reference on stablelm-1.6b-smoke:
the same weights (``params_from_jax``), the same paged cache contents and
the same inputs through both packages' pipeline-stage functions.

Tolerances on the logits (and the cache contents), by dtype:
  fp32  1e-4 — the algorithm: the same operations, summed in other orders.
  bf16  0.1  — both packages round to bf16 after each operation, but XLA
               fuses some of them (it keeps ``silu(h @ w1) * (h @ w3)`` and
               the logits' cast in fp32, for example) where PyTorch rounds
               each one; over four layers that moves logits of magnitude
               ~3 by up to 0.0625 on this input (mean 0.01).
Greedy tokens must agree wherever the reference's top-2 logit gap exceeds
twice the tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.engine import split_for_pp as ref_split_for_pp
from repro.models import build_model as ref_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import split_for_pp
from repro_torch.models.registry import build_model
from repro_torch.models.stacked import tree_map

ARCH = "stablelm-1.6b-smoke"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
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


def _ref_cache(cfg, dtype):
    shape = (cfg.num_layers, N_BLOCKS + 1, BS, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"l0": {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}}


def _top2_gap(logits):
    s = np.sort(logits, -1)
    return s[:, -1] - s[:, -2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_then_decode_logits_and_greedy_tokens(models, dtype):
    """One packed chunk step (row 0: 40 prompt tokens, row 1: 20), then
    eight greedy decode steps fed the reference's own tokens, so both
    caches hold the same contents throughout."""
    ref_model, ref_params, model, params = models
    jdt, tdt = DTYPES[dtype]
    tol = LOGIT_TOL[dtype]
    ref_params = jax.tree.map(lambda a: a.astype(jdt), ref_params)
    params = tree_map(lambda t: t.to(tdt), params)
    cfg = model.cfg
    ref_stage = ref_split_for_pp(ref_model, ref_params, 1, paged=True)[0]
    stage = split_for_pp(model, params, 1)[0]
    rcache = _ref_cache(cfg, jdt)
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
    for kk in ("k", "v"):
        np.testing.assert_allclose(
            cache["l0"][kk][:, :N_BLOCKS].float().numpy(),
            np.asarray(rcache["l0"][kk][:, :N_BLOCKS], np.float32),
            atol=tol, rtol=tol)


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


def test_unported_paths_raise(models):
    _, _, model, params = models
    with pytest.raises(NotImplementedError):
        model.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(NotImplementedError):
        build_model(get_config(ARCH).__class__(
            **{**get_config(ARCH).__dict__, "family": "moe"}))
