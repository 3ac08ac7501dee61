"""The port's engines over contiguous KV rows (``kv_layout="contiguous"``)
against the reference's engines over the same layout, on the CPU, with
the reference's weights (through ``params_from_jax``): stablelm-1.6b-smoke
under every policy, monolithic and span, in fp32 and bf16 and with the
int8 cache, and mixtral-8x7b-smoke (MoE, W = 32 rolling rows, prompts
longer than W); then the reference's paged == contiguous pins
(tests/test_paged_engine.py:92-131) on the port alone.

As in tests/test_torch_engine.py: both engines must make the same
scheduling decisions, iteration for iteration (members, spans, sampling
points); in fp32 (parameters, cache and hand-offs) greedy streams must be
equal token for token; in bf16 the two frameworks round differently, so a
near-tie can flip a greedy token, and there the schedules are compared and
the streams only by length.  The int8 cache is compared in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import engine as ref_engine
from repro.core.sampling_params import SamplingParams as RefSamplingParams
from repro.models import ModelOptions as RefModelOptions
from repro.models import ShardCtx
from repro.models import build_model as ref_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.models.registry import ModelOptions, build_model
from repro_torch.models.stacked import tree_map
from test_torch_engine import _prompts, _reference_in_fp32


def _models(arch, kv_quant=False, key=0):
    """The reference's model and weights (``init(key)``, bf16) and the
    port's model with the same weights."""
    ref_model = ref_build_model(ref_get_config(arch), ShardCtx.single(),
                                RefModelOptions(kv_quant=kv_quant))
    ref_params = ref_model.init(jax.random.key(key))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    model = build_model(get_config(arch), ModelOptions(kv_quant=kv_quant))
    return (ref_model, ref_params), (model, params)


@pytest.fixture(scope="module")
def stablelm():
    return _models("stablelm-1.6b-smoke")


def _run(pkg, engine_cls, sp_cls, model, params, prompts, *, n_new, policy,
         layout="contiguous", chunk=6):
    cfg = pkg.EngineConfig(
        pp_degree=2, max_batch=2, max_seq_len=64, n_samplers=2,
        prefill_chunk_tokens=None if policy == "monolithic" else chunk,
        scheduling_policy=policy, kv_layout=layout, kv_block_size=8)
    eng = getattr(pkg, engine_cls)(model, params, cfg)
    if pkg is ref_engine and params["embed"].dtype == jnp.float32:
        _reference_in_fp32(eng)
    trace = []
    schedule = eng.scheduler.schedule

    def record(it):
        s = schedule(it)
        if s is not None:
            assert s.block_tables is None or layout == "paged"
            trace.append((s.iteration, list(s.seq_ids), s.spans,
                          s.needs_sample))
        return s

    eng.scheduler.schedule = record
    for p in prompts:
        eng.add_request(p, sp_cls(greedy=True, max_new_tokens=n_new))
    done = sorted(eng.run(), key=lambda s: s.seq_id)
    m = eng.metrics()
    eng.shutdown()
    assert m["kv_layout"] == layout
    assert [len(s.output_ids) for s in done] == [n_new] * len(prompts)
    return [(s.seq_id, list(s.output_ids)) for s in done], trace, m


def _parity(models, engine_cls, dtype, policy, lens, n_new):
    (ref_model, ref_params), (model, params) = models
    ref_params = jax.tree.map(lambda a: a.astype(dtype), ref_params)
    params = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
    prompts = _prompts(lens)
    kw = dict(n_new=n_new, policy=policy)
    ref = _run(ref_engine, engine_cls, RefSamplingParams, ref_model,
               ref_params, prompts, **kw)
    port = _run(engine, engine_cls, SamplingParams, model, params, prompts,
                **kw)
    (ref_streams, ref_trace, ref_m), (streams, trace, m) = ref, port
    assert len(trace) > len(prompts)
    assert trace == ref_trace
    for key in ("tokens", "requests_finished", "incremental_hits",
                "meta_rebuilds", "policy"):
        assert m[key] == ref_m[key], key
    if dtype == "float32":
        assert streams == ref_streams
    return port


@pytest.mark.parametrize("dtype,policy,lens,n_new", [
    ("float32", "monolithic", [13, 5, 21, 9], 6),
    ("float32", "chunked", [13, 5, 21, 9], 6),
    ("bfloat16", "chunked", [13, 5, 21, 9], 6),
    ("float32", "disaggregated", [11, 7, 17], 5),
    ("float32", "adaptive", [11, 7, 17], 5),
])
def test_naive_engine_over_rows_matches_reference(stablelm, dtype, policy,
                                                  lens, n_new):
    _parity(stablelm, "NaivePPEngine", dtype, policy, lens, n_new)


def test_sipipe_engine_over_rows_matches_reference(stablelm):
    """The overlapped engine (TSEM executors, CPU sampling pool): the
    same members, spans and sampling points as the reference's, and the
    same fp32 tokens."""
    _parity(stablelm, "SiPipeEngine", "float32", "chunked", [13, 5, 21, 9],
            6)


@pytest.mark.parametrize("policy", ["monolithic", "chunked"])
def test_int8_rows_match_reference(policy):
    """The int8 cache over contiguous rows: the span steps' p-tile is
    S = 64's (kv_block 512 halved), as in the reference."""
    _parity(_models("stablelm-1.6b-smoke", kv_quant=True), "NaivePPEngine",
            "float32", policy, [11, 7, 17], 5)


@pytest.fixture(scope="module")
def mixtral():
    return _models("mixtral-8x7b-smoke")


@pytest.mark.parametrize("dtype,policy", [
    ("float32", "chunked"), ("float32", "monolithic"),
    ("float32", "disaggregated"), ("float32", "adaptive"),
    ("bfloat16", "chunked"),
])
def test_mixtral_rows_match_reference(mixtral, dtype, policy):
    """The windowed MoE model over rolling rows exactly W = 32 wide:
    a 37-token prompt wraps its row in the prefill, chunks wrap later."""
    _parity(mixtral, "NaivePPEngine", dtype, policy, [13, 5, 37, 9], 6)


def test_mixtral_int8_rows_match_reference():
    """Rolling int8 rows: the old rows' p-tile is W = 32's."""
    _parity(_models("mixtral-8x7b-smoke", kv_quant=True), "NaivePPEngine",
            "float32", "chunked", [13, 5, 37, 9], 6)


# ---------------------------------------------------------------------------
# The reference's pins, on the port: paged == contiguous, greedy tokens
# ---------------------------------------------------------------------------

def _pin_prompts(cfg, lens, seed=0):
    """tests/test_paged_engine.py's prompts."""
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, cfg.vocab_size, size=n)))
            for n in lens]


def _serve(model, params, prompts, n_new, *, policy, layout, chunk=6):
    return _run(engine, "SiPipeEngine", SamplingParams, model, params,
                prompts, n_new=n_new, policy=policy, layout=layout,
                chunk=chunk)[::2]


def test_paged_token_identical_fast_pin(stablelm):
    """tests/test_paged_engine.py:92-106 on the port: paged monolithic and
    paged chunked runs give the contiguous monolithic run's greedy tokens,
    and the paged pool is whole again at the end."""
    _, (model, params) = stablelm
    prompts = _pin_prompts(model.cfg, (13, 5))
    ref, _ = _serve(model, params, prompts, 5, policy="monolithic",
                    layout="contiguous")
    mono, m1 = _serve(model, params, prompts, 5, policy="monolithic",
                      layout="paged")
    chk, m2 = _serve(model, params, prompts, 5, policy="chunked",
                     layout="paged")
    assert mono == ref and chk == ref
    assert m1["kv_preemptions"] == 0
    for m in (m1, m2):
        assert m["kv_blocks_free"] == m["kv_blocks_total"]


@pytest.mark.parametrize("arch,kv_quant,key,lens", [
    ("stablelm-1.6b-smoke", False, 0, (13, 5, 9)),   # dense, full cache
    ("mixtral-8x7b-smoke", False, 3, (13, 13)),      # moe, sliding window
    ("stablelm-1.6b-smoke", True, 4, (11, 5)),       # int8 KV cache
])
def test_paged_parity_matrix(arch, kv_quant, key, lens):
    """tests/test_paged_engine.py:113-131 on the port, and its mirror:
    under every policy, the paged layout AND contiguous rows give the
    contiguous monolithic run's greedy tokens (the reference's weights
    and prompts)."""
    _, (model, params) = _models(arch, kv_quant, key)
    prompts = _pin_prompts(model.cfg, lens, seed=key)
    ref, _ = _serve(model, params, prompts, 4, policy="monolithic",
                    layout="contiguous")
    for policy in ("monolithic", "chunked", "disaggregated", "adaptive"):
        for layout in ("paged", "contiguous"):
            got, m = _serve(model, params, prompts, 4, policy=policy,
                            layout=layout)
            assert got == ref, (arch, policy, layout)
            if layout == "paged":
                assert m["kv_blocks_free"] == m["kv_blocks_total"]
